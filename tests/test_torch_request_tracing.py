"""Request-plane SLO observability of the port (serving/scheduler.py
Ticket accounting, the engines' spans, restful_api.py's /metrics and
/trace/spans) against the reference's, on the CPU: a tiny LM with random
weights served through the port's GenerationAPI and the reference's
gives the same request-span names and tree shape and the same histogram
counts; turning spans off records no span and changes neither the
tokens nor the launch and dispatch counters, while the histograms still
count; a ticket is accounted exactly once."""
import importlib
import json
import urllib.error
import urllib.request

import jax  # noqa: F401 — both frameworks in one process, JAX on CPU
import numpy
import pytest

import veles_tpu as vt
from veles_tpu import nn as jnn
from veles_tpu_torch.config import root
from veles_tpu_torch.convert import params_from_jax, random_params
from veles_tpu_torch.nn.standard_workflow import build_forwards
from veles_tpu_torch.restful_api import GenerationAPI
from veles_tpu_torch.serving.scheduler import Ticket, shed_expired

PKGS = ("veles_tpu", "veles_tpu_torch")
COUNTERS = [importlib.import_module("%s.telemetry.counters" % p)
            for p in PKGS]
SPANS = [importlib.import_module("%s.telemetry.spans" % p) for p in PKGS]
FLIGHT = importlib.import_module("veles_tpu_torch.telemetry.recorder").flight

LAYERS = ([{"type": "embedding", "vocab_size": 32, "dim": 32}]
          + [{"type": "transformer_block", "n_heads": 4,
              "ffn_hidden": 64, "causal": True, "rope": True,
              "name": "blk%d" % i} for i in range(2)]
          + [{"type": "lm_head", "vocab_size": 32}])
ENGINE = dict(engine="continuous", max_slots=3, buckets=(8, 16),
              max_context=48, decode_block=1)
HISTS = ("veles_serving_queue_wait_seconds", "veles_serving_ttft_seconds",
         "veles_serving_tpot_seconds", "veles_serving_e2e_seconds")
REQUEST_SPANS = {"request", "request.queue", "request.prefill",
                 "request.decode", "serving.prefill"}
#: counters a served request moves; tracing must not change any of them
WORK = ("veles_serving_prefill_dispatches_total",
        "veles_serving_decode_dispatches_total",
        "veles_decode_dispatches_total", "veles_serving_tokens_total",
        "veles_flash_attention_launches_total")


def _post(url, payload, timeout=60.0):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read().decode()


@pytest.fixture(scope="module")
def apis():
    """(reference API, port API): the same random weights behind each
    package's GenerationAPI and continuous engine."""
    model = build_forwards(LAYERS, device="cpu")
    params_from_jax(model, random_params(model, seed=3))
    prev = vt.root.common.engine.compute_dtype
    vt.root.common.engine.compute_dtype = "float32"
    from conftest import import_model
    lm = import_model("char_lm")
    wf = jnn.StandardWorkflow(
        name="tracing-ref", layers=LAYERS,
        loader_unit=lm.SyntheticTokenLoader(
            None, seq_len=16, vocab=32, n_train=64, n_valid=64,
            minibatch_size=64, name="tokens"),
        loss_function="softmax_seq")
    wf.initialize(device=vt.XLADevice(mesh_axes={"data": 1}))
    tree = {layer.name: {k: getattr(layer, k).numpy()
                         for k in layer.param_shapes()}
            for layer in model if layer.param_shapes()}
    for f in wf.forwards:
        for k, arr in f.param_arrays().items():
            arr.map_invalidate()[...] = tree[f.name][k]
    ref = vt.GenerationAPI(wf, port=0, name="ref_tracing", **ENGINE)
    ref.initialize()
    port = GenerationAPI(model, port=0, device="cpu", name="port_tracing",
                         **ENGINE).initialize()
    yield ref, port
    ref.stop()
    port.stop()
    vt.root.common.engine.compute_dtype = prev


def _payloads():
    rng = numpy.random.RandomState(21)
    return [{"prompt": [int(t) for t in rng.randint(0, 32, n)],
             "n_new": k, **extra}
            for n, k, extra in ((5, 4, {}),
                                (11, 3, {"mode": "sample",
                                         "temperature": 0.8, "seed": 4}),
                                (7, 1, {"trace_id": "trace-x",
                                        "attempt": 2}))]


def _serve(api, i):
    """POST the requests one at a time; returns (answers, the spans of
    the window, the histogram count deltas)."""
    url = "http://127.0.0.1:%d/generate" % api.port
    hist = COUNTERS[i].histograms
    before = {h: hist.count(h) for h in HISTS}
    cursor = SPANS[i].recorder.cursor()
    answers = []
    for payload in _payloads():
        code, body = _post(url, payload)
        assert code == 200, body
        answers.append(body)
    recs, _ = SPANS[i].recorder.records_since(cursor)
    return answers, recs, {h: hist.count(h) - before[h] for h in HISTS}


def _by_request(answers, recs):
    """Per answered request: its tagged spans as (name, depth, has a
    parent), sorted."""
    return [sorted((r["name"], r["depth"], r["parent"] is not None)
                   for r in recs if r.get("request_id") == a["request_id"])
            for a in answers]


def test_served_requests_trace_alike(apis):
    got = []
    for i, api in enumerate(apis):
        answers, recs, hist = _serve(api, i)
        assert all(a["engine"] == "continuous" for a in answers)
        shapes = _by_request(answers, recs)
        for shape in shapes:
            assert {name for name, *_ in shape} == REQUEST_SPANS
        outcome = [r for r in recs if r["name"] == "request"]
        assert [r["outcome"] for r in outcome] == ["retired"] * 3
        assert outcome[-1]["trace_id"] == "trace-x"
        assert outcome[-1]["attempt"] == 2
        got.append((shapes, hist,
                    sorted({r["name"] for r in recs
                            if r["name"].startswith("serving.")})))
    assert got[0] == got[1]
    # one TPOT sample per multi-token request
    assert got[1][1] == {"veles_serving_queue_wait_seconds": 3,
                         "veles_serving_ttft_seconds": 3,
                         "veles_serving_tpot_seconds": 2,
                         "veles_serving_e2e_seconds": 3}


def test_trace_spans_endpoint_and_live_metrics(apis):
    _ref, port = apis
    base = "http://127.0.0.1:%d" % port.port
    cursor = SPANS[1].recorder.cursor()
    answers, _, _ = _serve(port, 1)
    lines = _get("%s/trace/spans?since=%d" % (base, cursor)).splitlines()
    header = json.loads(lines[0])
    assert header["kind"] == "spans.header"
    assert header["name"] == "serve.port_tracing"
    pulled = [json.loads(line) for line in lines[1:]]
    assert len(pulled) == header["spans"] > 0
    assert {r.get("request_id") for r in pulled} >= {
        a["request_id"] for a in answers}
    with pytest.raises(urllib.error.HTTPError):
        _get("%s/trace/spans?since=x" % base)
    page = _get(base + "/metrics")
    assert "# TYPE veles_serving_ttft_seconds histogram" in page
    for name in HISTS:
        assert "%s_count " % name in page
        assert "%s_p99 " % name in page
    assert "veles_trace_span_pulls_total" in page
    assert "veles_serving_slots 3" in page


def test_spans_off_records_nothing_and_changes_no_work(apis):
    _ref, port = apis
    counters = COUNTERS[1].counters
    url = "http://127.0.0.1:%d/generate" % port.port

    def run():
        cursor = SPANS[1].recorder.cursor()
        before = counters.snapshot()
        hist = COUNTERS[1].histograms.count("veles_serving_e2e_seconds")
        # one at a time: admission timing cannot reshuffle the work
        tokens = [_post(url, p)[1]["tokens"] for p in _payloads()]
        recs, _ = SPANS[1].recorder.records_since(cursor)
        return (tokens, {k: counters.get(k) - before.get(k, 0)
                         for k in WORK}, recs,
                COUNTERS[1].histograms.count("veles_serving_e2e_seconds")
                - hist)

    prev = root.common.trace.spans
    try:
        on = run()
        root.common.trace.spans = False
        off = run()
    finally:
        root.common.trace.spans = prev
    assert on[0] == off[0]
    assert on[1] == off[1] and on[1]["veles_serving_tokens_total"] == 8
    assert on[2] and off[2] == []
    assert on[3] == off[3] == 3


def test_requests_switch_keeps_engine_spans_and_histograms(apis):
    _ref, port = apis
    prev = root.common.trace.requests
    try:
        root.common.trace.requests = False
        answers, recs, hist = _serve(port, 1)
    finally:
        root.common.trace.requests = prev
    names = {r["name"] for r in recs}
    assert "serving.prefill" in names and "request" not in names
    assert hist["veles_serving_e2e_seconds"] == 3


def test_bad_trace_fields_answer_400(apis):
    _ref, port = apis
    url = "http://127.0.0.1:%d/generate" % port.port
    for extra in ({"attempt": 0}, {"attempt": True}, {"trace_id": ""},
                  {"trace_id": 5}):
        code, body = _post(url, dict(_payloads()[0], **extra))
        assert code == 400, (extra, body)


def test_ticket_accounted_exactly_once():
    hist = COUNTERS[1].histograms
    before = {h: hist.count(h) for h in HISTS}
    t = Ticket(mode="sample", trace_id="tr-1")
    t.mark_admitted()
    t.mark_prefill_done()
    t.mark_first_token()
    assert t.succeed({"tokens": [1, 2, 3]})
    assert not t.succeed({"tokens": [4]})
    assert not t.fail("late", code=500)
    assert t.outcome == "retired" and t.n_tokens == 3
    queued = Ticket(deadline=0.0)
    shed_expired([queued])
    shed_expired([queued])
    assert queued.outcome == "expired" and queued.code == 503
    delta = {h: hist.count(h) - before[h] for h in HISTS}
    assert delta == {"veles_serving_queue_wait_seconds": 2,
                     "veles_serving_ttft_seconds": 1,
                     "veles_serving_tpot_seconds": 1,
                     "veles_serving_e2e_seconds": 1}
    done = [r for r in FLIGHT.records("request")
            if r.get("phase") == "done"
            and r.get("request_id") in (t.request_id, queued.request_id)]
    assert sorted(r["outcome"] for r in done) == ["expired", "retired"]
    assert [r["trace_id"] for r in done
            if r["request_id"] == t.request_id] == ["tr-1"]

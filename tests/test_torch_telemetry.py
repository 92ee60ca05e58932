"""The port's telemetry plane (veles_tpu_torch/telemetry/) against the
reference's (veles_tpu/telemetry/) on the CPU:

- counters and histograms: the same ``inc``/``observe`` sequence over
  the names both packages describe gives the same /metrics page byte
  for byte (histograms, p50/p90/p99 gauges, caller gauges, the
  collision guard) and the same quantiles;
- spans: the same nested sequence gives the same names, parent
  structure and attributes; a JSONL written by either package is read
  by the other's ``read_jsonl``, ``tree`` and ``chrome_trace.export``;
  the switch turns every record off in both;
- the flight recorder: a dump of either package is read by the other's
  ``inspect``;
- cost: ``Cost`` arithmetic, ``mfu``, ``CostModel.report`` and the
  flash and fused-FC analytic costs equal; ``cost_of_fn`` counts a
  matmul's 2·M·N·K; ``TrainStep.cost_report`` of a tiny LM counts
  exactly the step's products;
- a tiny training run records the same ``workflow.run``, ``unit.run``
  and ``train_step.epoch_block`` spans in both packages.
"""
import importlib
import json
import threading

import jax  # noqa: F401 — both frameworks in one process, JAX on CPU
import numpy
import pytest
import torch

import veles_tpu as vt
from veles_tpu import nn as ref_nn
from veles_tpu import prng as ref_prng
from veles_tpu.config import root as ref_root
from veles_tpu.loader import FullBatchLoader as RefFullBatchLoader
from veles_tpu.ops import flash_attention as ref_fa
from veles_tpu.ops import fused_fc as ref_ff
from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.loader import FullBatchLoader
from veles_tpu_torch.models import char_lm
from veles_tpu_torch.nn.standard_workflow import StandardWorkflow
from veles_tpu_torch.ops import flash_attention as fa
from veles_tpu_torch.ops import fused_fc as ff

PKGS = ("veles_tpu", "veles_tpu_torch")


def _mods(name):
    """The module ``telemetry.<name>`` of the reference and of the port
    (imported by full path: the packages rebind some attributes)."""
    return tuple(importlib.import_module("%s.telemetry.%s" % (p, name))
                 for p in PKGS)


REF_C, PORT_C = _mods("counters")
REF_S, PORT_S = _mods("spans")
REF_R, PORT_R = _mods("recorder")
REF_T, PORT_T = _mods("chrome_trace")
REF_COST, PORT_COST = _mods("cost")


@pytest.fixture
def fresh(monkeypatch):
    """Fresh counter, histogram and span registries in both packages
    (the process-wide ones other tests read stay untouched)."""
    for mod in (REF_C, PORT_C):
        monkeypatch.setattr(mod, "counters", mod.CounterRegistry())
        monkeypatch.setattr(mod, "histograms", mod.HistogramRegistry())
    for mod, c in ((REF_S, REF_C), (PORT_S, PORT_C)):
        monkeypatch.setattr(mod, "counters", c.counters)
        monkeypatch.setattr(mod, "recorder", mod.SpanRecorder())
    yield


# -- counters, histograms, /metrics ------------------------------------------

def _drive(mod, seed=5):
    """One seeded sequence of increments and observations over the
    names both packages describe."""
    shared = sorted(set(REF_C.DESCRIPTIONS) & set(PORT_C.DESCRIPTIONS)
                    - {"veles_metrics_name_collisions_total"})
    rng = numpy.random.RandomState(seed)
    for _ in range(60):
        name = shared[rng.randint(len(shared))]
        mod.counters.inc(name, [1, 2, 0.25, 7][rng.randint(4)])
    mod.counters.inc("veles_serving_tokens_total", 3)
    for name, spec in sorted(REF_C.HISTOGRAMS.items()):
        bounds = spec["buckets"]
        values = list(rng.exponential(bounds[len(bounds) // 2], 40))
        values += [bounds[0], bounds[-1], bounds[-1] * 3, 0.0]
        for v in values:
            mod.observe(name, float(v))


def test_metrics_page_byte_equal(fresh):
    gauges = {"veles_generate_queue_depth": 3,
              "veles_serving_page_fragmentation": (0.125, "frag"),
              # shadows a rendered series: dropped and counted
              "veles_serving_ttft_seconds_p99": 1.0,
              "veles_serving_tokens_total": 9}
    pages = []
    for mod in (REF_C, PORT_C):
        _drive(mod)
        first = mod.metrics_text(dict(gauges))
        pages.append((first, mod.metrics_text(dict(gauges))))
    assert pages[0] == pages[1]
    assert "veles_serving_e2e_seconds_p50" in pages[1][0]
    assert "veles_metrics_name_collisions_total 2" in pages[1][1]
    assert PORT_C.HISTOGRAMS == REF_C.HISTOGRAMS
    assert PORT_C.QUANTILE_GAUGES == REF_C.QUANTILE_GAUGES


def test_histogram_quantiles_equal(fresh):
    for mod in (REF_C, PORT_C):
        _drive(mod, seed=11)
    for name in REF_C.HISTOGRAMS:
        assert PORT_C.histograms.count(name) == \
            REF_C.histograms.count(name) == 44
        for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
            assert PORT_C.histograms.quantile(name, q) == \
                REF_C.histograms.quantile(name, q)
    bounds = (0.1, 1.0, 10.0)
    for counts in ((0, 0, 0, 0), (3, 0, 1, 0), (0, 0, 0, 5), (1, 2, 3, 4)):
        for q in (0.25, 0.5, 0.99):
            assert PORT_C.histogram_quantile(bounds, counts, q) == \
                REF_C.histogram_quantile(bounds, counts, q)


def test_unregistered_histogram_refused():
    with pytest.raises(KeyError):
        PORT_C.HistogramRegistry().observe("veles_no_such_seconds", 1.0)


def test_inc_hook_sees_every_increment(monkeypatch):
    seen = []
    monkeypatch.setattr(PORT_C, "_inc_hooks", [])
    PORT_C.add_inc_hook(lambda *a: seen.append(a))
    PORT_C.add_inc_hook(lambda *a: 1 / 0)       # swallowed
    reg = PORT_C.CounterRegistry()
    reg.inc("veles_retries_total", 2)
    reg.inc("veles_retries_total")
    assert seen == [("veles_retries_total", 2, 2),
                    ("veles_retries_total", 1, 3)]


# -- spans ------------------------------------------------------------------

def _replay(spans):
    """One nested sequence of spans, a retrospective span, a decorated
    function and an exception that closes its span."""
    @spans.spanned("decorated", kind="fn")
    def fn():
        return 3

    with spans.span("outer", unit="loader"):
        with spans.span("inner", steps=2):
            fn()
        spans.emit("request", 100.0, 0.5, request_id="r-1",
                   outcome="retired")
    with pytest.raises(ValueError):
        with spans.span("failing"):
            raise ValueError("boom")


def _shape(records):
    """Names, parent structure (by position) and attributes."""
    pos = {r["sid"]: i for i, r in enumerate(records)}
    skip = ("name", "depth", "ts", "dur", "sid", "parent", "tid", "seq")
    return [(r["name"], pos.get(r["parent"]), r["depth"],
             {k: v for k, v in r.items() if k not in skip})
            for r in records]


def test_spans_replay_equal(fresh):
    got = []
    for mod in (REF_S, PORT_S):
        _replay(mod)
        got.append(_shape(mod.recorder.records()))
    assert got[0] == got[1]
    assert [n for n, *_ in got[1]] == ["decorated", "inner", "request",
                                       "outer", "failing"]
    assert got[1][-1][3] == {"error": True}


@pytest.mark.parametrize("writer,reader", [(0, 1), (1, 0)])
def test_span_jsonl_read_across(fresh, tmp_path, writer, reader):
    w_spans, r_spans = (REF_S, PORT_S)[writer], (REF_S, PORT_S)[reader]
    r_trace = (REF_T, PORT_T)[reader]
    _replay(w_spans)
    path = str(tmp_path / "run.jsonl")
    assert w_spans.recorder.to_jsonl(path) == 5
    recs = r_spans.read_jsonl(path)
    assert _shape(recs) == _shape(w_spans.recorder.records())
    roots = r_spans.tree(recs)
    assert sorted(r["name"] for r in roots) == ["failing", "outer",
                                                "request"]
    outer = [r for r in roots if r["name"] == "outer"][0]
    assert [c["name"] for c in outer["children"]] == ["inner"]
    assert [c["name"] for c in outer["children"][0]["children"]] == \
        ["decorated"]
    out = str(tmp_path / "trace.json")
    assert r_trace.export(path, out) == 5
    doc = json.load(open(out))
    assert r_trace.validate(doc) == [] == (REF_T, PORT_T)[writer].validate(
        doc)
    assert r_trace.export(path, out, request_id="r-1") == 1


def test_span_switch_off_records_nothing(fresh):
    prev = (root.common.trace.get("spans", True),
            ref_root.common.trace.get("spans", True))
    try:
        root.common.trace.spans = False
        ref_root.common.trace.spans = False
        for mod in (REF_S, PORT_S):
            _replay(mod)
            assert mod.recorder.records() == []
    finally:
        root.common.trace.spans, ref_root.common.trace.spans = prev


def test_span_sink_pull_and_counter_deltas(fresh, tmp_path):
    sink = str(tmp_path / "sink.jsonl")
    PORT_S.recorder.set_sink(sink)
    try:
        with PORT_S.span("unit.run", unit="x"):
            PORT_C.counters.inc("veles_fused_fc_launches_total")
    finally:
        PORT_S.recorder.set_sink(None)
    rec = PORT_S.read_jsonl(sink)[0]
    assert rec["counters"] == {"veles_fused_fc_launches_total": 1}
    lines = PORT_S.pull_payload(0, name="t").splitlines()
    header = json.loads(lines[0])
    assert header["kind"] == "spans.header" and header["spans"] == 1
    assert json.loads(lines[1])["name"] == "unit.run"
    assert PORT_S.pull_payload(header["cursor"]).count("\n") == 1


def test_chrome_trace_validator_equal():
    bad = {"traceEvents": [{"ph": "X", "name": "a", "ts": -1, "dur": 1},
                           {"ph": "Q", "name": "b", "ts": 0},
                           {"ph": "C", "name": "c", "ts": 0},
                           {"ph": "X", "ts": 0, "dur": -2, "pid": "p"},
                           "junk"]}
    for doc in (bad, [], {"traceEvents": 3}):
        assert PORT_T.validate(doc) == REF_T.validate(doc)
    assert len(PORT_T.validate(bad)) == 7


# -- flight recorder ----------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [(0, 1), (1, 0)])
def test_flight_dumps_read_across(tmp_path, writer, reader):
    w_mod, r_mod = (REF_R, PORT_R)[writer], (REF_R, PORT_R)[reader]
    flight = w_mod.FlightRecorder(capacity=8)
    for i in range(10):
        flight.note("request", request_id="r-%d" % (i % 3), phase="done",
                    t_i=i)
    flight.note("span", name="unit.run", dur=0.5)
    path = flight.dump("test reason", path=str(tmp_path / "bb.jsonl"))
    got = r_mod.inspect(path)
    assert got == (REF_R, PORT_R)[writer].inspect(path)
    assert got["reason"] == "test reason" and got["events"] == 8
    assert got["by_kind"] == {"request": 7, "span": 1}
    one = r_mod.inspect(path, request="r-1")
    assert one["events"] == 2 and one["events_total"] == 8
    header, events = r_mod.read_blackbox(path)
    assert header["events"] == 8 and events[-1]["name"] == "unit.run"


def test_flight_hooks_and_crash_dump(tmp_path):
    flight = PORT_R.flight
    before = len(flight.records("counter"))
    PORT_C.inc("veles_shed_requests_total")     # an alarm counter
    assert len(flight.records("counter")) == before + 1
    prev = root.common.telemetry.recorder.autodump
    try:
        root.common.telemetry.recorder.autodump = False
        assert flight.crash_dump("off") is None
    finally:
        root.common.telemetry.recorder.autodump = prev


# -- cost ---------------------------------------------------------------------

def test_cost_arithmetic_mfu_and_report_equal():
    out = []
    for mod in (REF_COST, PORT_COST):
        a = mod.Cost(2e12, 1e9, 5e6, source="analytic")
        b = mod.Cost(1e12, 3e9, 7e6, source="analytic")
        c = a + b.scaled(3)
        model = mod.CostModel(peak_flops=500e12)
        model.record("fwd", a, executions=4)
        model.record("bwd", b)
        model.record("bwd", b.scaled(2), executions=2)
        out.append((c.as_dict(), c.arithmetic_intensity,
                    c.mfu(2.0, peak_flops=400e12, n_chips=2),
                    (a + mod.Cost(source="xla")).source,
                    model.total().as_dict(), model.mfu("fwd", 0.5),
                    model.report({"fwd": 0.25})))
    assert out[0] == out[1]


@pytest.mark.parametrize("b,t,h,d", [(2, 64, 4, 16), (1, 128, 8, 64)])
def test_flash_analytic_cost_equal(b, t, h, d):
    """Non-causal, the two models are one: 4·D FLOPs a (query, key)
    pair, q/k/v read and o, lse written. Causal, the reference takes
    T/2 keys a query and the port the live pairs T(T+1)/2 exactly, so
    the port's FLOPs are the reference's times (T+1)/T."""
    for train in (False, True):
        want = ref_fa.analytic_cost(b, t, h, d, train=train, dtype_bytes=4)
        assert fa.analytic_cost(b, t, h, d, train=train) == (
            want.flops, want.bytes_accessed)
        causal = ref_fa.analytic_cost(b, t, h, d, True, train=train,
                                      dtype_bytes=4)
        flops, nbytes = fa.analytic_cost(b, t, h, d, True, train=train)
        assert flops == causal.flops * (t + 1) / t
        assert nbytes == causal.bytes_accessed


@pytest.mark.parametrize("shapes,mb,steps", [
    ([(784, 100), (100, 10)], 100, 600), ([(20, 12), (12, 3)], 10, 6)])
def test_fused_fc_analytic_cost_equal(shapes, mb, steps):
    want = ref_ff.analytic_cost(shapes, mb, steps)
    assert ff.analytic_cost(shapes, mb, steps) == (want.flops,
                                                   want.bytes_accessed)


def test_cost_of_fn_counts_a_matmul():
    a, b = torch.randn(24, 40), torch.randn(40, 8)
    cost = PORT_COST.cost_of_fn(torch.mm, a, b)
    assert cost.flops == 2 * 24 * 40 * 8
    assert cost.bytes_accessed == (24 * 40 + 40 * 8 + 24 * 8) * 4
    assert cost.source == "flop_counter"
    # views move nothing
    assert PORT_COST.cost_of_fn(lambda: a.t().reshape(-1)).flops == 0


def test_peaks_and_collectors():
    assert PORT_COST.peak_flops("float32", "NVIDIA H100 80GB HBM3") == 67e12
    assert PORT_COST.peak_flops(torch.bfloat16, "NVIDIA H100") == 989e12
    assert PORT_COST.peak_flops("tf32", "H100") == 495e12
    label, _ = PORT_COST.peak_flops_entry("float32", "H100 SXM")
    assert label == "telemetry.cost.PEAK_F32[h100]"
    assert fa.PEAK_F32_FLOPS == 67e12 and fa.PEAK_HBM_BYTES == 3.35e12
    one = PORT_COST.Cost(1.0, 2.0)
    with PORT_COST.collecting_kernel_costs() as outer:
        PORT_COST.note_kernel_cost(one)
        with PORT_COST.collecting_kernel_costs() as inner:
            # a launch on another thread (an engine's worker) counts too
            worker = threading.Thread(target=PORT_COST.note_kernel_cost,
                                      args=(one,))
            worker.start()
            worker.join()
        PORT_COST.note_kernel_cost(one)
    assert (len(outer), len(inner)) == (3, 1)
    PORT_COST.note_kernel_cost(one)       # no collector: a no-op


def _products(dims, mb, t, vocab, n_blocks, ffn):
    """The forward products of a step of the tiny LM, from its shapes:
    q, k, v and the output projection, q·kᵀ and p·v over every (query,
    key) pair, the two FFN matrices and the head."""
    per_block = (4 * 2 * mb * t * dims * dims
                 + 2 * 2 * mb * t * t * dims
                 + 2 * 2 * mb * t * dims * ffn)
    return n_blocks * per_block + 2 * mb * t * dims * vocab


def test_train_step_cost_report_counts_the_products():
    """A tiny LM's train step: the backward computes the gradient of
    both operands of every product (each as many FLOPs as the product),
    so the step's FLOPs are 3x the forward's products, exactly; the
    reference's XLA figure, which also counts elementwise work, is
    printed beside it."""
    prng.seed_all(3)
    wf = char_lm.build_workflow(epochs=1, minibatch_size=8, n_blocks=1,
                                dim=16, n_train=32, n_valid=16)
    wf.initialize(device="cpu")
    wf.run()
    rep = wf.train_step.cost_report()
    assert rep["key"] == "train"
    plan = wf.train_step.loader.plan_length
    cost = rep["costs"]["train"]
    step = wf.train_step._step_costs[(2, 8)]
    assert cost.flops == step.flops * plan
    t = wf.train_step.loader.original_data.mem.shape[1]
    assert step.flops == 3 * _products(16, 8, t, char_lm.VOCAB, 1, 32)
    assert step.bytes_accessed > 0 and cost.source == "flop_counter"
    params = {n: {k: v.clone() for k, v in p.items()}
              for n, p in wf.train_step.params.items()}
    again = wf.train_step.cost_report()
    assert again["cost"].flops == cost.flops
    for n, p in params.items():             # nothing trained by a report
        for k, v in p.items():
            assert torch.equal(wf.train_step.params[n][k], v)
    eval_cost = rep["costs"]["eval"]
    assert 0 < eval_cost.flops
    print("port train plan FLOPs %.6g; the reference counts its own "
          "program with XLA (elementwise work included)" % cost.flops)


# -- a training run's spans ---------------------------------------------------

def _blobs():
    rng = numpy.random.RandomState(9)
    centers = rng.randn(3, 16) * 2.5
    x = numpy.concatenate([centers[c] + rng.randn(50, 16)
                           for c in range(3)]).astype(numpy.float32)
    y = numpy.repeat(numpy.arange(3), 50).astype(numpy.int32)
    perm = rng.permutation(len(x))
    return x[perm], y[perm], [0, 30, 120]


def _build(port):
    def load_data(self):
        x, y, lengths = _blobs()
        self.create_originals(x, y)
        self.class_lengths = lengths
    base = FullBatchLoader if port else RefFullBatchLoader
    loader = type("SpanBlobs", (base,), {"hide_from_registry": True,
                                         "load_data": load_data})
    mod, wf_cls = ((prng, StandardWorkflow) if port
                   else (ref_prng, ref_nn.StandardWorkflow))
    mod.seed_all(17)
    return wf_cls(
        name="spans", layers=[
            {"type": "all2all_tanh", "output_sample_shape": 8,
             "learning_rate": 0.05},
            {"type": "softmax", "output_sample_shape": 3,
             "learning_rate": 0.05}],
        loader_unit=loader(None, minibatch_size=20, name="bl"),
        loss_function="softmax",
        decision_config=dict(max_epochs=2, fail_iterations=100),
        epochs_per_dispatch=2)


def test_training_run_spans_equal():
    counts = []
    for port, mod in ((False, REF_S), (True, PORT_S)):
        wf = _build(port)
        if port:
            wf.initialize(device="cpu")
        else:
            wf.initialize(device=vt.XLADevice(mesh_axes={"data": 1}))
        cursor = mod.recorder.cursor()
        wf.run()
        recs, _ = mod.recorder.records_since(cursor)
        got = {}
        for r in recs:
            key = (r["name"], r.get("unit"))
            got[key] = got.get(key, 0) + 1
        counts.append(got)
    assert counts[0] == counts[1]
    assert counts[1][("workflow.run", None)] == 1
    assert counts[1][("train_step.epoch_block", "TrainStep")] == 1
    assert sum(n for (name, _), n in counts[1].items()
               if name == "unit.run") > 0

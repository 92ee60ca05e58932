"""The port's GenerationAPI (veles_tpu_torch/restful_api.py) over real
HTTP on the CPU, on the window plane (``engine="window"``; the
continuous engine is tests/test_torch_serving_engine.py): the window
plane coalesces concurrent requests into one batched decode whose rows
equal their solo decodes, eos trimming, the 400 answers for what the
window plane refuses, and the 503 for an expired deadline. The served tokens are also held against the JAX package's
sampler on the same weights."""
import json
import threading
import urllib.error
import urllib.request

import jax  # noqa: F401 — both frameworks in one process, JAX on CPU
import numpy
import pytest
import torch

import veles_tpu as vt
from veles_tpu import nn as jnn
from veles_tpu.nn import sampling as jsampling

from veles_tpu_torch.convert import params_from_jax, random_params
from veles_tpu_torch.nn import sampling as tsampling
from veles_tpu_torch.nn.standard_workflow import build_forwards
from veles_tpu_torch.restful_api import GenerationAPI

LAYERS = ([{"type": "embedding", "vocab_size": 32, "dim": 32}]
          + [{"type": "transformer_block", "n_heads": 4,
              "ffn_hidden": 64, "causal": True, "rope": True,
              "name": "blk%d" % i} for i in range(2)]
          + [{"type": "lm_head", "vocab_size": 32}])


def _post(url, payload, timeout=60.0):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _concurrent(url, payloads):
    out = [None] * len(payloads)

    def fire(i):
        out[i] = _post(url, payloads[i])

    threads = [threading.Thread(target=fire, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert all(not t.is_alive() for t in threads)
    return out


@pytest.fixture(scope="module")
def model():
    m = build_forwards(LAYERS, device="cpu")
    return params_from_jax(m, random_params(m, seed=3))


@pytest.fixture(scope="module")
def served(model):
    api = GenerationAPI(model, port=0, device="cpu", batch_window=0.3,
                        engine="window", name="torch-genapi").initialize()
    yield api, "http://127.0.0.1:%d/generate" % api.port
    api.stop()


def _prompt(seed, n=10):
    return [int(t) for t in numpy.random.RandomState(seed).randint(0, 32, n)]


def test_concurrent_greedy_batched_equal_solo(served, model):
    api, url = served
    prompts = [_prompt(s) for s in range(4)]
    res = _concurrent(url, [{"prompt": p, "n_new": 8} for p in prompts])
    assert all(code == 200 for code, _, _ in res)
    assert max(body["batched_with"] for _, body, _ in res) > 0
    assert api.max_batch > 1
    for p, (_, body, _) in zip(prompts, res):
        assert body["tokens"] == tsampling.generate(model, p, 8,
                                                    temperature=0)
        assert body["request_id"]


def test_concurrent_sample_batched_equal_solo(served, model):
    _, url = served
    prompts = [_prompt(10 + s) for s in range(3)]
    res = _concurrent(url, [{"prompt": p, "n_new": 8, "mode": "sample",
                             "temperature": 0.7, "seed": 9}
                            for p in prompts])
    assert max(body["batched_with"] for _, body, _ in res) > 0
    for p, (code, body, _) in zip(prompts, res):
        assert code == 200
        assert body["tokens"] == tsampling.generate(
            model, p, 8, temperature=0.7, seed=9)


def test_served_greedy_matches_jax_sampler(served, model):
    """The same weights in a reference workflow: the served tokens are
    the JAX package's tokens."""
    _, url = served
    prev = vt.root.common.engine.compute_dtype
    vt.root.common.engine.compute_dtype = "float32"
    try:
        from conftest import import_model
        lm = import_model("char_lm")
        wf = jnn.StandardWorkflow(
            name="served-ref", layers=LAYERS,
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
        prompt = _prompt(20, 12)
        code, body, _ = _post(url, {"prompt": prompt, "n_new": 10})
        assert code == 200
        assert body["tokens"] == jsampling.generate(wf, prompt, 10,
                                                    temperature=0)
    finally:
        vt.root.common.engine.compute_dtype = prev


def test_eos_trimming(served, model):
    _, url = served
    prompt = _prompt(30)
    full = tsampling.generate(model, prompt, 8, temperature=0)
    eos = full[3]
    code, body, _ = _post(url, {"prompt": prompt, "n_new": 8,
                                "eos_id": eos})
    assert code == 200
    assert body["tokens"] == full[:full.index(eos) + 1]


@pytest.mark.parametrize("mode", ["speculative", "beam"])
def test_unported_modes_answer_400(served, mode):
    """The reference's 400s of the two modes: speculation on a server
    with no draft, a beam wider than the head's vocabulary."""
    _, url = served
    code, body, _ = _post(url, {"prompt": [1, 2], "n_new": 2,
                                "mode": mode, "beam": 33})
    assert code == 400
    assert ("needs a draft model" if mode == "speculative"
            else "exceeds the head's vocab size 32") in body["error"]


@pytest.mark.parametrize("payload", [
    {"prompt": [], "n_new": 2}, {"prompt": [1, 2], "n_new": 0},
    {"prompt": [1, 2], "mode": "sample"},
    {"prompt": [1, 2], "eos_id": True}, {"prompt": [1, "a"]}])
def test_bad_requests_answer_400(served, payload):
    _, url = served
    code, body, _ = _post(url, payload)
    assert code == 400 and "bad request" in body["error"]


def test_healthz_and_unknown_path(served):
    api, url = served
    base = "http://127.0.0.1:%d" % api.port
    # the health plane's probes (resilience/health.py): the window
    # worker's heartbeat, the API's readiness mark
    with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
        body = json.loads(r.read())
    assert body["status"] == "ok"
    assert body["heartbeats"]["serve.%s" % api.name]["healthy"] is True
    with urllib.request.urlopen(base + "/readyz", timeout=10) as r:
        body = json.loads(r.read())
    assert body["components"]["serve.%s" % api.name] is True
    with urllib.request.urlopen(base + "/stats", timeout=10) as r:
        body = json.loads(r.read())
    assert body["engine"] == "window" and body["device"] == "cpu"
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(base + "/nope", timeout=10)
    assert err.value.code == 404


def test_expired_deadline_answers_503(model):
    api = GenerationAPI(model, port=0, device="cpu", batch_window=0.5,
                        request_timeout=0.05, engine="window",
                        name="expiry").initialize()
    try:
        code, body, headers = _post(
            "http://127.0.0.1:%d/generate" % api.port,
            {"prompt": [1, 2, 3], "n_new": 2})
        assert code == 503 and "expired" in body["error"]
        assert headers.get("Retry-After") == "1"
        assert body["request_id"]
    finally:
        api.stop()


def test_api_defaults_to_the_card(model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from veles_tpu_torch.error import VelesError
    with pytest.raises(VelesError, match="CUDA"):
        GenerationAPI(model)


def test_many_concurrent_requests_all_answered(served, model):
    """More client threads than cores, with a short switch interval:
    every request is answered exactly once with its solo decode, and
    the worker's batch tally accounts for every request."""
    import sys
    api, url = served
    prompts = [_prompt(100 + i, n=6) for i in range(24)]
    batches0 = api.batches_run
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        res = _concurrent(url, [{"prompt": p, "n_new": 3} for p in prompts])
    finally:
        sys.setswitchinterval(interval)
    assert [code for code, _, _ in res] == [200] * len(prompts)
    assert len({body["request_id"] for _, body, _ in res}) == len(prompts)
    rows = tsampling.generate(model, prompts, 3, temperature=0)
    assert [body["tokens"] for _, body, _ in res] == rows
    groups = api.batches_run - batches0
    assert 1 <= groups < len(prompts)      # coalesced, not one by one


def test_ticket_is_answered_exactly_once():
    from veles_tpu_torch.serving.scheduler import (Ticket, shed_expired,
                                                   split_expired)
    t = Ticket(deadline=0.0)
    live, expired = split_expired([({}, t), ({}, Ticket())], now=1.0)
    assert expired == [t] and len(live) == 1
    shed_expired(expired)
    assert t.code == 503 and t.error_payload()["retry_after"] == 1.0
    assert not t.succeed({"tokens": []})
    assert not t.fail("again", code=500)
    assert t.code == 503 and t.result is None

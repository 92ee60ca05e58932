"""The port's O(1)-state serving lane (veles_tpu_torch/serving/
recurrent.py) on the CPU, against the reference's (veles_tpu/serving/
recurrent.py) on the same weights: the reference's own fixtures — a
char-LM ``arch="lstm"`` (1 block, dim 32) trained one epoch, and an
``arch="ssm"`` one initialised — carried into the port with
``convert.params_from_jax``; engines of 3 slots, chunks (``page_size``)
of 8 and max_context 64, as the reference's tests run them.

- ``split_recurrent_stack`` takes the LSTM and SSM stacks and refuses
  the transformer, and the paged engine refuses the recurrent stacks;
- greedy tokens of the port's ``RecurrentEngine`` equal the reference
  ``RecurrentEngine``'s exactly, for both families, at decode_block 1
  and 4;
- pooled equals solo (``generate_recurrent``) exactly in the port,
  greedy and sampled (the port draws from ``torch.Generator``s, so its
  sampled tokens are held against its own solo decode, not against the
  reference's threefry), also across two tiles of the lane's rows;
- the state pool's bytes are the same after a 4- and a 44-token decode,
  and the lane has no pages;
- ``GenerationAPI``'s default engine serves the LSTM LM over HTTP
  through the lane (``/stats``: ``slot_kind`` "state", ``pages_total``
  0; ``/metrics``: state gauges, no page gauges); a pinned "recurrent"
  on a transformer degrades to the window plane; speculative and beam
  modes answer 400; the knobs of the parts not ported yet raise."""
import json
import urllib.error
import urllib.request

import jax  # noqa: F401 — both frameworks in one process, JAX on CPU
import numpy
import pytest
import torch

import veles_tpu as vt
from veles_tpu import prng as ref_prng
from veles_tpu.nn import sampling as ref_sampling
from veles_tpu.serving import RecurrentEngine as RefRecurrentEngine
from veles_tpu.serving.engine import make_request as ref_make_request

from veles_tpu_torch.config import root
from veles_tpu_torch.convert import params_from_jax, random_params
from veles_tpu_torch.error import VelesError
from veles_tpu_torch.models import char_lm
from veles_tpu_torch.nn.standard_workflow import build_forwards
from veles_tpu_torch.restful_api import GenerationAPI
from veles_tpu_torch.serving import (O1_COUNTERS, ContinuousEngine,
                                     RecurrentEngine, generate_recurrent,
                                     make_request, split_recurrent_stack)
from veles_tpu_torch.serving.recurrent import LANE_ROWS
from veles_tpu_torch.telemetry.counters import DESCRIPTIONS, counters

from conftest import import_model

ENGINE = dict(max_slots=3, max_context=64, page_size=8)
PROMPTS = [[1, 5, 3, 2, 4, 6, 1, 2], [0, 1, 2, 3, 4, 5, 6, 7, 0, 1, 2],
           [3, 4]]


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
def stacks():
    """family → (reference workflow, the port's stack with its
    weights), and the transformer twin's port stack."""
    prev = vt.root.common.engine.compute_dtype
    vt.root.common.engine.compute_dtype = "float32"
    lm = import_model("char_lm")
    out = {}
    try:
        for family, seed, train in (("lstm", 2026, True),
                                    ("ssm", 2027, False)):
            ref_prng.seed_all(seed)
            wf = lm.build_workflow(epochs=1, minibatch_size=32,
                                   n_blocks=1, dim=32, n_train=64,
                                   n_valid=32, arch=family)
            wf.initialize(device=vt.XLADevice(mesh_axes={"data": 1}))
            if train:
                wf.run()
            params = {u: {k: numpy.asarray(v) for k, v in t.items()}
                      for u, t in ref_sampling.params_of(wf).items()}
            out[family] = (wf, params_from_jax(
                build_forwards(wf.layers_config, device="cpu"), params))
        tf = build_forwards(char_lm.build_workflow(
            n_blocks=1, dim=32).layers_config, device="cpu")
        out["transformer"] = (None, params_from_jax(tf, random_params(tf)))
        yield out
    finally:
        vt.root.common.engine.compute_dtype = prev


def _serve(stack, reqs, **kw):
    eng = RecurrentEngine(stack, name="o1t", **dict(ENGINE, **kw)).start()
    try:
        return eng.serve(reqs), eng.stats()
    finally:
        eng.stop()


def test_split_stack_accepts_recurrent_rejects_transformer(stacks):
    for family in ("lstm", "ssm"):
        stack = split_recurrent_stack(list(stacks[family][1]))
        assert [b.name for b in stack["blocks"]] == [family + "0"]
        with pytest.raises(VelesError):
            ContinuousEngine(stacks[family][1], buckets=(16,),
                             max_context=32, name="o1t_reject")
    with pytest.raises(VelesError, match="TransformerBlock"):
        split_recurrent_stack(list(stacks["transformer"][1]))
    with pytest.raises(VelesError):
        RecurrentEngine(stacks["transformer"][1], name="o1t_reject")


@pytest.mark.parametrize("decode_block", [1, 4])
@pytest.mark.parametrize("family", ["lstm", "ssm"])
def test_greedy_tokens_equal_the_reference_engine(stacks, family,
                                                  decode_block):
    wf, port = stacks[family]
    ref = RefRecurrentEngine(wf, decode_block=decode_block,
                             name="o1t_ref", **ENGINE).start()
    try:
        want = ref.serve([ref_make_request(p, 12) for p in PROMPTS])
    finally:
        ref.stop()
    got, _ = _serve(port, [make_request(p, 12) for p in PROMPTS],
                    decode_block=decode_block)
    assert got == want
    assert len(set(map(tuple, got))) > 1       # not a constant stream


@pytest.mark.parametrize("temperature", [0.0, 0.8],
                         ids=["greedy", "sampled"])
@pytest.mark.parametrize("family", ["lstm", "ssm"])
def test_pool_matches_solo(stacks, family, temperature):
    port = stacks[family][1]
    mode = "sample" if temperature > 0 else "greedy"
    solo = [generate_recurrent(port, p, 10, temperature=temperature,
                               seed=11 + i, mode=mode)
            for i, p in enumerate(PROMPTS)]
    got, st = _serve(port, [make_request(p, 10, temperature=temperature,
                                         seed=11 + i, mode=mode)
                            for i, p in enumerate(PROMPTS)])
    assert got == solo
    assert st["admitted"] == st["retired"] == 3


def test_pool_of_two_tiles_matches_solo(stacks):
    """Ten slots are two tiles of the lane's rows: a row decodes in the
    second tile exactly as alone."""
    port = stacks["lstm"][1]
    prompts = [[(3 * i + j) % 16 for j in range(4 + i)] for i in range(10)]
    reqs = [make_request(p, 6, temperature=0.9 if i % 2 else 0.0,
                         seed=i, mode="sample" if i % 2 else "greedy")
            for i, p in enumerate(prompts)]
    got, st = _serve(port, reqs, max_slots=10)
    assert st["state_pool_rows"] == 2 * LANE_ROWS
    for req, tokens in zip(reqs, got):
        assert tokens == generate_recurrent(
            port, req["prompt"], 6, temperature=req["temperature"],
            seed=req["seed"], mode=req["mode"])


def test_state_bytes_constant_vs_token_count(stacks):
    port = stacks["lstm"][1]
    eng = RecurrentEngine(port, name="o1t_bytes", **ENGINE).start()
    try:
        eng.serve([make_request(PROMPTS[0], 4)])
        short = eng.stats()
        eng.serve([make_request(PROMPTS[0], 44)])
        long = eng.stats()
    finally:
        eng.stop()
    assert short["kv_pool_bytes"] == long["kv_pool_bytes"] > 0
    # the LSTM's (h, c) of width 32 in float32, for each row of the pool
    assert long["state_bytes_per_slot"] == 2 * 32 * 4
    assert long["kv_pool_bytes"] == LANE_ROWS * 2 * 32 * 4
    assert long["pages_total"] == long["pages_in_use"] == 0
    assert long["slot_kind"] == "state"
    assert eng.scheduler.page_pool is None


def test_engine_routes_what_it_cannot_serve(stacks):
    eng = RecurrentEngine(stacks["lstm"][1], name="o1t_acc", **ENGINE)
    for mode in ("speculative", "beam"):
        assert "greedy/sample only" in eng.accepts(
            make_request(PROMPTS[0], 4, mode=mode))
    assert eng.accepts(make_request(PROMPTS[0], 4)) is None
    assert "max_context" in eng.accepts(make_request(list(range(60)), 8))
    assert "resolution" in eng.accepts(make_request(
        PROMPTS[0], 4, temperature=1e-4, mode="sample"))
    assert eng.accepts(make_request([], 4)) == "empty prompt"


def test_eos_retires_the_row(stacks):
    port = stacks["lstm"][1]
    full, _ = _serve(port, [make_request(PROMPTS[0], 12)])
    eos = full[0][3]
    got, st = _serve(port, [make_request(PROMPTS[0], 12, eos_id=eos)])
    assert got[0] == full[0][:full[0].index(eos) + 1]
    assert st["retired"] == 1 and st["slots_busy"] == 0


@pytest.mark.parametrize("knob", ["state_cache", "artifact"])
def test_unported_parts_raise(stacks, knob):
    with pytest.raises(VelesError, match="ROADMAP"):
        RecurrentEngine(stacks["lstm"][1], name="o1t_knob",
                        **{knob: True if knob == "state_cache" else "d"})


def test_o1_counters_are_registered_and_stay_zero(stacks):
    before = {name: counters.get(name) for name in O1_COUNTERS}
    _serve(stacks["ssm"][1], [make_request(PROMPTS[1], 5)])
    for name in O1_COUNTERS:
        assert DESCRIPTIONS[name]
        assert counters.get(name) == before[name] == 0
    assert root.common.serving.state_cache is False
    assert root.common.serving.get("state_cache_blocks") is None


# -- the request plane --------------------------------------------------------

def test_generation_api_default_engine_serves_lstm_through_the_lane(
        stacks):
    port = stacks["lstm"][1]
    api = GenerationAPI(port, port=0, device="cpu", max_slots=3,
                        max_context=64, page_size=8, name="o1t_api")
    assert api.engine_kind == "continuous"
    api.initialize()
    try:
        assert isinstance(api._engine, RecurrentEngine)
        url = "http://127.0.0.1:%d" % api.port
        code, body = _post(url + "/generate",
                           {"prompt": PROMPTS[0], "n_new": 10})
        assert code == 200 and body["engine"] == "recurrent"
        assert body["tokens"] == generate_recurrent(port, PROMPTS[0], 10)
        code, body = _post(url + "/generate",
                           {"prompt": PROMPTS[1], "n_new": 6,
                            "mode": "sample", "temperature": 0.7,
                            "seed": 3})
        assert code == 200 and body["tokens"] == generate_recurrent(
            port, PROMPTS[1], 6, temperature=0.7, seed=3, mode="sample")
        stats = json.loads(_get(url + "/stats"))
        lane = stats["continuous"]
        assert lane["slot_kind"] == "state"
        assert lane["pages_total"] == 0
        assert lane["admitted"] == lane["retired"] == 2
        assert lane["kv_pool_bytes"] == LANE_ROWS * \
            lane["state_bytes_per_slot"]
        metrics = _get(url + "/metrics")
        assert "veles_o1_state_bytes_per_slot %d" % \
            lane["state_bytes_per_slot"] in metrics
        assert "veles_serving_kv_pool_bytes %d" % \
            lane["kv_pool_bytes"] in metrics
        assert "veles_serving_pages_total" not in metrics
        assert "veles_serving_page_size" not in metrics
        for mode in ("speculative", "beam"):
            code, body = _post(url + "/generate",
                               {"prompt": PROMPTS[0], "n_new": 4,
                                "mode": mode})
            assert code == 400 and "not ported" in body["error"]
    finally:
        api.stop()


def test_pinned_recurrent_on_a_transformer_degrades_to_window(stacks):
    port = stacks["transformer"][1]
    api = GenerationAPI(port, port=0, device="cpu", engine="recurrent",
                        name="o1t_pin").initialize()
    try:
        assert api._engine is None
        url = "http://127.0.0.1:%d" % api.port
        code, body = _post(url + "/generate",
                           {"prompt": PROMPTS[0], "n_new": 5})
        assert code == 200 and "engine" not in body
        assert len(body["tokens"]) == 5
        assert json.loads(_get(url + "/stats"))["engine"] == "window"
        assert "veles_serving_pages_total" not in _get(url + "/metrics")
    finally:
        api.stop()


def test_transformer_keeps_the_paged_engine(stacks):
    api = GenerationAPI(stacks["transformer"][1], port=0, device="cpu",
                        max_slots=2, buckets=(16,), max_context=32,
                        name="o1t_paged").initialize()
    try:
        assert isinstance(api._engine, ContinuousEngine)
        assert "veles_serving_pages_total" in _get(
            "http://127.0.0.1:%d/metrics" % api.port)
    finally:
        api.stop()


def test_char_lm_generate_rides_the_lane():
    """``models.char_lm.generate`` of a recurrent workflow is the lane's
    solo decode over the workflow's parameters; the full-window forward
    picks the same first token."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.nn.standard_workflow import forwards_of
    prng.seed_all(7)
    wf = char_lm.build_workflow(epochs=1, minibatch_size=32, n_blocks=1,
                                n_train=64, n_valid=32, arch="ssm")
    wf.initialize(device="cpu")
    stack = forwards_of(wf)
    got = char_lm.generate(wf, PROMPTS[2], 7, temperature=0)
    assert got == generate_recurrent(stack, PROMPTS[2], 7)
    with torch.no_grad():
        logits = stack(torch.as_tensor([PROMPTS[2]]))
    assert int(torch.argmax(logits[0, -1])) == got[0]
    sampled = char_lm.generate(wf, PROMPTS[2], 7, temperature=0.8, seed=4)
    assert sampled == generate_recurrent(stack, PROMPTS[2], 7,
                                         temperature=0.8, seed=4,
                                         mode="sample")

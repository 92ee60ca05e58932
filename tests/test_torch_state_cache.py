"""The O(1)-state lane's state-checkpoint prefix cache in the port
(veles_tpu_torch/serving/pages.py ``StateCache``, serving/recurrent.py
``state_cache=True``) against the reference's (veles_tpu/serving/
pages.py, serving/recurrent.py), on the CPU:

- ``StateCache`` alone: one sequence of inserts, matches (deep, partial,
  miss, a key rotted by the ``corrupt`` fault), a ``None`` snapshot that
  stops the walk, first-writer-wins, LRU-leaf eviction under a block
  budget and ``clear`` gives the reference's depths, snapshots, counts,
  bytes and ``veles_o1_state_evictions_total``;
- the lane with the cache on, on the reference's char-LM ``arch="lstm"``
  and ``"ssm"`` (1 block, dim 32, initialised from one seed and carried
  with ``convert.params_from_jax``; 3 slots, chunks of 8, as the
  reference's tests run it): a 24-token prompt served cold and then warm
  gives the reference engine's tokens, equal to the solo decode, and the
  reference's ``stats()`` counters (checkpoints, restores, blocks,
  bytes); sampled warm = sampled cold;
- the three fault points of tests/test_o1_serving.py:220-300:
  ``serve.state_restore`` raise degrades to a counted re-scan and
  corrupt to a shorter match, each with the warm answer, and
  ``serve.state_checkpoint`` raise caches nothing and answers as the solo
  decode;
- a block budget evicts (counted) without changing an answer; a resumed
  request adopts the cached prompt's snapshot and continues as the
  uninterrupted decode; ``GenerationAPI(state_cache=True)`` and
  ``root.common.serving.state_cache`` serve warm answers over HTTP with
  the ``veles_o1_state_*`` gauges on ``/metrics``.
"""
import json
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
from veles_tpu.serving.pages import StateCache as RefStateCache
from veles_tpu.telemetry.counters import counters as ref_counters

from veles_tpu_torch.config import root
from veles_tpu_torch.convert import params_from_jax
from veles_tpu_torch.nn.standard_workflow import build_forwards
from veles_tpu_torch.restful_api import GenerationAPI
from veles_tpu_torch.serving import (RecurrentEngine, StateCache,
                                     fold_resume, generate_recurrent,
                                     make_request)
from veles_tpu_torch.telemetry.counters import counters

from conftest import import_model

ENGINE = dict(max_slots=3, max_context=64, page_size=8)
STATS = ("state_checkpoints", "state_restores", "state_rescans",
         "state_cache_blocks", "state_cache_bytes", "prefix_requests")


class _Rot:
    """The ``corrupt`` fault's action on a key: flip the middle byte."""

    @staticmethod
    def corrupt(data: bytes) -> bytes:
        mid = len(data) // 2
        return data[:mid] + bytes([data[mid] ^ 0xFF]) + data[mid + 1:]


def _snap(value, port):
    arr = numpy.full(4, value, numpy.float32)
    return ({"h": torch.from_numpy(arr) if port else arr},)


def _drive(cache, port):
    """One sequence of operations; everything it observes."""
    a = list(range(24))                       # three blocks of 8
    b = a[:8] + [99] * 16                     # shares block 0 with a
    out = [cache.insert(a, [_snap(i, port) for i in (1, 2, 3)])]
    depth, snap = cache.match(a + [5])
    out.append((depth, float(snap[0]["h"][0])))
    depth, snap = cache.match(a[:20])
    out.append((depth, float(snap[0]["h"][0])))
    out.append(cache.match([7] * 16))
    out.append(cache.match(a, corrupt=_Rot()))
    # a None snapshot over an existing node only touches it; where no
    # node exists it stops the walk
    out.append(cache.insert(b, [None, _snap(8, port), _snap(9, port)]))
    out.append(cache.insert([5] * 16, [None, _snap(4, port)]))
    # first writer wins
    out.append(cache.insert(a, [_snap(7, port)] * 3))
    out.append(float(cache.match(a + [1])[1][0]["h"][0]))
    out.append(dict(cache.stats()))
    out.append(cache.state_bytes())
    cache.max_blocks = 3
    cache.match(b + [1])                      # b's blocks the freshest
    out.append(cache.evict())
    out.append(cache.match(a + [1])[0])
    out.append(cache.match(b + [1])[0])
    out.append(dict(cache.stats()))
    cache.clear()
    out.append((dict(cache.stats()), cache.match(a)))
    return out


def test_state_cache_matches_reference():
    ev = counters.get("veles_o1_state_evictions_total")
    ref_ev = ref_counters.get("veles_o1_state_evictions_total")
    got = _drive(StateCache(8), True)
    want = _drive(RefStateCache(8), False)
    assert got == want
    assert got[0] == 3 and got[1] == (24, 3.0) and got[2] == (16, 2.0)
    assert got[3] == (0, None) and got[4][0] < 24
    assert got[5] == 2 and got[6] == 0 and got[7] == 0 and got[8] == 3.0
    assert got[11] == 2 and got[12] == 8 and got[13] == 24
    assert counters.get("veles_o1_state_evictions_total") - ev == \
        ref_counters.get("veles_o1_state_evictions_total") - ref_ev == 2


# -- the lane -----------------------------------------------------------------

@pytest.fixture(scope="module")
def stacks():
    """family → (reference workflow, the port's stack with its weights,
    a 24-token prompt of the reference's corpus)."""
    prev = vt.root.common.engine.compute_dtype
    vt.root.common.engine.compute_dtype = "float32"
    lm = import_model("char_lm")
    prompt = [int(t) for t in lm.make_corpus(numpy.random.RandomState(5),
                                             24)]
    out = {}
    try:
        for family, seed in (("lstm", 2026), ("ssm", 2027)):
            ref_prng.seed_all(seed)
            wf = lm.build_workflow(epochs=1, minibatch_size=32, n_blocks=1,
                                   dim=32, n_train=64, n_valid=32,
                                   arch=family)
            wf.initialize(device=vt.XLADevice(mesh_axes={"data": 1}))
            params = {u: {k: numpy.asarray(v) for k, v in t.items()}
                      for u, t in ref_sampling.params_of(wf).items()}
            out[family] = (wf, params_from_jax(
                build_forwards(wf.layers_config, device="cpu"), params),
                prompt)
        yield out
    finally:
        vt.root.common.engine.compute_dtype = prev


def _engine(stack, **kw):
    return RecurrentEngine(stack, name="sc", **dict(ENGINE, **kw)).start()


@pytest.mark.parametrize("family", ["lstm", "ssm"])
def test_warm_equals_cold_and_the_reference_engine(stacks, family):
    wf, port, prompt = stacks[family]
    ref = RefRecurrentEngine(wf, state_cache=True, name="sc_ref",
                             **ENGINE).start()
    try:
        want = [ref.serve([ref_make_request(prompt, 8)])[0]
                for _ in range(2)]
        want_stats = {k: ref.stats()[k] for k in STATS}
    finally:
        ref.stop()
    restored = counters.get("veles_o1_state_restored_tokens_total")
    eng = _engine(port, state_cache=True)
    try:
        got = [eng.serve([make_request(prompt, 8)])[0] for _ in range(2)]
        got_stats = {k: eng.stats()[k] for k in STATS}
        sampled = [eng.serve([make_request(prompt, 6, temperature=0.8,
                                           seed=4, mode="sample")])[0]
                   for _ in range(2)]
    finally:
        eng.stop()
    assert got == want
    assert got[0] == got[1] == generate_recurrent(port, prompt, 8)
    assert got_stats == want_stats
    # 24 tokens: three blocks cached; the warm match over prompt[:23]
    # adopts two of them and re-scans the third
    assert got_stats["state_checkpoints"] == 3
    assert got_stats["state_cache_blocks"] == 3
    assert got_stats["state_restores"] >= 1
    assert counters.get("veles_o1_state_restored_tokens_total") \
        - restored == 16 * 3
    assert sampled[0] == sampled[1] == generate_recurrent(
        port, prompt, 6, temperature=0.8, seed=4, mode="sample")
    assert eng.state_cache.stats()["blocks"] == 0      # stop() cleared


@pytest.mark.parametrize("fault", ["restore_raise", "restore_corrupt",
                                   "checkpoint_raise"])
def test_fault_points_degrade_as_the_reference(stacks, fault,
                                                monkeypatch):
    _, port, prompt = stacks["lstm"]
    oracle = generate_recurrent(port, prompt, 6)
    spec = {"restore_raise": "serve.state_restore:raise:times=1",
            "restore_corrupt": "serve.state_restore:corrupt:times=1",
            "checkpoint_raise": "serve.state_checkpoint:raise:times=1"}
    rescans = counters.get("veles_o1_state_rescans_total")
    injected = counters.get("veles_faults_injected_total")
    eng = _engine(port, state_cache=True)
    try:
        if fault != "checkpoint_raise":
            assert eng.serve([make_request(prompt, 6)])[0] == oracle
        monkeypatch.setenv("VELES_FAULTS", spec[fault])
        out = eng.serve([make_request(prompt, 6)])[0]
        monkeypatch.delenv("VELES_FAULTS")
        st = eng.stats()
    finally:
        eng.stop()
    assert out == oracle
    assert counters.get("veles_faults_injected_total") > injected
    if fault == "restore_raise":
        assert counters.get("veles_o1_state_rescans_total") == rescans + 1
        assert st["state_rescans"] == 1 and st["state_restores"] == 0
    elif fault == "restore_corrupt":
        assert st["state_restores"] == 0 and st["state_rescans"] == 0
    else:
        assert st["state_cache_blocks"] == 0
        assert st["state_checkpoints"] == 0


def test_block_budget_evicts_without_changing_answers(stacks):
    _, port, prompt = stacks["ssm"]
    other = [(t + 3) % 16 for t in prompt]
    ev = counters.get("veles_o1_state_evictions_total")
    root.common.serving.state_cache_blocks = 4
    try:
        eng = _engine(port, state_cache=True)
    finally:
        root.common.serving.state_cache_blocks = None
    try:
        outs = [eng.serve([make_request(p, 5)])[0]
                for p in (prompt, other, prompt)]
        assert eng.stats()["state_cache_blocks"] <= 4
    finally:
        eng.stop()
    assert counters.get("veles_o1_state_evictions_total") > ev
    assert outs[0] == outs[2] == generate_recurrent(port, prompt, 5)
    assert outs[1] == generate_recurrent(port, other, 5)


def test_resumed_request_adopts_the_cached_prompt(stacks):
    _, port, prompt = stacks["lstm"]
    full = generate_recurrent(port, prompt, 12)
    eng = _engine(port, state_cache=True)
    try:
        assert eng.serve([make_request(prompt, 12)])[0] == full
        restores = eng.state_restores
        req = fold_resume(make_request(prompt, 12), full[:5])
        assert eng.serve([req])[0] == full[5:]
        assert eng.state_restores == restores + 1
    finally:
        eng.stop()


def test_generation_api_serves_warm_answers(stacks):
    _, port, prompt = stacks["lstm"]
    want = generate_recurrent(port, prompt, 6)
    for kw in ({"state_cache": True}, {}):
        root.common.serving.state_cache = not kw
        try:
            api = GenerationAPI(port, port=0, device="cpu",
                                name="sc_api", **dict(ENGINE, **kw))
            api.initialize()
        finally:
            root.common.serving.state_cache = False
        try:
            url = "http://127.0.0.1:%d" % api.port
            for _ in range(2):
                req = urllib.request.Request(
                    url + "/generate", data=json.dumps(
                        {"prompt": prompt, "n_new": 6}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=60) as r:
                    assert json.loads(r.read())["tokens"] == want
            stats = json.loads(urllib.request.urlopen(
                url + "/stats", timeout=30).read())["continuous"]
            assert stats["state_restores"] == 1
            assert stats["state_cache_blocks"] == 3
            metrics = urllib.request.urlopen(url + "/metrics",
                                             timeout=30).read().decode()
            assert "veles_o1_state_cache_blocks 3" in metrics
            assert "veles_o1_state_cache_bytes %d" % \
                stats["state_cache_bytes"] in metrics
        finally:
            api.stop()

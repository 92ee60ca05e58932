"""The port's int8 plane (veles_tpu_torch/quant/, ops/precision.py's int8
primitives, the engine's ``quant_weights``/``quant_kv``, int8 snapshots
and the ``quantize`` subcommand) against the reference's on the CPU.

- the primitives give the reference's bits: int8 values and scales (their
  shapes too) of both granularities, over random weights, an all-zero
  group, extremes, a bf16 source, and groups holding a NaN or an
  infinity; K/V rows likewise;
- ``quantize_params`` and ``quantize_state`` equal the reference's record
  for record, with the same eligibility and report; a state quantized by
  either package loads in the other to equal arrays, through the gz file
  and the sqlite DSN, and so does each package's ``quantize`` subcommand
  output;
- the port's int8 engines answer the reference's int8 engines' greedy
  tokens for ``(quant_weights, quant_kv)`` in (1, 0), (0, 1), (1, 1) on
  the same weights (a reference char LM, 2 RoPE blocks, d 32, initialised
  from a seed; ``compute_dtype`` float32, so both sides run float32
  products) — a resumed request on the int8 pool included, whose prefill
  re-quantizes the emitted tokens' rows as the reference's does. Sampled
  rows cannot cross the packages (threefry against ``torch.Generator``):
  they equal the same requests served solo, and under int8 weights alone
  the float engine serving the dequantized twin;
- quant-off leaks no quant counter, the int8 runs count the tensors and
  bytes the shapes imply; the int8 pool's bytes are payload plus scales;
  an injected ``quant.calibrate`` fault fails one tick and the queued
  request is then answered; speculative and beam requests on the int8
  pool get the reference's window-plane reasons.
"""
import gzip
import os
import pickle
import sqlite3

import jax  # noqa: F401 — both frameworks in one process, JAX on CPU
import numpy
import pytest
import torch

import veles_tpu as vt
from veles_tpu import prng as ref_prng
from veles_tpu import quant as ref_quant
from veles_tpu.nn import sampling as ref_sampling
from veles_tpu.ops import precision as ref_precision
from veles_tpu.serving import ContinuousEngine as RefEngine
from veles_tpu.serving.engine import fold_resume as ref_fold_resume
from veles_tpu.serving.engine import make_request as ref_make_request
from veles_tpu.snapshotter import load_snapshot as ref_load_snapshot

from veles_tpu_torch import quant
from veles_tpu_torch.convert import params_from_jax
from veles_tpu_torch.nn import sampling
from veles_tpu_torch.nn.standard_workflow import build_forwards
from veles_tpu_torch.ops import precision
from veles_tpu_torch.serving import ContinuousEngine, make_request
from veles_tpu_torch.serving.engine import fold_resume
from veles_tpu_torch.snapshotter import SnapshotterToDB, load_snapshot
from veles_tpu_torch.telemetry.counters import counters

from conftest import import_model

ENGINE = dict(max_slots=3, buckets=(8, 16), max_context=48)
PAIRS = [(True, False), (False, True), (True, True)]


def _np(x):
    return numpy.asarray(x)


def _same(ref, port):
    """Bits, dtype and shape equal (a reference jax array vs a port
    tensor)."""
    a, b = _np(ref), port.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype
    assert a.tobytes() == b.tobytes()


def _weights(seed):
    """Random weights with the groups that matter: an all-zero column,
    columns of huge and tiny values, a column of exact halves of the
    scale (the round-half-to-even ties) and mixed signs."""
    rng = numpy.random.RandomState(seed)
    w = rng.randn(48, 40).astype(numpy.float32)
    w[:, 0] = 0.0
    w[:, 1] *= 3e4
    w[:, 2] *= 1e-30
    w[:, 3] = numpy.float32(127.0) * numpy.array(
        [0.5, 1.5, 2.5, -0.5, -1.5] * 9 + [127.0, 1.0, -127.0],
        numpy.float32) / numpy.float32(127.0)
    return w


@pytest.mark.parametrize("granularity", ["per_channel", "per_tensor"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_values_and_scales_equal_reference(granularity, dtype):
    axis = -1 if granularity == "per_channel" else None
    w = _weights(1)
    src_ref = jax.numpy.asarray(w).astype(dtype)
    src = torch.from_numpy(w).to(getattr(torch, dtype))
    q_ref, s_ref = ref_precision.quantize_int8(src_ref, axis=axis)
    q, s = precision.quantize_int8(src, axis=axis)
    _same(q_ref, q)
    _same(s_ref, s)
    assert tuple(s.shape) == ((1, 40) if axis == -1 else ())
    for out_dtype in (None, "float32", "bfloat16"):
        want = _np(ref_precision.dequantize_int8(q_ref, s_ref,
                                                 dtype=out_dtype))
        got = precision.dequantize_int8(q, s, dtype=out_dtype)
        assert str(got.dtype).endswith(str(want.dtype))
        assert numpy.array_equal(got.float().numpy(),
                                 want.astype(numpy.float32))
    # an all-zero tensor gets scale 1 and dequantizes to exact zeros
    zq, zs = precision.quantize_int8(torch.zeros(8, 40), axis=axis)
    assert (zs == 1).all() and not zq.any()


def test_kv_rows_equal_reference():
    rng = numpy.random.RandomState(2)
    x = rng.randn(2, 9, 4, 8).astype(numpy.float32)
    x[0, 3] = 0.0                       # an all-zero position
    x[1, 4] *= 1e5
    for dtype in ("float32", "bfloat16"):
        src = torch.from_numpy(x).to(getattr(torch, dtype))
        q_ref, s_ref = ref_precision.quantize_rows_int8(
            jax.numpy.asarray(x).astype(dtype))
        q, s = precision.quantize_rows_int8(src)
        _same(q_ref, q)
        _same(s_ref, s)
        assert tuple(s.shape) == (2, 9) and float(s[0, 3]) == 1.0
        _same(ref_precision.dequantize_rows_int8(q_ref, s_ref),
              precision.dequantize_rows_int8(q, s))
    # re-quantizing a dequantized row with its own scale is bit-exact
    q2, s2 = precision.quantize_rows_int8(precision.dequantize_rows_int8(q,
                                                                        s))
    assert torch.equal(q2, q)


def test_nan_and_inf_groups_follow_reference():
    """What both packages give for a NaN or an infinity in a group: the
    amax is NaN and ``amax > 0`` false, so a group holding a NaN gets
    scale 1, its NaN element quantizes to 0 and the rest round against
    scale 1 (an infinity there clips to ±127); a group holding only an
    infinity gets scale inf and every element 0 (finite / inf = 0,
    inf / inf = NaN → 0)."""
    w = numpy.ones((4, 3), numpy.float32)
    w[1, 0], w[2, 1], w[0, 2], w[3, 2] = numpy.nan, numpy.inf, -numpy.inf, 2
    for axis in (-1, None):
        q_ref, s_ref = ref_precision.quantize_int8(w, axis=axis)
        q, s = precision.quantize_int8(w, axis=axis)
        _same(q_ref, q)
        _same(s_ref, s)
    q, s = precision.quantize_int8(w, axis=-1)
    assert s.tolist() == [[1.0, float("inf"), float("inf")]]
    assert q[:, 0].tolist() == [1, 0, 1, 1] and not q[:, 1:].any()
    q, s = precision.quantize_int8(w, axis=None)
    assert float(s) == 1.0 and q[2, 1] == 127 and q[0, 2] == -127
    x = numpy.ones((3, 2, 2), numpy.float32)
    x[0, 0, 0], x[1, 1, 1] = numpy.nan, numpy.inf
    q_ref, s_ref = ref_precision.quantize_rows_int8(x)
    q, s = precision.quantize_rows_int8(x)
    _same(q_ref, q)
    _same(s_ref, s)


# -- parameter trees and snapshots --------------------------------------------

@pytest.fixture(scope="module")
def stacks():
    """(char_lm module, reference workflow, its parameter tree in numpy,
    the port's stack with those weights)."""
    prev = vt.root.common.engine.compute_dtype
    vt.root.common.engine.compute_dtype = "float32"
    try:
        lm = import_model("char_lm")
        ref_prng.seed_all(515)
        wf = lm.build_workflow(epochs=1, minibatch_size=64, n_blocks=2,
                               dim=32, n_train=128, n_valid=64)
        wf.initialize(device=vt.XLADevice(mesh_axes={"data": 1}))
        params = {unit: {k: numpy.asarray(v) for k, v in tree.items()}
                  for unit, tree in ref_sampling.params_of(wf).items()}
        port = params_from_jax(build_forwards(wf.layers_config,
                                              device="cpu"), params)
        yield lm, wf, params, port
    finally:
        vt.root.common.engine.compute_dtype = prev


@pytest.mark.parametrize("granularity", ["per_channel", "per_tensor"])
def test_quantize_params_equals_reference(stacks, granularity):
    _, _, params, port = stacks
    q_ref, rep_ref = ref_quant.quantize_params(params, granularity)
    q_port, rep = quant.quantize_params(
        sampling.params_of(port), granularity)
    assert rep == rep_ref and rep["params"] == 2 * 6 + 1
    assert set(q_port) == set(q_ref)
    for unit, tree in q_ref.items():
        assert set(q_port[unit]) == set(tree)
        for name, val in tree.items():
            got = q_port[unit][name]
            assert isinstance(val, dict) == isinstance(got, dict), (unit,
                                                                   name)
            if isinstance(val, dict):
                _same(val["q"], got["q"])
                _same(val["scale"], got["scale"])
    spec = quant.quantize_params_spec(sampling.params_of(port), granularity)
    for unit, tree in q_port.items():
        for name, val in tree.items():
            want = spec[unit][name]
            if isinstance(val, dict):
                assert want["q"] == (tuple(val["q"].shape), torch.int8)
                assert want["scale"].shape == tuple(val["scale"].shape)
            else:
                assert want == (tuple(val.shape), val.dtype)
    assert quant.is_quantized_params(q_port)
    assert not quant.is_quantized_params(sampling.params_of(port))
    # the reference's int8 twin carries into the port as q · s, the
    # port's own dequantized tree bit for bit, and so does the lazy view
    twin = quant.dequantize_params(q_port)
    carried = params_from_jax(build_forwards(stacks[1].layers_config,
                                             device="cpu"), q_ref)
    for unit, tree in sampling.params_of(carried).items():
        view = quant.DequantView(q_port[unit])
        for name, t in tree.items():
            assert torch.equal(t, twin[unit][name]), (unit, name)
            assert torch.equal(view[name], twin[unit][name])
    bf16 = quant.dequantize_params(q_port, dtype=torch.bfloat16)
    head = [layer for layer in port if hasattr(layer, "vocab_size")][-1]
    assert bf16[head.name]["weights"].dtype == torch.bfloat16


def _state(seed=4):
    """A snapshot state tree with every kind of entry: eligible 2-D
    float32 and float64 weights, a table, a small matrix, 1-D biases, an
    int array, a nested optimiser dict and a non-dict unit entry."""
    rng = numpy.random.RandomState(seed)
    return {"__units__": {
        "fc0": {"weights": rng.randn(40, 24).astype(numpy.float32),
                "bias": rng.randn(24).astype(numpy.float32),
                "small": rng.randn(8, 8).astype(numpy.float32),
                "opt": {"m": rng.randn(40, 24).astype(numpy.float32)}},
        "emb": {"table": rng.randn(64, 16).astype(numpy.float32)},
        "fc1": {"weights": rng.randn(24, 16),
                "count": numpy.arange(300).reshape(20, 15)},
        "note": "not a dict"},
        "__prng__": {"s": {"seed": 3}},
        "__meta__": {"checksum": "abc", "time": 1.0}}


@pytest.mark.parametrize("granularity", ["per_channel", "per_tensor"])
def test_quantize_state_equals_reference(granularity):
    state = _state()
    q_ref, rep_ref = ref_quant.quantize_state(state, granularity)
    q_port, rep = quant.quantize_state(state, granularity)
    assert rep == rep_ref and rep["params"] == 2
    assert q_port["__meta__"] == q_ref["__meta__"]
    assert q_port["__prng__"] == q_ref["__prng__"]
    for unit, sd in q_ref["__units__"].items():
        got = q_port["__units__"][unit]
        if not isinstance(sd, dict):
            assert got == sd
            continue
        for name, val in sd.items():
            if isinstance(val, dict) and "__quant__" in val:
                assert set(got[name]) == set(val)
                for key in ("__quant__", "dtype", "granularity"):
                    assert got[name][key] == val[key]
                for key in ("q", "scale"):
                    assert got[name][key].shape == val[key].shape
                    assert got[name][key].dtype == val[key].dtype
                    assert got[name][key].tobytes() == val[key].tobytes()
            else:
                assert got[name] is val
    # the input is not changed
    assert not isinstance(state["__units__"]["fc0"]["weights"], dict)


def _write_gz(state, path):
    with gzip.open(path, "wb") as fout:
        pickle.dump(state, fout, protocol=pickle.HIGHEST_PROTOCOL)
    return path


def _write_sqlite(state, path):
    con = sqlite3.connect(path)
    try:
        con.execute(SnapshotterToDB.SCHEMA)
        con.execute("INSERT INTO snapshots (prefix, suffix, created, runs, "
                    "checksum, state) VALUES (?, ?, ?, ?, ?, ?)",
                    ("q", "1", 0.0, 1, "abc", gzip.compress(
                        pickle.dumps(state, pickle.HIGHEST_PROTOCOL))))
        con.commit()
    finally:
        con.close()
    return "sqlite://" + path


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("sink", ["gz", "sqlite"])
def test_int8_snapshot_loads_across_packages(tmp_path, writer, sink):
    """A state quantized by either package loads in both to the same
    values, ``q · s``. The port restores the recorded dtype; the
    reference under JAX's default (no x64) gives a float64 record back
    as float32, the same values."""
    state = _state(5)
    quantize = (ref_quant.quantize_state if writer == "reference"
                else quant.quantize_state)
    qstate, _ = quantize(state)
    path = (_write_gz(qstate, str(tmp_path / "s.pickle.gz")) if sink == "gz"
            else _write_sqlite(qstate, str(tmp_path / "s.sqlite3")))
    a, b = ref_load_snapshot(path), load_snapshot(path)
    for unit, sd in a["__units__"].items():
        if not isinstance(sd, dict):
            continue
        for name, arr in sd.items():
            if isinstance(arr, numpy.ndarray):
                got = b["__units__"][unit][name]
                want = state["__units__"][unit][name]
                assert got.dtype == want.dtype, (unit, name)
                assert numpy.array_equal(got, arr.astype(got.dtype)), (
                    unit, name)
    w = b["__units__"]["fc1"]["weights"]
    assert w.dtype == numpy.float64
    assert numpy.abs(w - state["__units__"]["fc1"]["weights"]).max() <= \
        numpy.abs(state["__units__"]["fc1"]["weights"]).max() / 254 + 1e-6


def test_quantize_subcommands_cross(tmp_path, capsys):
    """Each package's ``quantize`` subcommand output loads in the other to
    the same arrays, and both reject a path they cannot quantize with
    exit code 1 and "quantize failed"."""
    from veles_tpu.__main__ import main as ref_main
    from veles_tpu_torch.__main__ import main
    src = _write_gz(_state(6), str(tmp_path / "w_2.pickle.gz"))
    outs = {}
    for name, entry in (("port", main), ("reference", ref_main)):
        out = str(tmp_path / ("%s.pickle.gz" % name))
        assert entry(["quantize", src, "--out", out,
                      "--granularity", "per_tensor"]) == 0
        outs[name] = out
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].startswith("quantized 2 tensor(s) (per_tensor)")
    for out in outs.values():
        a, b = ref_load_snapshot(out), load_snapshot(out)
        assert a["__meta__"]["quant"] == b["__meta__"]["quant"]
        for unit in ("fc0", "fc1"):
            for name, arr in a["__units__"][unit].items():
                if isinstance(arr, numpy.ndarray):
                    got = b["__units__"][unit][name]
                    assert numpy.array_equal(got, arr.astype(got.dtype))
    missing = str(tmp_path / "nope.pickle.gz")
    assert main(["quantize", missing]) == 1
    assert "quantize failed" in capsys.readouterr().err
    assert not os.path.exists(str(tmp_path / "nope.int8.pickle.gz"))


# -- the engines ---------------------------------------------------------------

def _prompt(lm, seed, length):
    return [int(t) for t in
            lm.make_corpus(numpy.random.RandomState(seed), length)]


def _greedy(lm):
    """Greedy requests of mixed prompt lengths, one of them a resumed
    request (3 emitted tokens folded into its prompt)."""
    reqs = [(_prompt(lm, 40 + s, 5 + 2 * s), 6) for s in range(4)]
    return reqs + [(_prompt(lm, 50, 7), 8)]


@pytest.fixture(scope="module")
def twin(stacks):
    """The port's float stack serving the dequantized int8 weights."""
    _, wf, params, port = stacks
    q, _ = quant.quantize_params(sampling.params_of(port))
    tree = {u: {k: v.numpy() for k, v in t.items()}
            for u, t in quant.dequantize_params(q).items()}
    return params_from_jax(build_forwards(wf.layers_config, device="cpu"),
                           tree)


@pytest.mark.parametrize("qw,qkv", PAIRS)
def test_int8_engines_equal_reference(stacks, twin, qw, qkv):
    """Greedy tokens of the port's int8 engine = the reference's int8
    engine's on the same weights, a resumed request included (its
    prefill re-quantizes the emitted tokens' rows from the prefill's
    K/V, in both); sampled rows concurrent = solo, and under int8
    weights alone = the float engine serving the dequantized twin."""
    lm, wf, _, port = stacks
    greedy = _greedy(lm)
    first = greedy[-1]
    ref_engine = RefEngine(wf, quant_weights=qw, quant_kv=qkv,
                           name="rq_%d%d" % (qw, qkv), **ENGINE).start()
    try:
        ref_reqs = [ref_make_request(p, n) for p, n in greedy]
        cut = ref_engine.serve([ref_reqs[-1]])[0]
        ref_reqs[-1] = ref_fold_resume(ref_reqs[-1], cut[:3])
        want = ref_engine.serve(ref_reqs)
    finally:
        ref_engine.stop()
    before = counters.snapshot()
    engine = ContinuousEngine(port, quant_weights=qw, quant_kv=qkv,
                              name="q_%d%d" % (qw, qkv), **ENGINE).start()
    try:
        reqs = [make_request(p, n) for p, n in greedy]
        assert engine.serve([reqs[-1]])[0] == cut
        reqs[-1] = fold_resume(make_request(*first), cut[:3])
        assert engine.serve(reqs) == want
        sampled = [make_request(_prompt(lm, 60 + s, 6 + s), 6,
                                temperature=0.8, seed=60 + s)
                   for s in range(3)]
        together = engine.serve(sampled)
        assert [engine.serve([r])[0] for r in sampled] == together
        st = engine.stats()
        assert (st["quant_weights"], st["quant_kv"]) == (int(qw), int(qkv))
        assert st["admitted"] == st["retired"] == len(greedy) + 7
        assert engine.page_pool.in_use() == 0
    finally:
        engine.stop()
    delta = counters.delta(before, names=quant.QUANT_COUNTERS)
    if qw:
        # calibrated once: the weights never changed while serving
        n = 2 * 6 + 1
        _, rep = ref_quant.quantize_params(stacks[2])
        assert delta == {"veles_quant_calibrations_total": 1,
                         "veles_quant_params_total": n,
                         "veles_quant_bytes_saved_total":
                             rep["bytes_before"] - rep["bytes_after"]}
        float_engine = ContinuousEngine(twin, name="qtwin", **ENGINE).start()
        try:
            assert float_engine.serve(sampled) == together
        finally:
            float_engine.stop()
    else:
        assert delta == {}


def test_quant_off_leaks_no_counters_and_pool_bytes(stacks):
    """The float engine moves no quant counter; the int8 pool holds
    payload plus scales, 2 · (pages + 1) · page_size · (KV · Dh + 4)
    bytes a block against 2 · (pages + 1) · page_size · KV · Dh · 4."""
    lm, _, _, port = stacks
    sizes = {}
    for qkv in (False, True):
        before = counters.snapshot()
        engine = ContinuousEngine(port, quant_kv=qkv, name="pool_%d" % qkv,
                                  **ENGINE).start()
        try:
            engine.serve([make_request(_prompt(lm, 9, 6), 3)])
            sizes[qkv] = engine.stats()["kv_pool_bytes"]
            rows = engine.page_pool.device_rows * engine.page_size
            assert counters.delta(before, names=quant.QUANT_COUNTERS) == {}
        finally:
            engine.stop()
    blocks = [b for b in port if hasattr(b, "n_kv_heads")]
    kv_dh = blocks[0].n_kv_heads * blocks[0].head_dim
    assert sizes[False] == len(blocks) * 2 * rows * kv_dh * 4
    assert sizes[True] == len(blocks) * 2 * rows * (kv_dh + 4)
    assert quant.pool_nbytes([quant.block_page_pool(
        5, 4, 2, 8, torch.float32, True)]) == 2 * 20 * 16 + 2 * 20 * 4


def test_calibrate_fault_degrades_then_recovers(stacks, twin, monkeypatch):
    """``quant.calibrate:raise:times=1`` fails the first tick before
    admission; the queued request is then answered, as the float engine
    on the dequantized twin answers it (``tests/test_quant.py``)."""
    from veles_tpu_torch.resilience import faults
    from veles_tpu_torch.resilience.faults import FaultInjected
    lm, _, _, port = stacks
    monkeypatch.setenv("VELES_FAULTS", "quant.calibrate:raise:times=1")
    faults.plane.configure()
    with pytest.raises(FaultInjected):
        quant.quantize_params(sampling.params_of(port))
    faults.plane.configure()
    before = counters.get("veles_faults_injected_total")
    req = make_request(_prompt(lm, 11, 6), 4)
    engine = ContinuousEngine(port, quant_weights=True, name="qfault",
                              **ENGINE).start()
    try:
        got = engine.serve([req], timeout=60)[0]
    finally:
        engine.stop()
        monkeypatch.setenv("VELES_FAULTS", "")
        faults.plane.configure()
    assert counters.get("veles_faults_injected_total") > before
    solo = ContinuousEngine(twin, name="qfault_twin", **ENGINE).start()
    try:
        assert solo.serve([req])[0] == got
    finally:
        solo.stop()


def test_window_plane_reasons_on_int8_pool(stacks):
    """Speculative and beam requests on the int8 pool ride the window
    plane with the reference's reasons; greedy and sampled stay."""
    _, wf, _, port = stacks
    ref = RefEngine(wf, quant_kv=True, draft=wf, name="rwin", **ENGINE)
    engine = ContinuousEngine(port, quant_kv=True, draft=port, name="qwin",
                              **ENGINE)
    for mode in ("speculative", "beam", "greedy", "sample"):
        kw = dict(mode=mode, temperature=0.8 if mode == "sample" else 0.0)
        why = engine.accepts(make_request([1, 2, 3], 4, **kw))
        assert why == ref.accepts(ref_make_request([1, 2, 3], 4, **kw))
        assert (why is None) == (mode in ("greedy", "sample"))
    assert "speculation rides the window plane" in engine.accepts(
        make_request([1, 2], 4, mode="speculative"))


def test_prompt_logits_params_override(stacks, twin):
    """``prompt_logits(params=)`` (the reference's override): on the
    dequantized tree it equals the twin stack's own logits bit for bit,
    and differs from the float weights' (the quantization's delta)."""
    lm, _, _, port = stacks
    q, _ = quant.quantize_params(sampling.params_of(port))
    prompt = _prompt(lm, 12, 10)
    got = sampling.prompt_logits(port, prompt,
                                 params=quant.dequantize_params(q))
    assert numpy.array_equal(got, sampling.prompt_logits(twin, prompt))
    assert numpy.abs(got - sampling.prompt_logits(port, prompt)).max() > 0


def test_generation_api_int8_metrics_and_window_fallback(stacks):
    """``GenerationAPI(quant_weights=, quant_kv=)`` hands the knobs to the
    engine: ``/metrics`` shows ``veles_quant_weights_mode`` and
    ``veles_quant_kv_mode`` 1, a greedy request is the pool's, and a beam
    request, which the int8 pool does not serve, is answered by the
    window plane with ``beam_generate``'s tokens."""
    import json
    import urllib.request
    from veles_tpu_torch.nn.beam import beam_generate
    from veles_tpu_torch.restful_api import GenerationAPI
    lm, _, _, port = stacks
    api = GenerationAPI(port, port=0, quant_weights=True, quant_kv=True,
                        device="cpu", name="qapi", **ENGINE).initialize()
    url = "http://127.0.0.1:%d" % api.port

    def post(payload):
        req = urllib.request.Request(
            url + "/generate", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    try:
        prompt = _prompt(lm, 14, 6)
        assert post({"prompt": prompt, "n_new": 4})["engine"] == \
            "continuous"
        # the pool's own width: only the int8 pool sends it away
        assert "int8 KV pool" in api._engine.accepts(
            make_request(prompt, 4, mode="beam"))
        beam = post({"prompt": prompt, "n_new": 4, "mode": "beam"})
        assert beam.get("engine") != "continuous"
        assert beam["tokens"] == beam_generate(port, prompt, 4, beam=4)[0]
        with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
            page = r.read().decode()
    finally:
        api.stop()
    assert "veles_quant_weights_mode 1" in page
    assert "veles_quant_kv_mode 1" in page

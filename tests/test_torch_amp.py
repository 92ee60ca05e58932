"""The port's mixed precision and memory knobs (nn/train_step.py, the
promotions of nn/transformer.py, nn/all2all.py and nn/attention.py,
ops/precision.py, loader/fullbatch.py ``dataset_dtype``) against the
reference's on the same data, seeds and initial weights, on the CPU.

Each of the reference's own tests of these knobs, ported at its
tolerances (tests/test_train_e2e.py, tests/test_solvers.py,
tests/test_devtime.py), run on the port and on the reference:

- ``engine.mixed_precision`` converges with float32 masters, alone and
  with ``remat``;
- ``grad_accumulation=5`` matches the direct step: per-epoch validation
  error within 0.025, weights within rtol 2e-3 / atol 2e-4 (the
  reference's); and the port's accumulated run follows the reference's
  at the float32 parity tolerances (error rates atol 1e-5, weights rtol
  2e-4 / atol 2e-5: the same f32 chunk sums in another product order);
- ``remat`` gives the same numbers bit for bit;
- ``engine.bf16_activations``: off is bit-identical, on stores an
  interlayer float32 activation as bf16 and keeps float32 masters, and
  without mixed precision it is inert;
- ``engine.dataset_dtype="bfloat16"`` stores the dataset as bf16 (a torch
  tensor: numpy has no bf16) and converges; without mixed precision the
  products widen it exactly, so the run follows the reference's at the
  float32 parity tolerances.

Mixed-precision runs follow the reference's within the rounding of two
frameworks: torch rounds every bf16 elementwise op to bf16, XLA may keep
a fused chain in float32. Per-epoch validation error rates within 0.02
(observed at most 0.0067, one row of 150) on the blobs. The slice as a whole: a small RoPE LM
(2 blocks, d 64, 4 heads, T 32) trains 2 epochs under mixed precision
from the same weights, per-epoch train and validation NLL/token within
1e-2 relative of the reference's (observed below 1e-3); so do the
RoPE-less variant, whose first block's attention takes q, k and v in
bf16, and the RoPE LM with ``bf16_activations``. The fused-FC kernel
refuses each knob with the reference's reason.
"""
import logging

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

import veles_tpu as vt
from veles_tpu import nn as ref_nn
from veles_tpu import prng as ref_prng
from veles_tpu.config import root as ref_root
from veles_tpu.loader import FullBatchLoader as RefFullBatchLoader
from veles_tpu.loader import FullBatchLoaderMSE as RefFullBatchLoaderMSE
from veles_tpu.loader import TRAIN, VALID
from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.error import Bug, VelesError
from veles_tpu_torch.loader import FullBatchLoader, FullBatchLoaderMSE
from veles_tpu_torch.models import char_lm
from veles_tpu_torch.nn.standard_workflow import StandardWorkflow
from veles_tpu_torch.ops.precision import amp_cast, dot, dot_f32

from conftest import import_model

METRIC_ATOL = 1e-5
RTOL, ATOL = 2e-4, 2e-5
#: per-epoch validation error, port vs reference under mixed precision
AMP_METRIC_ATOL = 0.02
#: per-epoch NLL/token of the LM, port vs reference under mixed precision
LM_NLL_RTOL = 1e-2

KNOBS = ("mixed_precision", "bf16_activations", "dataset_dtype",
         "fused_fc_scan", "fused_epilogue")


@pytest.fixture(autouse=True)
def _knobs():
    """Every knob this file sets, on both packages, back as it was."""
    saved = [(cfg, k, cfg.common.engine.get(k, None))
             for cfg in (root, ref_root) for k in KNOBS]
    yield
    for cfg, k, v in saved:
        setattr(cfg.common.engine, k, v)


def _e2e_blobs():
    """tests/test_train_e2e.py's BlobsLoader: 3 classes, 10 features,
    90 test / 150 validation / 600 train rows."""
    rng = numpy.random.RandomState(7)
    n_per, d, k = 280, 10, 3
    centers = rng.randn(k, d) * 3
    data = numpy.concatenate([centers[c] + rng.randn(n_per, d)
                              for c in range(k)]).astype(numpy.float32)
    labels = numpy.concatenate([numpy.full(n_per, c)
                                for c in range(k)]).astype(numpy.int32)
    perm = rng.permutation(len(data))
    return data[perm], labels[perm], [90, 150, 600]


def _solver_blobs():
    """tests/test_solvers.py's BlobsLoader: 90 validation / 270 train."""
    rng = numpy.random.RandomState(7)
    n_per, d, k = 120, 10, 3
    centers = rng.randn(k, d) * 3
    data = numpy.concatenate([centers[c] + rng.randn(n_per, d)
                              for c in range(k)])
    labels = numpy.concatenate([numpy.full(n_per, c) for c in range(k)])
    perm = rng.permutation(len(data))
    return (data[perm].astype(numpy.float32),
            labels[perm].astype(numpy.int32), [0, 90, 270])


DATA = {"e2e": _e2e_blobs, "solvers": _solver_blobs}
TANH_SOFTMAX = [{"type": "all2all_tanh", "output_sample_shape": 16},
                {"type": "softmax", "output_sample_shape": 3}]


def _loader(port, data, mb):
    def load_data(self):
        x, y, lengths = DATA[data]()
        self.create_originals(x, y)
        self.class_lengths = lengths
    base = FullBatchLoader if port else RefFullBatchLoader
    cls = type("Blobs", (base,), {"hide_from_registry": True,
                                  "load_data": load_data})
    return cls(None, minibatch_size=mb, name="blobs")


def _engine(port, **knobs):
    cfg = root if port else ref_root
    for k, v in knobs.items():
        setattr(cfg.common.engine, k, v)


def _train(port, data="e2e", layers=TANH_SOFTMAX, mb=50, epochs=12, seed=1,
           run=True, knobs=None, **kw):
    """The same StandardWorkflow on the port (CPU) or the reference, from
    one seed (the initial weights are bitwise equal), trained unless
    ``run`` is False. ``knobs``: engine config set first."""
    _engine(port, **(knobs or {}))
    (prng if port else ref_prng).seed_all(seed)
    wf_cls = StandardWorkflow if port else ref_nn.StandardWorkflow
    wf = wf_cls(name="amp", layers=layers, loader_unit=_loader(port, data, mb),
                loss_function="softmax",
                decision_config=dict(max_epochs=epochs, fail_iterations=100),
                **kw)
    if port:
        wf.initialize(device="cpu")
    else:
        wf.initialize(device=vt.XLADevice(mesh_axes={"data": 1}))
    if run:
        wf.run()
    return wf


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().cpu().numpy()
    return numpy.asarray(jax.device_get(tree)).astype(numpy.float32)


def _assert_tree_close(got, want, rtol, atol, what=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _assert_tree_close(got[k], want[k], rtol, atol,
                               "%s/%s" % (what, k))
    else:
        numpy.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                      err_msg=what)


def _assert_same_state(a, b):
    """Params and optimiser state of two port runs hold the same bits."""
    for tree in ("params", "opt_state"):
        ta, tb = getattr(a.train_step, tree), getattr(b.train_step, tree)
        assert sorted(ta) == sorted(tb)
        for name in ta:
            for k in ta[name]:
                va, vb = ta[name][k], tb[name][k]
                if isinstance(va, dict):
                    for kk in va:
                        assert torch.equal(va[kk], vb[kk]), (name, k, kk)
                else:
                    assert torch.equal(va, vb), (name, k)


def _masters_f32(wf):
    return all(t.dtype == torch.float32
               for p in wf.train_step.params.values() for t in p.values())


def _valid_close(port, ref, atol):
    numpy.testing.assert_allclose(port.decision.epoch_metrics[VALID],
                                  ref.decision.epoch_metrics[VALID],
                                  atol=atol)


# -- the reference's own tests, ported ----------------------------------------
def test_mixed_precision_converges():
    """tests/test_train_e2e.py::test_mixed_precision_converges: the AMP
    knob trains on a bf16 cast of params and batch and must converge like
    the f32 run, leaving the master params f32."""
    port = _train(True, knobs=dict(mixed_precision=True))
    assert port.train_step.mixed_precision
    d = port.decision
    assert d.best_metric is not None and d.best_metric < 0.05, \
        d.epoch_metrics
    assert _masters_f32(port)
    for state in port.train_step.opt_state.values():
        assert all(t.dtype == torch.float32 for t in state.values())
    ref = _train(False, knobs=dict(mixed_precision=True))
    _valid_close(port, ref, AMP_METRIC_ATOL)


def test_mixed_precision_composes_with_remat():
    """tests/test_train_e2e.py::test_mixed_precision_composes_with_remat:
    AMP and remat together still converge with f32 masters."""
    port = _train(True, epochs=8, seed=5, remat=True,
                  knobs=dict(mixed_precision=True))
    assert port.train_step.mixed_precision and port.train_step.remat
    d = port.decision
    assert d.best_metric is not None and d.best_metric < 0.05, \
        d.epoch_metrics
    assert _masters_f32(port)
    ref = _train(False, epochs=8, seed=5, remat=True,
                 knobs=dict(mixed_precision=True))
    _valid_close(port, ref, AMP_METRIC_ATOL)


def test_grad_accumulation_matches_direct_step():
    """tests/test_train_e2e.py::test_grad_accumulation_matches_direct_step:
    5 chunk backwards and one update from the valid-weighted mean
    gradient reproduce the direct full-minibatch step; and the port's
    accumulated run follows the reference's."""
    direct = _train(True, epochs=6, seed=321)
    accum = _train(True, epochs=6, seed=321, grad_accumulation=5)
    assert accum.train_step.grad_accumulation == 5
    numpy.testing.assert_allclose(accum.decision.epoch_metrics[VALID],
                                  direct.decision.epoch_metrics[VALID],
                                  atol=0.025)
    for name, p in accum.train_step.params.items():
        numpy.testing.assert_allclose(
            p["weights"].numpy(),
            direct.train_step.params[name]["weights"].numpy(),
            rtol=2e-3, atol=2e-4)
    ref = _train(False, epochs=6, seed=321, grad_accumulation=5)
    for cls in (TRAIN, VALID):
        numpy.testing.assert_allclose(accum.decision.epoch_metrics[cls],
                                      ref.decision.epoch_metrics[cls],
                                      atol=METRIC_ATOL)
    _assert_tree_close(_np(accum.train_step.params),
                       _np(ref.train_step.params), RTOL, ATOL)


def test_grad_accumulation_checks_the_minibatch():
    """The reference's check: the minibatch divides into G chunks."""
    with pytest.raises(Bug, match="gradient-accumulation"):
        _train(True, mb=48, run=False, grad_accumulation=5)


def test_remat_identical_numerics():
    """tests/test_solvers.py::test_remat_identical_numerics: remat
    recomputes activations in the backward — a memory knob only, the
    trajectories match exactly (here also every parameter's bits)."""
    def run(remat):
        return _train(True, data="solvers", mb=24, epochs=4, seed=99,
                      remat=remat)
    on, off = run(True), run(False)
    numpy.testing.assert_array_equal(on.decision.epoch_metrics[VALID],
                                     off.decision.epoch_metrics[VALID])
    _assert_same_state(on, off)


def _bf16_train(amp=False, bf16=False):
    """tests/test_devtime.py's ``_train``: a tiny chain, two epochs."""
    return _train(True, data="solvers", mb=40, epochs=2, seed=1234,
                  knobs=dict(mixed_precision=amp, bf16_activations=bf16))


def test_bf16_activations_off_bit_identical_on_stores_bf16():
    """tests/test_devtime.py::test_bf16_activations_off_bit_identical_on_
    stores_bf16: off is bit-identical; on, an interlayer activation that
    leaves a unit float32 reaches the next unit as bf16; masters stay
    f32."""
    _assert_same_state(_bf16_train(amp=True), _bf16_train(amp=True,
                                                          bf16=False))
    wf = _bf16_train(amp=True, bf16=True)
    ts = wf.train_step
    assert ts._bf16_acts
    seen = {}

    class Probe:
        def __init__(self, inner, f32=False):
            self.inner, self.f32 = inner, f32
            self.name = inner.name

        def apply(self, p, x):
            seen.setdefault(self.name, x.dtype)
            out = self.inner.apply(p, x)
            return out.float() if self.f32 else out

    first, head = ts.forwards
    # the first unit forced to leave float32; the head (not the softmax
    # class, so its apply runs) records what it receives
    ts.forwards = [Probe(first, f32=True), Probe(head)]
    x = torch.from_numpy(numpy.random.RandomState(0).randn(4, 10)).to(
        torch.bfloat16)
    ts._forward(amp_cast(ts.params), x)
    assert seen[head.name] == torch.bfloat16     # the knob's cast fired
    assert _masters_f32(wf)


def test_bf16_activations_without_amp_is_inert(caplog):
    """tests/test_devtime.py::test_bf16_activations_without_amp_is_inert,
    with the reference's warning."""
    with caplog.at_level(logging.WARNING):
        wf = _bf16_train(bf16=True)
    assert not wf.train_step._bf16_acts
    assert any("bf16_activations needs" in r.getMessage()
               for r in caplog.records)
    _assert_same_state(_bf16_train(), wf)


def test_bf16_dataset_storage_converges():
    """tests/test_train_e2e.py::test_bf16_dataset_storage_converges:
    engine.dataset_dtype="bfloat16" stores the dataset at half width and
    still converges; the stored dtype is the reference's."""
    port = _train(True, seed=6, knobs=dict(dataset_dtype="bfloat16"))
    assert port.loader.original_data.mem.dtype == torch.bfloat16
    assert port.loader.original_labels.mem.dtype == numpy.int32
    assert port.decision.best_metric < 0.06, port.decision.epoch_metrics
    ref = _train(False, seed=6, knobs=dict(dataset_dtype="bfloat16"))
    assert ref.loader.original_data.mem.dtype == jnp.bfloat16
    numpy.testing.assert_array_equal(
        port.loader.original_data.mem.float().numpy(),
        numpy.asarray(ref.loader.original_data.mem).astype(numpy.float32))
    # no mixed precision: the bf16 rows widen exactly into f32 products
    for cls in (TRAIN, VALID):
        numpy.testing.assert_allclose(port.decision.epoch_metrics[cls],
                                      ref.decision.epoch_metrics[cls],
                                      atol=METRIC_ATOL)
    _assert_tree_close(_np(port.train_step.params),
                       _np(ref.train_step.params), RTOL, ATOL)


def test_fused_fc_takes_a_bf16_dataset():
    """The fused-FC route on a bf16 dataset widens it, as the reference's
    fused path casts it: the same trajectory as the reference's Pallas
    kernel (interpret mode) at the float32 parity tolerances."""
    knobs = dict(fused_fc_scan=True, dataset_dtype="bfloat16")
    kw = dict(data="solvers", mb=30, epochs=2, seed=8, knobs=knobs,
              epochs_per_dispatch=2)
    port, ref = _train(True, **kw), _train(False, **kw)
    assert port.train_step._fused_fc_active
    assert ref.train_step._fused_fc is not None
    assert port.loader.original_data.mem.dtype == torch.bfloat16
    for cls in (TRAIN, VALID):
        numpy.testing.assert_allclose(port.decision.epoch_metrics[cls],
                                      ref.decision.epoch_metrics[cls],
                                      atol=METRIC_ATOL)
    _assert_tree_close(_np(port.train_step.params),
                       _np(ref.train_step.params), RTOL, ATOL)


@pytest.mark.parametrize("dataset_dtype", [None, "bfloat16"])
def test_storage_dtypes_match_the_reference(dataset_dtype):
    """``_storage_dtype``: ids keep their dtype; float data and float MSE
    targets take ``dataset_dtype`` when set, else float32 — as the
    reference stores them; the minibatch buffers take the same dtype."""
    data = numpy.random.RandomState(3).randn(12, 5)            # float64
    ids = numpy.arange(24, dtype=numpy.int64).reshape(12, 2)
    targets = numpy.random.RandomState(4).rand(12, 3)

    def load(self):
        self.create_originals(data, None, targets=targets)
        self.class_lengths = [0, 4, 8]

    def load_ids(self):
        self.create_originals(ids, None, targets=ids + 1)
        self.class_lengths = [0, 4, 8]

    got = {}
    for port in (True, False):
        _engine(port, dataset_dtype=dataset_dtype)
        base = FullBatchLoaderMSE if port else RefFullBatchLoaderMSE
        for name, fn in (("floats", load), ("ids", load_ids)):
            cls = type("L", (base,), {"hide_from_registry": True,
                                      "load_data": fn})
            loader = cls(None, minibatch_size=4, name="l")
            loader.load_data()
            got[(port, name)] = [str(a.mem.dtype).replace("torch.", "")
                                 for a in (loader.original_data,
                                           loader.original_targets)]
            if port:
                loader.create_minibatch_data()
                assert loader.minibatch_data.dtype == \
                    loader.original_data.dtype
    for name in ("floats", "ids"):
        assert got[(True, name)] == got[(False, name)], (name, got)
    want = dataset_dtype or "float32"
    assert got[(True, "floats")] == [want, want]
    assert got[(True, "ids")] == ["int64", "int64"]


# -- the slice as a whole: the RoPE LM under mixed precision -------------------
@pytest.fixture(scope="module")
def ref_lm():
    return import_model("char_lm")


LM_VARIANTS = {
    # name: (rope, bf16_activations)
    "rope": (True, False),
    "norope": (False, False),
    "rope_bf16_activations": (True, True),
}


def _lm(port, ref_lm, rope, epochs=2):
    """2 blocks, d 64, 4 heads, FFN 128, T 32 on the reference's grammar,
    adam lr 3e-3, mb 8, 96 / 32 rows; built, not initialised."""
    mod = char_lm if port else ref_lm
    loader = mod.CharLMLoader(None, n_train=96, n_valid=32,
                              minibatch_size=8, name="chars")
    layers = ([{"type": "embedding", "vocab_size": mod.VOCAB, "dim": 64,
                "solver": "adam", "learning_rate": 3e-3}]
              + [{"type": "transformer_block", "n_heads": 4,
                  "ffn_hidden": 128, "causal": True, "rope": rope,
                  "solver": "adam", "learning_rate": 3e-3,
                  "name": "blk%d" % i} for i in range(2)]
              + [{"type": "lm_head", "vocab_size": mod.VOCAB,
                  "solver": "adam", "learning_rate": 3e-3}])
    wf_cls = StandardWorkflow if port else ref_nn.StandardWorkflow
    return wf_cls(name="lm-amp", layers=layers, loader_unit=loader,
                  loss_function="softmax_seq",
                  decision_config=dict(max_epochs=epochs,
                                       fail_iterations=50))


def _record_losses(decision):
    """Per-epoch mean loss of each set, from the sums the decision
    drains (the reference's decision keeps only the error rates)."""
    losses, sums = {TRAIN: [], VALID: []}, {}
    accumulate, finish = decision.accumulate, decision._finish_epoch

    def spy_accumulate(set_idx, metrics):
        acc = sums.setdefault(set_idx, [0.0, 0.0])
        acc[0] += float(metrics.get("sum_loss", 0.0))
        acc[1] += float(metrics.get("n_samples", 0.0))
        return accumulate(set_idx, metrics)

    def spy_finish():
        for set_idx, (loss, n) in sums.items():
            if n and set_idx in losses:
                losses[set_idx].append(loss / n)
        sums.clear()
        return finish()
    decision.accumulate, decision._finish_epoch = spy_accumulate, spy_finish
    return losses


@pytest.mark.parametrize("variant", sorted(LM_VARIANTS))
def test_lm_under_mixed_precision_follows_the_reference(ref_lm, variant):
    rope, bf16 = LM_VARIANTS[variant]
    runs, losses = {}, {}
    for port in (False, True):
        _engine(port, mixed_precision=True, bf16_activations=bf16)
        (prng if port else ref_prng).seed_all(2024)
        wf = _lm(port, ref_lm, rope)
        if port:
            wf.initialize(device="cpu")
        else:
            wf.initialize(device=vt.XLADevice(mesh_axes={"data": 1}))
        losses[port] = _record_losses(wf.decision)
        wf.run()
        runs[port] = wf
    port = runs[True]
    assert port.train_step.mixed_precision and _masters_f32(port)
    assert port.train_step._bf16_acts == bf16
    for cls in (TRAIN, VALID):
        got = numpy.asarray(losses[True][cls])
        want = numpy.asarray(losses[False][cls])
        assert got.shape == want.shape == (2,)
        assert numpy.isfinite(got).all()
        numpy.testing.assert_allclose(got, want, rtol=LM_NLL_RTOL,
                                      err_msg="set %d" % cls)


def test_block_dtypes_follow_the_reference(monkeypatch):
    """What reaches attention under mixed precision, as the reference's
    dtype promotion makes it: the first RoPE block q, k float32 and v
    bf16 (RoPE's float32 tables), later blocks float32; without RoPE
    the first block bf16 throughout."""
    from veles_tpu_torch.nn import attention, transformer
    for rope, want in ((True, ["f32,f32,bf16", "f32,f32,f32"]),
                       (False, ["bf16,bf16,bf16", "f32,f32,f32"])):
        _engine(True, mixed_precision=True)
        prng.seed_all(1)
        wf = _lm(True, None, rope, epochs=1)
        wf.initialize(device="cpu")
        seen = []
        real = attention.attention_core

        def spy(q, k, v, **kw):
            seen.append(",".join({torch.float32: "f32",
                                  torch.bfloat16: "bf16"}[x.dtype]
                                 for x in (q, k, v)))
            return real(q, k, v, **kw)
        monkeypatch.setattr(transformer, "attention_core", spy)
        step = wf.train_step
        dataset, targets = step._dataset()
        step._eval_step(step.params, step._zero_accum(), dataset, targets,
                        torch.arange(8, dtype=torch.int32), torch.ones(8))
        assert seen == want, (rope, seen)


# -- knobs and refusals --------------------------------------------------------
@pytest.mark.parametrize("knob", ["mixed_precision", "remat",
                                  "grad_accumulation"])
def test_fused_fc_refuses_each_knob(knob, caplog):
    """The fused-FC kernel takes none of the knobs, with the reference's
    reason, as the reference refuses them."""
    kw = {"remat": dict(remat=True),
          "grad_accumulation": dict(grad_accumulation=2)}.get(knob, {})
    knobs = dict(fused_fc_scan=True,
                 mixed_precision=knob == "mixed_precision")
    with caplog.at_level(logging.INFO):
        port = _train(True, mb=50, run=False, knobs=knobs, **kw)
        ref = _train(False, mb=50, run=False, knobs=knobs, **kw)
    assert port.train_step._fused_fc is None
    assert ref.train_step._fused_fc is None
    assert any("amp/remat/grad-accumulation not fused" in r.getMessage()
               and r.name != "jax" for r in caplog.records)
    # without the knob the same chain takes the kernel
    _engine(True, mixed_precision=False)
    assert _train(True, mb=50, run=False,
                  knobs=dict(fused_fc_scan=True)).train_step._fused_fc


def test_unported_knobs_still_raise():
    """Pipeline microbatches name their ROADMAP item (10) in TrainStep
    and in StandardWorkflow; the streaming loaders, asked for through the
    loader registry, name theirs (12). ``engine.fused_epilogue`` is
    ported: it trains (tests/test_torch_lora.py holds its bits)."""
    _train(True, run=False, knobs=dict(fused_epilogue=True))
    _engine(True, fused_epilogue=False)
    from veles_tpu_torch.loader import loader_class
    from veles_tpu_torch.nn.standard_workflow import StandardWorkflow
    from veles_tpu_torch.nn.train_step import TrainStep
    with pytest.raises(VelesError, match=r"pipeline microbatches .*item 10"):
        TrainStep(None, pipeline_microbatches=4)
    with pytest.raises(VelesError, match=r"pipeline_microbatches.*item 10"):
        StandardWorkflow(pipeline_microbatches=4)
    with pytest.raises(VelesError, match="item 12"):
        loader_class("restful_loader")


def test_precision_helpers():
    """``amp_cast`` casts float32 leaves only, and autograd through it
    gives float32 gradients; ``dot`` promotes a mixed pair as ``jnp.dot``
    does; ``dot_f32`` sums bf16 operands into a float32 result, as
    ``preferred_element_type`` does."""
    w = torch.randn(3, 4, requires_grad=True)
    tree = amp_cast({"a": {"w": w, "ids": torch.arange(3)}})
    assert tree["a"]["w"].dtype == torch.bfloat16
    assert tree["a"]["ids"].dtype == torch.int64
    tree["a"]["w"].float().sum().backward()
    assert w.grad.dtype == torch.float32
    x = torch.randn(2, 3)
    wb = torch.randn(3, 4).to(torch.bfloat16)
    assert dot(x, wb).dtype == torch.float32
    assert dot(x.bfloat16(), wb).dtype == torch.bfloat16
    want = jnp.dot(jnp.asarray(x.bfloat16().float().numpy()).astype(
        jnp.bfloat16), jnp.asarray(wb.float().numpy()).astype(jnp.bfloat16),
        preferred_element_type=jnp.float32)
    got = dot_f32(x.bfloat16(), wb)
    assert got.dtype == torch.float32
    numpy.testing.assert_allclose(got.numpy(), numpy.asarray(want),
                                  rtol=1e-6, atol=1e-6)

"""The rest of the Znicz layer set in the port (veles_tpu_torch/nn/:
normalization.py, dropout.py, pooling.py's StochasticPooling, cutter.py,
channel_split.py, zerofill.py, image_saver.py; nn_units.py's adagrad,
rmsprop, adadelta and clipping; train_step.py's per-layer generators and
parameter masks) against the reference's units on the same inputs, made
from a seed with numpy, on the CPU.

Tolerances:

- LRN and the cutter, forward and the gradients of sum(y · g) for a
  random cotangent g (``jax.grad`` against autograd): max abs error
  <= 1e-5 · max(1, max|ref|) in float32 (both sum float32 terms, in
  another order); LRN on bf16 inputs returns bf16 within 2^-7 of it
  (one bf16 ulp of the largest element);
- the solvers and clipping knobs, 5 updates from the same gradients:
  rtol 1e-6 / atol 1e-9, as tests/test_torch_lm_train.py holds adam;
  with ``gradient_clip_norm`` atol 1e-8: the layer's sum of squares runs
  in another order, so its scale factor may lie an ulp apart, and a
  gradient of ~0.03 then moves by ~2e-9;
- channel split/merge, the zero-filler's masks and max pooling in
  evaluation: exact.

The random units cannot match the reference's threefry bits, so their
oracles are the semantics: evaluation equals the identity (dropout) or
max pooling (stochastic pooling) exactly, in both packages; a seed gives
the same draws twice, under ``remat`` too; dropout keeps 0.7 of 10^6
elements within 0.002 (in both packages), each kept element equal to
x/keep; stochastic pooling picks an element of its window, never a
padded one, with probability ∝ exp(x) (a window of (0, ln 3) picks
ln 3 0.75 ± 0.01 of 40,000 times, in both packages), and its gradient
reaches the picked elements only.
"""
import os

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

import veles_tpu as vt
from veles_tpu import nn as ref_nn
from veles_tpu import prng as ref_prng
from veles_tpu.error import VelesError as RefVelesError
from veles_tpu.loader import FullBatchLoader as RefFullBatchLoader
from veles_tpu.memory import Array as RefArray
from veles_tpu_torch import prng, snapshotter
from veles_tpu_torch.config import root
from veles_tpu_torch.error import VelesError
from veles_tpu_torch.loader import FullBatchLoader
from veles_tpu_torch.memory import Array
from veles_tpu_torch.nn import all2all, channel_split, cutter, dropout
from veles_tpu_torch.nn import image_saver, normalization, pooling, zerofill
from veles_tpu_torch.nn.standard_workflow import StandardWorkflow
from veles_tpu_torch.telemetry import counters
from veles_tpu_torch.units import UnitRegistry
from veles_tpu_torch.workflow import Workflow

TOL = 1e-5
TOL_BF16 = 2.0 ** -7
RTOL_SOLVER, ATOL_SOLVER = 1e-6, 1e-9
ATOL_CLIP_NORM = 1e-8


def grads_both(ref_fn, port_fn, x, seed, dtype="float32"):
    """y and dx of sum(y · g) through the reference's function (jax) and
    the port's (torch), as float32 numpy dicts."""
    y_shape = jax.eval_shape(ref_fn, jnp.asarray(x)).shape
    g = numpy.random.RandomState(seed).randn(*y_shape).astype(numpy.float32)

    def loss(xx):
        y = ref_fn(xx)
        return jnp.sum(y.astype(jnp.float32) * g), y
    (_, y), dx = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(x).astype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    ty = port_fn(tx)
    assert ty.dtype == tx.dtype
    (ty.float() * torch.from_numpy(g)).sum().backward()
    ref = {"y": numpy.asarray(y.astype(jnp.float32)),
           "dx": numpy.asarray(dx.astype(jnp.float32))}
    port = {"y": ty.detach().float().numpy(), "dx": tx.grad.float().numpy()}
    return ref, port


def assert_close(ref, port, tol):
    for k, want in ref.items():
        got = port[k]
        assert got.shape == want.shape, k
        scale = max(1.0, float(numpy.abs(want).max()))
        err = float(numpy.abs(got - want).max())
        assert err <= tol * scale, (k, err, scale)


def test_units_register_the_reference_names():
    for name in ("dropout", "norm", "stochastic_pooling", "cutter",
                 "channel_splitter", "channel_merger", "zero_filler",
                 "image_saver", "kohonen_forward", "kohonen_trainer", "rbm",
                 "rbm_trainer"):
        cls = UnitRegistry.mapping[name]
        assert cls.MAPPING == name
        assert cls.__name__ == vt.units.UnitRegistry.mapping[name].__name__


@pytest.mark.parametrize("n,channels,dtype", [
    (5, 7, "float32"), (3, 5, "float32"), (4, 9, "float32"),
    (5, 3, "float32"), (5, 11, "bfloat16")])
def test_lrn_matches_reference(n, channels, dtype):
    x = numpy.random.RandomState(n + channels).randn(
        2, 5, 4, channels).astype(numpy.float32) * 3
    kw = dict(alpha=1e-3, beta=0.75, n=n, k=2.0)
    ref = ref_nn.LRNormalizerForward(None, name="u", **kw)
    port = normalization.LRNormalizerForward(None, name="u", **kw)
    want, got = grads_both(lambda xx: ref.apply({}, xx),
                           lambda xx: port.apply({}, xx), x, n, dtype)
    assert_close(want, got, TOL if dtype == "float32" else TOL_BF16)
    if dtype == "float32":
        numpy.testing.assert_allclose(got["y"], ref.numpy_apply({}, x),
                                      rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("padding,shape", [
    ((2, 1, 1, 2), (2, 6, 8, 3)), ((0, 0, 3, 0), (1, 5, 7, 4)),
    ((1, 1, 1, 1), (3, 4, 4, 1))])
def test_cutter_matches_reference(padding, shape):
    x = numpy.random.RandomState(1).randn(*shape).astype(numpy.float32)
    ref = ref_nn.Cutter(None, name="u", padding=padding)
    port = cutter.Cutter(None, name="u", padding=padding)
    want, got = grads_both(lambda xx: ref.apply({}, xx),
                           lambda xx: port.apply({}, xx), x, 2)
    assert_close(want, got, TOL)
    assert got["y"].shape == port.output_shape_for(shape) \
        == ref.output_shape_for(shape)
    numpy.testing.assert_array_equal(got["y"], ref.numpy_apply({}, x))


def test_cutter_validates():
    for bad in ((1, 2, 3), (-1, 0, 0, 0)):
        with pytest.raises(ValueError):
            cutter.Cutter(None, padding=bad)
    with pytest.raises(ValueError, match="consumes"):
        cutter.Cutter(None, padding=(4, 0, 4, 0)).output_shape_for(
            (1, 6, 8, 3))


def _run_unit(u, x):
    u.input = Array(x)
    assert u.initialize(device="cpu") is None
    u.run()
    return u


def test_channel_splitter_groups():
    x = numpy.random.RandomState(0).rand(3, 4, 4, 6).astype(numpy.float32)
    wf = Workflow(name="t")
    u = _run_unit(channel_split.ChannelSplitter(wf, groups=3), x)
    ref = ref_nn.ChannelSplitter(vt.Workflow(name="r"), groups=3)
    ref.input = RefArray(x)
    ref.initialize(device=vt.XLADevice(mesh_axes={"data": 1}))
    ref.numpy_run()
    assert len(u.outputs) == len(ref.outputs) == 3
    for got, want in zip(u.outputs, ref.outputs):
        numpy.testing.assert_array_equal(got.map_read(), want.map_read())
    numpy.testing.assert_array_equal(
        u.apply({}, torch.from_numpy(x)).numpy(), x[..., :2])


def test_channel_split_merge_roundtrip():
    x = numpy.random.RandomState(1).rand(2, 3, 3, 4).astype(numpy.float32)
    wf = Workflow(name="t")
    split = _run_unit(channel_split.ChannelSplitter(wf, sizes=(1, 3)), x)
    assert [o.shape[-1] for o in split.outputs] == [1, 3]
    merge = channel_split.ChannelMerger(wf, inputs=split.outputs)
    assert merge.initialize(device="cpu") is None
    merge.run()
    numpy.testing.assert_array_equal(merge.output.map_read(), x)


def test_channel_splitter_validates():
    for port_cls, err in ((channel_split.ChannelSplitter, VelesError),
                          (ref_nn.ChannelSplitter, RefVelesError)):
        with pytest.raises(err, match="exactly one"):
            port_cls(None)
        with pytest.raises(err, match="not divisible"):
            port_cls(None, groups=4).output_shape_for((1, 2, 2, 6))
        with pytest.raises(err, match="channels"):
            port_cls(None, sizes=(2, 3)).output_shape_for((1, 2, 2, 6))
    merge = channel_split.ChannelMerger(Workflow(name="t"))
    assert merge.verify_demands() == ["inputs"]
    assert merge.initialize(device="cpu") is True


def test_dropout_eval_is_identity():
    x = torch.randn(4, 10)
    port = dropout.DropoutForward(None, dropout_ratio=0.3)
    ref = ref_nn.DropoutForward(None, dropout_ratio=0.3)
    assert port.apply({}, x) is x
    assert port.apply({}, x, train=False,
                      generator=torch.Generator().manual_seed(1)) is x
    assert port.apply({}, x, train=True, generator=None) is x
    xj = jnp.asarray(x.numpy())
    assert ref.apply({}, xj, train=False, rng=jax.random.PRNGKey(0)) is xj


def test_dropout_train_share_and_scale():
    keep = 0.7
    x = torch.from_numpy(numpy.random.RandomState(3).rand(1000, 1000)
                         .astype(numpy.float32) + 0.5)
    port = dropout.DropoutForward(None, dropout_ratio=1 - keep)
    y = port.apply({}, x, train=True,
                   generator=torch.Generator().manual_seed(11))
    again = port.apply({}, x, train=True,
                       generator=torch.Generator().manual_seed(11))
    other = port.apply({}, x, train=True,
                       generator=torch.Generator().manual_seed(12))
    assert torch.equal(y, again) and not torch.equal(y, other)
    kept = y != 0
    assert abs(float(kept.float().mean()) - keep) <= 0.002
    assert torch.equal(y[kept], x[kept] / keep)
    ref = ref_nn.DropoutForward(None, dropout_ratio=1 - keep)
    yj = numpy.asarray(ref.apply({}, jnp.asarray(x.numpy()), train=True,
                                 rng=jax.random.PRNGKey(5)))
    assert abs(float((yj != 0).mean()) - keep) <= 0.002


def _windows(x, k, s):
    """Every (ky·kx) window of NHWC ``x`` at stride ``s`` in the
    reference's ceil mode (−inf past the edge), as (B, OH, OW, k·k, C)."""
    b, h, w, c = x.shape
    oh = -(-(h - k) // s) + 1
    ow = -(-(w - k) // s) + 1
    xp = numpy.full((b, (oh - 1) * s + k, (ow - 1) * s + k, c), -numpy.inf,
                    dtype=numpy.float32)
    xp[:, :h, :w] = x
    out = numpy.empty((b, oh, ow, k * k, c), dtype=numpy.float32)
    for i in range(oh):
        for j in range(ow):
            out[:, i, j] = xp[:, i * s:i * s + k, j * s:j * s + k].reshape(
                b, k * k, c)
    return out


def test_stochastic_pooling_eval_is_max_pooling():
    x = numpy.random.RandomState(4).randn(2, 7, 9, 3).astype(numpy.float32)
    kw = dict(kx=3, ky=3, sliding=(2, 2))
    port = pooling.StochasticPooling(None, **kw)
    ref = ref_nn.StochasticPooling(None, **kw)
    want = numpy.asarray(ref.apply({}, jnp.asarray(x), train=False))
    got = port.apply({}, torch.from_numpy(x))
    numpy.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, pooling.MaxPooling(None, **kw).apply(
        {}, torch.from_numpy(x)))
    assert torch.equal(port.apply({}, torch.from_numpy(x), train=True,
                                  generator=None), got)


def test_stochastic_pooling_picks_from_its_window():
    """Ceil-mode windows with a padded edge: every pick is a finite
    element of its window, a seed repeats its picks, and the gradient of
    sum(y) is one at each picked element and zero elsewhere."""
    x = numpy.random.RandomState(5).randn(3, 7, 9, 4).astype(numpy.float32)
    port = pooling.StochasticPooling(None, kx=2, ky=2)
    tx = torch.from_numpy(x).requires_grad_(True)
    y = port.apply({}, tx, train=True,
                   generator=torch.Generator().manual_seed(3))
    again = port.apply({}, tx, train=True,
                       generator=torch.Generator().manual_seed(3))
    assert torch.equal(y, again)
    assert tuple(y.shape) == port.output_shape_for(x.shape)
    wins = _windows(x, 2, 2)
    picked = y.detach().numpy()
    assert numpy.isfinite(picked).all()
    assert (wins == picked[:, :, :, None, :]).any(axis=3).all()
    y.sum().backward()
    g = tx.grad.numpy()
    assert g.sum() == picked.size and set(numpy.unique(g)) <= {0.0, 1.0}
    assert numpy.array_equal(numpy.sort(x[g == 1]), numpy.sort(
        picked.ravel()))


def test_stochastic_pooling_probability_follows_exp():
    n = 40000
    row = numpy.tile(numpy.array([0.0, numpy.log(3.0)], numpy.float32), n)
    x = row.reshape(1, 1, 2 * n, 1)
    port = pooling.StochasticPooling(None, kx=2, ky=1, sliding=(2, 1))
    y = port.apply({}, torch.from_numpy(x), train=True,
                   generator=torch.Generator().manual_seed(9)).numpy()
    assert y.shape == (1, 1, n, 1)
    assert abs(float((y > 0).mean()) - 0.75) <= 0.01
    ref = ref_nn.StochasticPooling(None, kx=2, ky=1, sliding=(2, 1))
    yj = numpy.asarray(ref.apply({}, jnp.asarray(x), train=True,
                                 rng=jax.random.PRNGKey(2)))
    assert abs(float((yj > 0).mean()) - 0.75) <= 0.01


# -- solvers and clipping -------------------------------------------------

SOLVER_CASES = [
    ("adagrad", {}), ("adagrad", dict(weights_decay=0.01)),
    ("rmsprop", {}), ("rmsprop", dict(rho=0.9, weights_decay=0.01,
                                      learning_rate_bias=0.02)),
    ("adadelta", {}), ("adadelta", dict(rho=0.9, epsilon=1e-6,
                                        weights_decay_bias=0.005)),
    ("sgd", dict(gradient_clip=0.5, gradient_moment=0.9)),
    ("sgd", dict(gradient_clip_norm=1.5)),
    ("adam", dict(gradient_clip_norm=0.8, gradient_clip=0.1)),
    ("adagrad", dict(gradient_clip=0.3)),
    ("rmsprop", dict(gradient_clip_norm=2.0)),
]


def _tree(t):
    if isinstance(t, dict):
        return {k: _tree(v) for k, v in t.items()}
    if isinstance(t, tuple):
        return tuple(_tree(v) for v in t)
    return numpy.asarray(t.numpy() if isinstance(t, torch.Tensor) else t)


@pytest.mark.parametrize("solver,kw", SOLVER_CASES,
                         ids=["%s-%d" % (s, i)
                              for i, (s, _) in enumerate(SOLVER_CASES)])
def test_solver_matches_reference(solver, kw):
    rng = numpy.random.RandomState(len(kw) + len(solver))
    params = {"weights": rng.randn(6, 5).astype(numpy.float32),
              "bias": rng.randn(5).astype(numpy.float32)}
    ref = ref_nn.all2all.GradientDescent(vt.Workflow(name="r"),
                                         solver=solver, learning_rate=0.05,
                                         **kw)
    port = all2all.GradientDescent(Workflow(name="p"), solver=solver,
                                   learning_rate=0.05, **kw)
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    rs, ps = ref.init_state(rp), port.init_state(pp)
    assert jax.tree_util.tree_structure(_tree(ps)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(
            numpy.asarray, rs))
    for step in range(5):
        grads = {k: rng.randn(*v.shape).astype(numpy.float32) * (1 + step)
                 for k, v in params.items()}
        scale = numpy.float32(1.0 - step / 10)
        rp, rs = ref.update(rp, {k: jnp.asarray(g) for k, g in
                                 grads.items()}, rs, scale)
        pp, ps = port.update(pp, {k: torch.from_numpy(g)
                                  for k, g in grads.items()}, ps,
                             float(scale))
        want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
            numpy.asarray, (rp, rs)))
        got = jax.tree_util.tree_leaves(_tree((pp, ps)))
        assert len(want) == len(got)
        atol = ATOL_CLIP_NORM if "gradient_clip_norm" in kw else ATOL_SOLVER
        for w, g in zip(want, got):
            numpy.testing.assert_allclose(g, w, rtol=RTOL_SOLVER, atol=atol)


def test_gradient_clip_norm_scales_the_layer_jointly():
    gd = all2all.GradientDescent(Workflow(name="p"), gradient_clip_norm=1.0)
    g = {"weights": torch.full((3, 4), 1.0), "bias": torch.full((4,), 1.0)}
    out = gd.clipped(g)
    norm = float(torch.sqrt(sum((v * v).sum() for v in out.values())))
    assert abs(norm - 1.0) < 1e-6
    small = {k: v * 1e-3 for k, v in g.items()}
    assert all(torch.equal(gd.clipped(small)[k], small[k]) for k in small)


# -- TrainStep: random units, masks and the fused route ------------------

def _blobs(self):
    rng = numpy.random.RandomState(7)
    n = 240
    y = rng.randint(0, 3, n).astype(numpy.int32)
    x = (rng.randn(n, 10) * 0.5 + numpy.eye(3, 10)[y] * 2).astype(
        numpy.float32)
    self.create_originals(x, y)
    self.class_lengths = [0, 40, 200]


Blobs = type("Blobs", (FullBatchLoader,), {"hide_from_registry": True,
                                           "load_data": _blobs})
RefBlobs = type("RefBlobs", (RefFullBatchLoader,),
                {"hide_from_registry": True, "load_data": _blobs})

DROPOUT_NET = [{"type": "all2all_tanh", "output_sample_shape": 16,
                "learning_rate": 0.1},
               {"type": "dropout", "dropout_ratio": 0.4},
               {"type": "softmax", "output_sample_shape": 3,
                "learning_rate": 0.1}]


def _port_wf(layers, epochs=2, seed=1234, **kw):
    with prng._lock:
        prng._generators.clear()
    prng.seed_all(seed)
    wf = StandardWorkflow(
        name="znicz", layers=layers,
        loader_unit=Blobs(None, minibatch_size=20, name="blobs"),
        loss_function="softmax",
        decision_config=dict(max_epochs=epochs, fail_iterations=99), **kw)
    wf.initialize(device="cpu")
    return wf


def test_dropout_net_trains_deterministically():
    """The same seed twice: identical weights; another seed: others;
    the validation pass draws nothing (its error equals the network's
    without the dropout layer on the trained weights)."""
    runs = []
    for seed in (1234, 1234, 99):
        wf = _port_wf(DROPOUT_NET, seed=seed)
        wf.run()
        runs.append(wf)
    a, b, c = (r.train_step.params for r in runs)
    for name in a:
        for k in a[name]:
            assert torch.equal(a[name][k], b[name][k])
    assert any(not torch.equal(a[n][k], c[n][k]) for n in a for k in a[n]
               if a[n][k].shape == c[n][k].shape)
    wf = runs[0]
    assert wf.train_step.rng_step == 2 * 10
    assert wf.decision.epoch_metrics[1][-1] < 0.5


def test_dropout_draws_equal_under_remat():
    """A step with ``remat`` recomputes the forward and redraws the same
    mask: loss and gradients bit-identical to the step without it."""
    plain = _port_wf(DROPOUT_NET)
    ts = plain.train_step
    dataset, targets = ts._dataset()
    idx = torch.arange(40, 60, dtype=torch.int32)
    mask = torch.ones(20)
    outs = []
    for remat in (False, True):
        ts.remat = remat
        batch, tgt = dataset[idx.long()], targets[idx.long()]
        outs.append(ts._grads(ts.params, batch, tgt, mask,
                              ts._rng_key(7)))
    (l0, o0, g0), (l1, o1, g1) = outs
    assert torch.equal(l0, l1) and torch.equal(o0, o1)
    for n in g0:
        for k in g0[n]:
            assert torch.equal(g0[n][k], g1[n][k]), (n, k)
    # another step number draws another mask
    l2, _, _ = ts._grads(ts.params, batch, tgt, mask, ts._rng_key(8))
    assert not torch.equal(l0, l2)


def test_zero_filler_matches_reference_mask():
    for shape, groups in (((6, 4), 2), ((9, 12), 3)):
        numpy.testing.assert_array_equal(
            zerofill.ZeroFiller.grouping_mask(shape, groups),
            ref_nn.ZeroFiller.grouping_mask(shape, groups))
    with pytest.raises(VelesError, match="divisible"):
        zerofill.ZeroFiller.grouping_mask((5, 4), 2)


def test_zero_filler_masks_weights():
    wf = Workflow(name="t")
    fc = all2all.All2All(wf, output_sample_shape=4, name="fc")
    fc.input = Array(numpy.random.RandomState(2).rand(5, 6)
                     .astype(numpy.float32))
    fc.initialize(device="cpu")
    zf = zerofill.ZeroFiller(wf, target=fc, grouping=2)
    assert zf.initialize() is None
    w = fc.weights.map_read()
    assert (w[:3, 2:] == 0).all() and (w[3:, :2] == 0).all()
    assert (w[:3, :2] != 0).any() and (w[3:, 2:] != 0).any()
    bad = zerofill.ZeroFiller(wf, target=fc, mask=numpy.ones((2, 2)),
                              name="bad")
    with pytest.raises(VelesError, match="mask"):
        bad.initialize()
    with pytest.raises(VelesError, match="mask= or grouping="):
        zerofill.ZeroFiller(wf, target=fc, name="none").initialize()


MASK_NET = [{"type": "all2all_tanh", "output_sample_shape": 16,
             "learning_rate": 0.1},
            {"type": "softmax", "output_sample_shape": 3,
             "learning_rate": 0.1}]


def test_zero_filler_holds_inside_a_plan():
    """The mask registered with the step holds after every update of a
    4-step plan (tests/test_nn_extras.py's anchor)."""
    mask = numpy.ones((10, 16), dtype=numpy.float32)
    mask[:, 8:] = 0.0
    port = _port_wf(MASK_NET, epochs=2, steps_per_dispatch=4)
    zf = zerofill.ZeroFiller(port, target=port.forwards[0], mask=mask)
    zf.initialize()
    assert "all2all_tanh0" in port.train_step.param_masks
    assert port.loader.plan_steps > 1
    zf.run()                        # an equal mask again: a no-op
    port.run()
    w = port.train_step.params["all2all_tanh0"]["weights"].numpy()
    assert (w[:, 8:] == 0).all() and (w[:, :8] != 0).any()
    port.train_step.sync_params_to_arrays()
    assert (port.forwards[0].weights.map_read()[:, 8:] == 0).all()


@pytest.mark.parametrize("kind", ["mask", "adam", "rmsprop", "adadelta",
                                  "clip", "clip_norm"])
def test_off_route_chains_never_take_the_fused_kernel(kind, monkeypatch):
    """A masked, non-SGD or clipped [tanh, softmax] chain keeps the
    general path in an epoch block with ``fused_fc_scan`` on: no fused
    plan, and the kernel's wrapper is never called."""
    from veles_tpu_torch.ops import fused_fc
    knob = {"adam": {"solver": "adam"}, "rmsprop": {"solver": "rmsprop"},
            "adadelta": {"solver": "adadelta"},
            "clip": {"gradient_clip": 0.5},
            "clip_norm": {"gradient_clip_norm": 1.0}}.get(kind, {})
    layers = [dict(cfg, **knob) for cfg in MASK_NET]
    calls = []
    monkeypatch.setattr(fused_fc, "fused_fc_sgd_epoch",
                        lambda *a, **k: calls.append(a))
    monkeypatch.setattr(root.common.engine, "fused_fc_scan", True)
    counters.counters.reset()
    wf = _port_wf(layers, epochs=2, epochs_per_dispatch=2)
    if kind == "mask":
        assert wf.train_step._fused_fc is not None   # eligible until masked
        zf = zerofill.ZeroFiller(wf, target=wf.forwards[0], grouping=2)
        zf.initialize()
    assert wf.train_step._fused_fc is None
    wf.run()
    assert not wf.train_step._fused_fc_active and not calls
    assert wf.decision.epoch_number == 2
    assert not any(v for k, v in counters.counters.snapshot().items()
                   if "fused_fc" in k)


def test_image_saver(tmp_path):
    saver = image_saver.ImageSaver(Workflow(name="t"),
                                   out_dir=str(tmp_path / "dump"), limit=10)
    data = numpy.random.RandomState(3).rand(6, 16).astype(numpy.float32)
    labels = numpy.array([0, 1, 0, 1, 0, 1])
    preds = numpy.zeros((6, 2), dtype=numpy.float32)
    preds[:, 0] = 1.0
    saver.input, saver.labels, saver.output = (
        Array(data), Array(labels), torch.from_numpy(preds))
    saver.run()
    files = os.listdir(tmp_path / "dump" / "1")
    assert len(files) == 3 and all(f.endswith(".png") for f in files)
    assert not (tmp_path / "dump" / "0").exists()
    assert saver.get_metric_values() == {"images_saved": 3}
    from PIL import Image
    img = numpy.asarray(Image.open(tmp_path / "dump" / "1" / sorted(
        files)[0]))
    assert img.shape == (4, 4) and img.dtype == numpy.uint8
    saver.reset_epoch()
    assert saver.saved_count == 0 and not (tmp_path / "dump").exists()


def test_image_saver_names_missing_pillow(tmp_path, monkeypatch):
    import builtins
    real = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", no_pil)
    saver = image_saver.ImageSaver(Workflow(name="t"),
                                   out_dir=str(tmp_path), limit=1)
    saver.input = Array(numpy.zeros((1, 4), numpy.float32))
    saver.labels = Array(numpy.array([1]))
    saver.output = Array(numpy.array([[1.0, 0.0]], numpy.float32))
    with pytest.raises(VelesError, match="Pillow"):
        saver.run()


def test_dropout_net_resumes_its_draws(tmp_path):
    """A snapshot of a net with a random unit carries ``rng_step``: 1 +
    resume + 1 epochs equal 2 straight ones bit for bit."""
    straight = _port_wf(DROPOUT_NET)
    straight.run()
    first = _port_wf(DROPOUT_NET, epochs=1)
    first.run()
    state = snapshotter.collect_state(first)
    assert state["__units__"][first.train_step.name]["rng_step"] == 10
    resumed = _port_wf(DROPOUT_NET)
    snapshotter.apply_state(resumed, state)
    resumed.decision.complete <<= False
    resumed.run()
    assert resumed.train_step.rng_step == straight.train_step.rng_step
    for name, p in straight.train_step.params.items():
        for k, v in p.items():
            assert torch.equal(resumed.train_step.params[name][k], v)


SOLVER_NET = [dict(cfg, solver="adadelta", gradient_clip_norm=2.0)
              for cfg in MASK_NET]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_solver_state_snapshot_crosses_packages(writer, tmp_path):
    """AdaDelta's accumulators ``a`` and ``d`` in a snapshot written by
    one package and resumed by the other; then one more epoch on each
    side: parameters and state within rtol 2e-4 / atol 2e-5."""
    port = _port_wf(SOLVER_NET, epochs=2)
    with ref_prng._lock:
        ref_prng._generators.clear()
    ref_prng.seed_all(1234)
    ref = ref_nn.StandardWorkflow(
        name="znicz", layers=SOLVER_NET,
        loader_unit=RefBlobs(None, minibatch_size=20, name="blobs"),
        loss_function="softmax",
        decision_config=dict(max_epochs=2, fail_iterations=99))
    ref.initialize(device=vt.XLADevice(mesh_axes={"data": 1}))
    src, dst = (port, ref) if writer == "port" else (ref, port)
    src.run()
    snap = (snapshotter.Snapshotter if writer == "port" else vt.Snapshotter)(
        None, prefix="solver", directory=str(tmp_path))
    snap.workflow = src
    src.add_ref(snap)
    path = snap.export()
    (vt.resume if writer == "port" else snapshotter.resume)(dst, path)
    want = jax.tree_util.tree_map(numpy.asarray, src.train_step.opt_state) \
        if writer == "reference" else _tree(src.train_step.opt_state)
    got = jax.tree_util.tree_map(numpy.asarray, dst.train_step.opt_state) \
        if writer == "port" else _tree(dst.train_step.opt_state)
    assert sorted(got["softmax1"]) == ["a", "d"]
    for w, g in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(got)):
        numpy.testing.assert_array_equal(g, w)
    for wf in (port, ref):
        wf.decision.max_epochs = 3
        wf.decision.complete <<= False
        wf.run()
        assert wf.decision.epoch_number == 3
    for attr in ("params", "opt_state"):
        want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
            numpy.asarray, getattr(ref.train_step, attr)))
        got = jax.tree_util.tree_leaves(_tree(getattr(port.train_step,
                                                      attr)))
        for w, g in zip(want, got, strict=True):
            numpy.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5)

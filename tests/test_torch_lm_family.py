"""The rest of the port's LM family (veles_tpu_torch/nn/transformer.py
``MeanPool``, nn/attention.py ``MultiHeadAttention``, nn/moe.py, nn/
variants.py, models/tiny_transformer.py) against the reference's units
(veles_tpu/nn/...) on the same numpy-seeded inputs, on the CPU:

- ``mean_pool`` within 1e-6 of max|reference|;
- the multi-head attention unit, GQA (4 heads over 2 or 4 kv heads),
  causal and not: its initial weights equal the reference's keyed
  streams bit for bit; the forward within 1e-5 and the gradients of
  ``sum(y · E)`` within 1e-4 of max|reference| (float32 in another
  order of sums); a device with a sequence mesh names ROADMAP item 10;
- the MoE layer, dense and sparse (top-1, top-2): forward within 1e-5,
  gradients within 1e-4, the sparse routing masks equal; top-k = E with
  ample capacity equals the dense mixture (1e-5); identical tokens over
  a capacity of one keep the first and give the others exactly zero;
  ``top_k`` out of range raises ``Bug``;
- RProp: the reference's sign-dynamics test, and ten rule steps with
  weight decay and a schedule factor against the reference's
  ``update`` within 1e-6; the resizable All2All grows and shrinks as
  the reference's does, bit for bit;
- the six new layer types register under the reference's mapping
  names, each with its GD pair.

Training through them is in ``tests/test_torch_lm_family_train.py``.
"""
import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

import veles_tpu as vt
from veles_tpu import nn as ref_nn
from veles_tpu import prng as ref_prng
from veles_tpu.error import Bug as RefBug
from veles_tpu.memory import Array as RefArray
from veles_tpu_torch import prng
from veles_tpu_torch.error import Bug, VelesError
from veles_tpu_torch.memory import Array
from veles_tpu_torch.nn import attention, moe, transformer, variants
from veles_tpu_torch.units import UnitRegistry

FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4
SEED = 5150


@pytest.fixture(autouse=True)
def f32_compute():
    prev = vt.root.common.engine.compute_dtype
    vt.root.common.engine.compute_dtype = "float32"
    yield
    vt.root.common.engine.compute_dtype = prev


def _close(got, want, rtol, what):
    want = numpy.asarray(want, numpy.float32)
    scale = max(1.0, float(numpy.abs(want).max()))
    err = float(numpy.abs(numpy.asarray(got, numpy.float32) - want).max())
    assert err <= rtol * scale, "%s: %g > %g" % (what, err, rtol * scale)


def _pair(ref_cls, port_cls, x, name, **cfg):
    """The reference unit and the port's, each initialised on ``x`` from
    the same keyed streams; the reference's parameters as numpy."""
    ref_prng.seed_all(SEED)
    prng.seed_all(SEED)
    ref = ref_cls(vt.Workflow(name="t"), name=name, **cfg)
    ref.input = RefArray(x, name="x")
    ref.initialize(device=vt.XLADevice(mesh_axes={"data": 1}))
    port = port_cls(None, name=name, **cfg)
    port.input = Array(x, name="x")
    port.initialize(device="cpu")
    params = {k: numpy.asarray(v.map_read(), numpy.float32)
              for k, v in ref.param_arrays().items()}
    return ref, port, params


def _fwd_grad_parity(ref, port, params, x, what):
    """Forward and the gradients of sum(y · E) (parameters and input),
    port against ``jax.grad`` of the reference's apply."""
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    y_ref = numpy.asarray(ref.apply(jp, jnp.asarray(x)))
    e = numpy.random.RandomState(6).randn(*y_ref.shape).astype("float32")
    g_ref, gx_ref = jax.grad(
        lambda p, xx: jnp.sum(ref.apply(p, xx) * e), argnums=(0, 1))(
        jp, jnp.asarray(x))
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in params.items()}
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    y = port.apply(tp, tx)
    assert tuple(y.shape) == y_ref.shape == tuple(
        port.output_shape_for(x.shape))
    _close(y.detach().numpy(), y_ref, FWD_RTOL, what + " forward")
    (y * torch.from_numpy(e)).sum().backward()
    _close(tx.grad.numpy(), gx_ref, GRAD_RTOL, what + " d input")
    for k, t in tp.items():
        _close(t.grad.numpy(), g_ref[k], GRAD_RTOL, "%s d %s" % (what, k))
    return tp


# -- units --------------------------------------------------------------------

def test_mean_pool_matches_reference():
    x = numpy.random.RandomState(1).randn(3, 7, 5).astype("float32")
    ref = ref_nn.MeanPool(vt.Workflow(name="t"))
    port = transformer.MeanPool(None)
    y = port.apply({}, torch.from_numpy(x))
    assert tuple(y.shape) == port.output_shape_for(x.shape) == (3, 5)
    _close(y.numpy(), numpy.asarray(ref.apply({}, jnp.asarray(x))), 1e-6,
           "mean_pool")


@pytest.mark.parametrize("n_kv,causal", [(4, False), (4, True), (2, False),
                                         (2, True)])
def test_mha_matches_reference(n_kv, causal):
    x = numpy.random.RandomState(2).randn(2, 11, 16).astype("float32")
    ref, port, params = _pair(ref_nn.MultiHeadAttention,
                              attention.MultiHeadAttention, x, "mha",
                              n_heads=4, n_kv_heads=n_kv, causal=causal)
    assert params["wk"].shape == (16, 4 * n_kv)
    for k, arr in port.param_arrays().items():
        numpy.testing.assert_array_equal(arr.map_read(), params[k],
                                         err_msg=k)
    _fwd_grad_parity(ref, port, params, x, "mha")


def test_mha_refuses_a_sequence_mesh():
    class Mesh:
        axis_names = ("data", "sequence")
        shape = {"data": 1, "sequence": 2}

    class Device:
        mesh = Mesh()
        type = "cpu"

    u = attention.MultiHeadAttention(None, n_heads=2, name="mha")
    u.input = Array(numpy.zeros((1, 4, 8), "float32"))
    with pytest.raises(VelesError, match="item 10"):
        u.initialize(device=Device())
    with pytest.raises(ValueError, match="divisible"):
        attention.MultiHeadAttention(None, n_heads=4, n_kv_heads=3)


@pytest.mark.parametrize("top_k", [0, 1, 2])
def test_moe_matches_reference(top_k):
    x = numpy.random.RandomState(3).randn(2, 6, 8).astype("float32")
    ref, port, params = _pair(ref_nn.MoEFFN, moe.MoEFFN, x, "moe",
                              n_experts=4, hidden=16, top_k=top_k)
    assert params["w1"].shape == (4, 8, 16)
    for k, arr in port.param_arrays().items():
        numpy.testing.assert_array_equal(arr.map_read(), params[k],
                                         err_msg=k)
    _fwd_grad_parity(ref, port, params, x, "moe top_k=%d" % top_k)
    if top_k:
        flat = x.reshape(-1, 8)
        gates = numpy.asarray(jax.nn.softmax(
            jnp.asarray(flat) @ jnp.asarray(params["router"]), axis=-1))
        want = gates >= numpy.sort(gates, axis=-1)[:, -top_k][:, None]
        _, m = port.route({k: torch.from_numpy(v)
                           for k, v in params.items()},
                          torch.from_numpy(flat))
        numpy.testing.assert_array_equal(m.numpy() > 0, want)


def test_moe_top_k_equal_to_experts_is_dense():
    x = numpy.random.RandomState(2).randn(12, 6).astype("float32")
    u = moe.MoEFFN(None, n_experts=3, hidden=8, top_k=3,
                   capacity_factor=4.0, name="teq")
    u.input = Array(x)
    u.initialize(device="cpu")
    p = {k: v.device_view("cpu") for k, v in u.param_arrays().items()}
    y_sparse = u.apply(p, torch.from_numpy(x))
    u.top_k = 0
    _close(y_sparse.numpy(), u.apply(p, torch.from_numpy(x)).numpy(),
           1e-5, "top_k = E against dense")


def test_moe_capacity_drops_tokens_to_exact_zero():
    x = numpy.zeros((8, 6), "float32")
    x[:] = numpy.random.RandomState(3).randn(6)
    ref, port, params = _pair(ref_nn.MoEFFN, moe.MoEFFN, x, "tc",
                              n_experts=2, hidden=8, top_k=1,
                              capacity_factor=0.25)
    assert port.capacity(8) == 1
    y = port.apply({k: torch.from_numpy(v) for k, v in params.items()},
                   torch.from_numpy(x)).numpy()
    assert numpy.isfinite(y).all()
    nonzero = numpy.abs(y).sum(-1) > 0
    assert nonzero.tolist() == [True] + [False] * 7
    want = numpy.asarray(ref.apply({k: jnp.asarray(v)
                                    for k, v in params.items()},
                                   jnp.asarray(x)))
    assert (numpy.abs(want).sum(-1) > 0).tolist() == nonzero.tolist()
    _close(y, want, FWD_RTOL, "capacity one")


def test_moe_top_k_validation():
    for k in (-1, 5):
        with pytest.raises(RefBug):
            ref_nn.MoEFFN(vt.Workflow(name="tv"), n_experts=4, top_k=k)
        with pytest.raises(Bug, match="top_k"):
            moe.MoEFFN(None, n_experts=4, top_k=k)


def test_rprop_rule_sign_dynamics():
    gd = variants.GDRProp(None, initial_step=0.1)
    params = {"weights": torch.tensor([[1.0, 1.0]])}
    state = gd.init_state(params)
    g1 = {"weights": torch.tensor([[0.5, -0.5]])}
    p1, s1 = gd.update(params, g1, state)
    # the first step moves by the initial step against the gradient
    numpy.testing.assert_allclose(p1["weights"].numpy(), [[0.9, 1.1]],
                                  rtol=1e-6)
    # the same sign grows the step ×1.2
    p2, s2 = gd.update(p1, g1, s1)
    numpy.testing.assert_allclose(s2["step"]["weights"].numpy(),
                                  [[0.12, 0.12]], rtol=1e-6)
    # a flip shrinks it ×0.5, and the weights do not move
    g3 = {"weights": torch.tensor([[-0.5, 0.5]])}
    p3, s3 = gd.update(p2, g3, s2)
    numpy.testing.assert_array_equal(p3["weights"].numpy(),
                                     p2["weights"].numpy())
    numpy.testing.assert_allclose(s3["step"]["weights"].numpy(),
                                  [[0.06, 0.06]], rtol=1e-6)
    assert float(s3["prev_grad"]["weights"].abs().max()) == 0


def test_rprop_steps_match_reference_update():
    """Ten steps of the rule with weight decay and a schedule factor:
    signs that agree, flip and vanish, and steps that reach both clips."""
    rng = numpy.random.RandomState(7)
    p0 = {"weights": rng.randn(5, 4).astype("float32"),
          "bias": rng.randn(4).astype("float32")}
    kw = dict(initial_step=0.3, weights_decay=0.01)
    ref = ref_nn.GDRProp(vt.Workflow(name="t"), **kw)
    port = variants.GDRProp(None, **kw)
    rp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    rs, ts = ref.init_state(rp), port.init_state(tp)
    for step in range(10):
        g = {k: (rng.randn(*v.shape) * (step % 3 != 2)).astype("float32")
             for k, v in p0.items()}
        g["weights"][0] = 1e-3 * (-1) ** step
        rp, rs = ref.update(rp, {k: jnp.asarray(v) for k, v in g.items()},
                            rs, lr_scale=0.5)
        tp, ts = port.update(tp, {k: torch.from_numpy(v)
                                  for k, v in g.items()}, ts, lr_scale=0.5)
        for k in p0:
            numpy.testing.assert_allclose(tp[k].numpy(), rp[k], rtol=1e-6,
                                          atol=1e-7, err_msg=k)
            for part in ("step", "prev_grad"):
                numpy.testing.assert_allclose(
                    ts[part][k].numpy(), rs[part][k], rtol=1e-6,
                    atol=1e-7, err_msg="%s %s" % (part, k))


def test_resize_matches_reference():
    x = numpy.random.RandomState(0).rand(6, 5).astype(numpy.float32)
    ref, port, _ = _pair(ref_nn.ResizableAll2All, variants.ResizableAll2All,
                         x, "rs", output_sample_shape=4)
    w0 = numpy.array(port.weights.map_read())
    y0 = port.apply({k: v.device_view("cpu")
                     for k, v in port.param_arrays().items()},
                    torch.from_numpy(x))
    for n in (7, 3):
        ref.resize(n)
        port.resize(n)
        assert port.weights.shape == (5, n) and port.bias.shape == (n,)
        numpy.testing.assert_array_equal(port.weights.map_read(),
                                         ref.weights.map_read())
        numpy.testing.assert_array_equal(port.bias.map_read(),
                                         ref.bias.map_read())
        keep = min(4, n)
        numpy.testing.assert_array_equal(
            numpy.asarray(port.weights.map_read())[:, :keep], w0[:, :keep])
        y = port.apply({k: v.device_view("cpu")
                        for k, v in port.param_arrays().items()},
                       torch.from_numpy(x))
        assert port.output.shape == (6, n)
        _close(y[:, :keep].numpy(), y0[:, :keep].numpy(), 1e-6, "kept")
    port.resize(3)                   # the same width: nothing moves


def test_units_register_the_reference_names():
    pairs = {"mean_pool": None,
             "multi_head_attention": "gd_multi_head_attention",
             "moe_ffn": "gd_moe_ffn", "rprop_all2all": "gd_rprop",
             "resizable_all2all": "gd"}
    from veles_tpu_torch.nn.nn_units import MATCHING
    for name, gd in pairs.items():
        cls = UnitRegistry.mapping[name]
        assert cls.MAPPING == name
        if gd is not None:
            got = next(MATCHING[k] for k in cls.__mro__ if k in MATCHING)
            assert got.MAPPING == gd

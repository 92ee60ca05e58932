"""The port's conv-family units (veles_tpu_torch/nn/conv.py, deconv.py,
pooling.py, depooling.py, activation.py, the MSE evaluator) against the
reference's units on the same inputs and parameters, made from a seed
with numpy, on the CPU: the forward, and the gradients of sum(y · g)
for a random cotangent g with respect to the input and every parameter
(``jax.grad`` against autograd).

Tolerance, float32: max abs error <= 1e-5 · max(1, max|ref|) for each
output (both sides sum float32 products, in another order).

bf16 (the reference bench's mixed precision: bf16 operands, the result
in bf16, the bias added after its rounding), each limit times
max(1, max|ref|):

- the forward: max error <= 2^-7 (one bf16 ulp of the largest element:
  two bf16 results land one ulp apart wherever the float32 sums behind
  them differ in their last bits) and mean error <= 2^-14, which the
  same conv with the bias added before the rounding misses (by about
  2.5x);
- the input and weight gradients: max <= 2^-7, mean <= 2^-9 (XLA keeps
  an activation's fused backward chain in float32 where torch rounds
  each op to bf16: a few ulps apart on a tanh, none on a relu);
- the bias gradient: the reference on the CPU sums its B·H·W bf16 terms
  in bf16, the port in float32 with one rounding (as cuDNN and the
  reference's TPU do), so the two lie several ulps apart; the port's is
  held to be no further from the float32 unit's (on the same
  bf16-rounded inputs) than the reference's is, in max and in mean.
"""
import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu.nn import activation as ref_act
from veles_tpu.nn import conv as ref_conv
from veles_tpu.nn import deconv as ref_deconv
from veles_tpu.nn import depooling as ref_depool
from veles_tpu.nn import evaluator as ref_eval
from veles_tpu.nn import pooling as ref_pool
from veles_tpu_torch.nn import activation, conv, deconv, depooling, pooling
from veles_tpu_torch.nn.evaluator import EvaluatorMSE

TOL = 1e-5
TOL_BF16 = 2.0 ** -7
TOL_BF16_MEAN = 2.0 ** -14
TOL_BF16_GRAD_MEAN = 2.0 ** -9


def pair(ref_cls, port_cls, **kw):
    return ref_cls(None, name="u", **kw), port_cls(None, name="u", **kw)


def make_params(rng, unit_kw, c_in, c_out, bias):
    ky, kx = unit_kw["ky"], unit_kw["kx"]
    params = {"weights": (rng.randn(ky, kx, c_in, c_out)
                          / numpy.sqrt(kx * ky * c_in)).astype(numpy.float32)}
    if bias:
        params["bias"] = (rng.randn(c_out) * 0.1).astype(numpy.float32)
    return params


def run_both(ref_unit, port_unit, x, params, seed=0, dtype="float32"):
    """(reference, port) dicts of numpy float32 outputs: ``y`` and the
    gradients ``dx`` and ``d<param>`` of sum(y · g)."""
    ys = ref_unit.output_shape_for(x.shape)
    g = numpy.random.RandomState(seed + 1).randn(*ys).astype(numpy.float32)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)

    def ref_fn(p, xx):
        y = ref_unit.apply(p, xx)
        return jnp.sum(y.astype(jnp.float32) * g), y

    jp = {k: jnp.asarray(v).astype(jdt) for k, v in params.items()}
    (_, y), (gp, gx) = jax.value_and_grad(ref_fn, argnums=(0, 1),
                                          has_aux=True)(
        jp, jnp.asarray(x).astype(jdt))
    ref = {"y": y, "dx": gx, **{"d" + k: v for k, v in gp.items()}}
    ref = {k: numpy.asarray(v.astype(jnp.float32)) for k, v in ref.items()}

    tp = {k: torch.from_numpy(v).to(tdt).requires_grad_(True)
          for k, v in params.items()}
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    ty = port_unit.apply(tp, tx)
    assert ty.dtype == tdt
    (ty.float() * torch.from_numpy(g)).sum().backward()
    port = {"y": ty, "dx": tx.grad, **{"d" + k: v.grad
                                       for k, v in tp.items()}}
    port = {k: v.detach().float().numpy() for k, v in port.items()}
    assert tuple(port["y"].shape) == tuple(ys)
    return ref, port


def assert_close(ref, port, tol=TOL, mean_tol=None):
    assert sorted(ref) == sorted(port)
    for k, want in ref.items():
        got = port[k]
        assert got.shape == want.shape, k
        assert numpy.array_equal(numpy.isfinite(got), numpy.isfinite(want)), k
        fin = numpy.isfinite(want)
        scale = max(1.0, float(numpy.abs(want[fin]).max(initial=0.0)))
        err = numpy.abs(got[fin] - want[fin])
        assert err.max(initial=0.0) <= tol * scale, (k, err.max(), scale)
        if mean_tol is not None:
            assert err.mean() <= mean_tol * scale, (k, err.mean(), scale)
        # infinities (a window wholly in the max padding) sit alike
        numpy.testing.assert_array_equal(got[~fin], want[~fin], err_msg=k)


CONV_KINDS = [(ref_conv.Conv, conv.Conv), (ref_conv.ConvTanh, conv.ConvTanh),
              (ref_conv.ConvRelu, conv.ConvRelu),
              (ref_conv.ConvSigmoid, conv.ConvSigmoid)]
CONV_GEOMS = {
    "3x3_same": dict(kx=3, ky=3, sliding=(1, 1), padding=(1, 1, 1, 1)),
    "5x3_stride_2x1_asym": dict(kx=5, ky=3, sliding=(2, 1),
                                padding=(2, 0, 1, 1)),
    "3x2_stride_1x2_asym": dict(kx=3, ky=2, sliding=(1, 2),
                                padding=(0, 1, 2, 0)),
}


@pytest.mark.parametrize("kind", range(len(CONV_KINDS)),
                         ids=[c[0].MAPPING for c in CONV_KINDS])
@pytest.mark.parametrize("geom", sorted(CONV_GEOMS))
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_conv_matches_reference(kind, geom, bias):
    kw = dict(CONV_GEOMS[geom], n_kernels=6, include_bias=bias)
    ref_u, port_u = pair(*CONV_KINDS[kind], **kw)
    rng = numpy.random.RandomState(3)
    x = rng.randn(3, 9, 11, 4).astype(numpy.float32)
    params = make_params(rng, kw, 4, 6, bias)
    assert_close(*run_both(ref_u, port_u, x, params))


@pytest.mark.parametrize("kw", [
    dict(kx=3, ky=3, sliding=(1, 1), padding=(1, 1, 1, 1)),
    dict(kx=5, ky=5, sliding=(2, 2), padding=(2, 2, 2, 2)),
    dict(kx=4, ky=3, sliding=(2, 2), padding=(1, 0, 2, 1)),
    dict(kx=3, ky=5, sliding=(1, 2), padding=(0, 2, 1, 0),
         include_bias=True),
], ids=["s1_same", "s2_sym", "s2_asym_crop", "s1x2_asym_bias"])
def test_deconv_matches_reference(kw):
    ref_u, port_u = pair(ref_deconv.Deconv, deconv.Deconv, n_channels=5,
                         **kw)
    rng = numpy.random.RandomState(4)
    x = rng.randn(2, 6, 7, 3).astype(numpy.float32)
    params = make_params(rng, kw, 3, 5, kw.get("include_bias", False))
    ref, port = run_both(ref_u, port_u, x, params)
    assert_close(ref, port)
    # and the reference's own oracle, the scatter-add of kernel stamps
    oracle = ref_u.numpy_apply(params, x)
    err = numpy.abs(port["y"] - oracle).max()
    assert err <= TOL * max(1.0, float(numpy.abs(oracle).max())), err


POOL_GEOMS = {
    # (h, w, kx, ky, sliding)
    "whole_windows": (8, 8, 2, 2, None),
    "ceil_overhang": (7, 9, 2, 2, None),
    "overlap_3_2": (9, 8, 3, 3, (2, 2)),
    "k_below_s": (7, 8, 2, 2, (3, 3)),
    "empty_window": (6, 6, 1, 1, (4, 4)),
    "h_below_k": (2, 5, 3, 3, (2, 2)),
}
POOLS = [(ref_pool.MaxPooling, pooling.MaxPooling),
         (ref_pool.AvgPooling, pooling.AvgPooling)]


@pytest.mark.parametrize("kind", [0, 1], ids=["max", "avg"])
@pytest.mark.parametrize("geom", sorted(POOL_GEOMS))
def test_pooling_matches_reference(kind, geom):
    h, w, kx, ky, sliding = POOL_GEOMS[geom]
    ref_u, port_u = pair(*POOLS[kind], kx=kx, ky=ky, sliding=sliding)
    x = numpy.random.RandomState(5).randn(2, h, w, 3).astype(numpy.float32)
    ref, port = run_both(ref_u, port_u, x, {})
    if geom == "empty_window":
        # the window past the edge: -inf (max) or 0/0 (avg) on both
        assert not numpy.isfinite(ref["y"]).all()
    else:
        assert numpy.isfinite(port["y"]).all()
        assert numpy.isfinite(port["dx"]).all()
    assert_close(ref, port)


@pytest.mark.parametrize("geom", ["whole_windows", "overlap_3_2",
                                  "ceil_overhang"])
def test_max_pooling_gradient_goes_to_the_first_maximum(geom):
    """Every window holds ties (values from {0, 1}, mostly 1): each
    window's gradient reaches its first maximum in scan order on both."""
    h, w, kx, ky, sliding = POOL_GEOMS[geom]
    ref_u, port_u = pair(ref_pool.MaxPooling, pooling.MaxPooling, kx=kx,
                         ky=ky, sliding=sliding)
    rng = numpy.random.RandomState(6)
    x = (rng.rand(2, h, w, 2) < 0.8).astype(numpy.float32)
    ref, port = run_both(ref_u, port_u, x, {})
    numpy.testing.assert_array_equal(port["y"], ref["y"])
    numpy.testing.assert_array_equal(port["dx"], ref["dx"])
    # the check has teeth: the last maximum would route elsewhere
    flipped = torch.from_numpy(x[:, ::-1, ::-1].copy()).requires_grad_(True)
    y = port_u.apply({}, flipped)
    g = numpy.random.RandomState(1).randn(*y.shape).astype(numpy.float32)
    (y * torch.from_numpy(g)).sum().backward()
    assert not numpy.array_equal(flipped.grad.numpy()[:, ::-1, ::-1],
                                 ref["dx"])


@pytest.mark.parametrize("k", [(2, 2), (3, 2)], ids=["2x2", "3x2"])
def test_depooling_matches_reference(k):
    ky, kx = k
    ref_u, port_u = pair(ref_depool.Depooling, depooling.Depooling, kx=kx,
                         ky=ky)
    x = numpy.random.RandomState(7).randn(2, 4, 5, 3).astype(numpy.float32)
    assert_close(*run_both(ref_u, port_u, x, {}))


ACTS = [(ref_act.ForwardTanh, activation.ForwardTanh, {}),
        (ref_act.ForwardRelu, activation.ForwardRelu, {}),
        (ref_act.ForwardStrictRelu, activation.ForwardStrictRelu, {}),
        (ref_act.ForwardSigmoid, activation.ForwardSigmoid, {}),
        (ref_act.ForwardLog, activation.ForwardLog, {}),
        (ref_act.ForwardMul, activation.ForwardMul, {"factor": 0.37})]


@pytest.mark.parametrize("kind", range(len(ACTS)),
                         ids=[a[0].MAPPING for a in ACTS])
def test_activation_matches_reference(kind):
    ref_cls, port_cls, kw = ACTS[kind]
    ref_u, port_u = pair(ref_cls, port_cls, **kw)
    rng = numpy.random.RandomState(8)
    x = (rng.randn(3, 5, 4, 6) * 4).astype(numpy.float32)
    x[0, 0, 0, :3] = (0.0, 30.0, -30.0)   # the strict relu's tie; tails
    assert_close(*run_both(ref_u, port_u, x, {}))


def bf16_round(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


@pytest.mark.parametrize("case", ["conv_relu", "conv_tanh", "deconv_s2"])
def test_bf16_units_match_reference(case):
    """The AMP case: bf16 input and parameters, result in bf16, the bias
    added after the conv's rounding, the activation's constants rounded
    to bf16 as ``jnp``'s weak typing rounds them."""
    rng = numpy.random.RandomState(9)
    if case == "deconv_s2":
        kw = dict(kx=5, ky=5, sliding=(2, 2), padding=(2, 2, 2, 2),
                  include_bias=True)
        ref_u, port_u = pair(ref_deconv.Deconv, deconv.Deconv,
                             n_channels=16, **kw)
    else:
        kw = dict(kx=3, ky=3, sliding=(1, 1), padding=(1, 1, 1, 1))
        cls = {"conv_relu": 2, "conv_tanh": 1}[case]
        ref_u, port_u = pair(*CONV_KINDS[cls], n_kernels=16, **kw)
    x = bf16_round(rng.randn(4, 12, 12, 16).astype(numpy.float32))
    params = make_params(rng, kw, 16, 16, True)
    params["bias"] *= 10
    params = {k: bf16_round(v) for k, v in params.items()}
    ref, port = run_both(ref_u, port_u, x, params, dtype="bfloat16")
    dbias = ref.pop("dbias"), port.pop("dbias")
    assert_close({"y": ref.pop("y")}, {"y": port.pop("y")}, tol=TOL_BF16,
                 mean_tol=TOL_BF16_MEAN)
    assert_close(ref, port, tol=TOL_BF16, mean_tol=TOL_BF16_GRAD_MEAN)
    # the bias gradient: no further from the float32 unit than the
    # reference's bf16 sum
    f32 = run_both(ref_u, port_u, x, params)[0]["dbias"]
    ref_err, port_err = (numpy.abs(d - f32) for d in dbias)
    assert port_err.max() <= ref_err.max(), (port_err.max(), ref_err.max())
    assert port_err.mean() <= ref_err.mean()
    if case == "deconv_s2":
        return
    # the control: the bias added before the bf16 rounding misses the
    # forward's mean limit
    tx = torch.from_numpy(x)
    alt = (conv.conv2d_nhwc(tx, torch.from_numpy(params["weights"]),
                            kw["sliding"], kw["padding"])
           + torch.from_numpy(params["bias"])).bfloat16()
    alt = port_u.activation(alt).float().numpy()
    want = run_both(ref_u, port_u, x, params, dtype="bfloat16")[0]["y"]
    scale = max(1.0, float(numpy.abs(want).max()))
    assert numpy.abs(alt - want).mean() > TOL_BF16_MEAN * scale


def test_mse_evaluator_matches_reference():
    rng = numpy.random.RandomState(10)
    y = rng.randn(6, 4, 4, 3).astype(numpy.float32)
    t = rng.randn(6, 4, 4, 3).astype(numpy.float32)
    mask = numpy.array([1, 1, 1, 1, 0, 0], dtype=numpy.float32)
    ref = ref_eval.EvaluatorMSE(None)
    port = EvaluatorMSE(None)
    ty, tt, tm = (torch.from_numpy(a) for a in (y, t, mask))
    numpy.testing.assert_allclose(
        float(port.loss(ty, tt, tm)),
        float(ref.loss(jnp.asarray(y), jnp.asarray(t), jnp.asarray(mask))),
        rtol=1e-6)
    want = ref.metrics_fn(jnp.asarray(y), jnp.asarray(t), jnp.asarray(mask))
    got = port.metrics_fn(ty, tt, tm)
    assert sorted(got) == sorted(want) == ["n_samples", "sum_sq"]
    for k in want:
        numpy.testing.assert_allclose(float(got[k]), float(want[k]),
                                      rtol=1e-6)
    # a bf16 output and target widen to float32 before the difference
    got16 = port.loss(ty.bfloat16(), tt.bfloat16(), tm)
    assert got16.dtype == torch.float32
    numpy.testing.assert_allclose(float(got16), float(ref.loss(
        jnp.asarray(y).astype(jnp.bfloat16),
        jnp.asarray(t).astype(jnp.bfloat16), jnp.asarray(mask))),
        rtol=1e-6)


@pytest.mark.parametrize("kind", ["conv_tanh", "all2all_tanh"])
def test_bf16_scaled_tanh_rounds_its_constants_as_the_reference(kind):
    """1.7159·tanh(0.6666·a) on bf16: ``jnp`` rounds the constants to
    bf16 (weak typing), so the forward is the reference's bit for bit;
    torch's own bf16 × float scalar product (unrounded constants) is
    not."""
    from veles_tpu.nn import all2all as ref_fc
    from veles_tpu_torch.nn import all2all
    rng = numpy.random.RandomState(11)
    if kind == "conv_tanh":
        kw = dict(kx=3, ky=3, sliding=(1, 1), padding=(1, 1, 1, 1))
        ref_u, port_u = pair(ref_conv.ConvTanh, conv.ConvTanh, n_kernels=8,
                             **kw)
        x = rng.randn(2, 6, 6, 8).astype(numpy.float32)
        params = make_params(rng, kw, 8, 8, True)
    else:
        ref_u, port_u = pair(ref_fc.All2AllTanh, all2all.All2AllTanh,
                             output_sample_shape=64)
        x = rng.randn(16, 32).astype(numpy.float32)
        params = {"weights": (rng.randn(32, 64) / 6).astype(numpy.float32),
                  "bias": (rng.randn(64) * 0.1).astype(numpy.float32)}
    ref, port = run_both(ref_u, port_u, x, params, dtype="bfloat16")
    numpy.testing.assert_array_equal(port["y"], ref["y"])
    # the control: torch's product with the unrounded constants differs
    pre = torch.from_numpy(rng.randn(4096).astype(numpy.float32)).bfloat16()
    assert not torch.equal(port_u.activation(pre),
                           1.7159 * torch.tanh(0.6666 * pre))

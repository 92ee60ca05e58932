"""The port's flash attention in the operand dtypes of mixed precision
(veles_tpu_torch/ops/flash_attention.py: the plain forward and backward,
the differentiable ``flash_attention``) against the JAX package's
``flash_attention`` run as its Pallas kernels in interpret mode on the
CPU, as tests/test_flash_attention.py runs it, from the same numpy inputs
cast to the same dtypes: each of the kernels' four (q/k, v) instances —
float32 or bf16 q and k, float32 or bf16 v, ``do`` in o's dtype —
causal, with a window, GQA 4/2 and an odd T.

The plain versions take the Pallas kernels' rounding points: p is
rounded to v's dtype before p·v (the unnormalised p, against the running
max of the K/V blocks seen so far: the plain forward takes the kernel's
``block_k``, here below T), to do's before pᵀ·do, ds to q's and k's
dtypes before its products, and each output to its input's dtype. The
hand-written CUDA kernels are held against these plain versions on the
card (tests/test_torch_gpu.py, chip_smoke.py).

Both backwards take the Pallas forward's o and lse, as the card's checks
give the kernels' to both. Tolerances, after dividing by max(1,
max|ref|): the largest error of a float32 output within 1e-5 (float32
sums in another order), of a bf16 output within 2^-8, one bf16 rounding
(the two round float32 sums that differ in their last bits); the mean
error within 1e-6. A control holds the rounding points: the plain
versions on float32 copies of the inputs, which round no p and no ds,
miss that mean limit on every output whose product the instance rounds
p or ds for."""
import functools

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

import veles_tpu as vt
from veles_tpu.ops import flash_attention as jfa

from veles_tpu_torch.ops import flash_attention as fa

TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8}
TOL_MEAN = 1e-6
#: the outputs of each instance whose products take p or ds rounded to
#: bf16 (p to v's and do's dtype, ds to q's and k's)
ROUNDED = {"f32_bf16": ("o",), "bf16_f32": ("dq", "dk", "dv"),
           "bf16_bf16": ("o", "dq", "dk", "dv")}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}

CASES = {
    # name: (B, T, H, KV, D, causal, window, block_k)
    "causal": (2, 64, 4, 4, 32, True, 0, 16),
    "causal_one_block": (2, 64, 4, 4, 32, True, 0, 64),
    "window": (1, 64, 4, 4, 32, True, 24, 16),
    "gqa_4_2": (2, 48, 4, 2, 64, True, 0, 16),
    "odd_t_noncausal": (2, 33, 4, 4, 32, False, 0, 11),
}


@pytest.fixture(autouse=True)
def _force_pallas():
    """The reference's flash path on the CPU: Pallas in interpret mode."""
    prev = vt.root.common.engine.flash_attention
    vt.root.common.engine.flash_attention = "force"
    yield
    vt.root.common.engine.flash_attention = prev


def inputs(inst, name):
    """q, k, v, do as numpy float32 from the case's seed, and as torch and
    jax arrays in the instance's dtypes (do in q's)."""
    b, t, h, kv, d, _, _, _ = CASES[name]
    rng = numpy.random.RandomState(t + h + len(name))
    xs = [rng.randn(b, t, n, d).astype(numpy.float32)
          for n in (h, kv, kv, h)]
    qk, v = inst.split("_")
    kinds = (qk, qk, v, qk)
    return ([torch.from_numpy(x).to(DTYPES[k][0]) for x, k in zip(xs, kinds)],
            [jnp.asarray(x).astype(DTYPES[k][1]) for x, k in zip(xs, kinds)])


@functools.cache
def pallas(inst, name):
    """o and (dq, dk, dv) of the reference's Pallas kernels, K/V blocks of
    the case's ``block_k``, and the o and lse (B, H, T) its backward takes
    (computed once: interpret mode is the slow part)."""
    _, t, _, _, _, causal, window, block_k = CASES[name]
    _, (q, k, v, do) = inputs(inst, name)

    def f(q, k, v):
        return jfa.flash_attention(q, k, v, causal=causal,
                                   window=window or None, block_q=t,
                                   block_k=block_k, interpret=True)
    o, vjp = jax.vjp(f, q, k, v)
    q3, k3, v3, scale, _, b, _, h, kv, d, _, _ = jfa._prepare(
        q, k, v, None, t, block_k, True, "test", causal=causal,
        window=window)
    o3, lse3 = jfa._fwd_pallas(q3, k3, v3, causal, scale, t, block_k, True,
                               window, h, kv)
    saved = (torch.from_numpy(numpy.array(
                 jnp.moveaxis(o3[..., :d].reshape(b, h, t, d), 1, 2)
                 .astype(jnp.float32))).to(DTYPES[inst.split("_")[0]][0]),
             torch.from_numpy(numpy.array(lse3[:, 0, :].reshape(b, h, t))))
    return o, vjp(do), saved


def error(got, want):
    """(max abs error of ``got`` against ``want``, its limit, mean abs
    error, its limit)."""
    want_dtype = DTYPES["bf16" if want.dtype == jnp.bfloat16 else "f32"][0]
    want = numpy.asarray(want.astype(jnp.float32))
    scale = max(1.0, float(numpy.abs(want).max()))
    diff = numpy.abs(got.float().numpy() - want)
    return (float(diff.max()), TOL[want_dtype] * scale, float(diff.mean()),
            TOL_MEAN * scale)


def close(got, want):
    """``got`` has ``want``'s dtype and lies within its limits."""
    assert got.dtype == DTYPES["bf16" if want.dtype == jnp.bfloat16
                               else "f32"][0]
    err, limit, mean, mean_limit = error(got, want)
    assert err <= limit and mean <= mean_limit, (err, limit, mean,
                                                 mean_limit)


def plain(q, k, v, do, name, saved, f32=False):
    """o, lse and (dq, dk, dv) of the plain versions on the case, the
    backward from ``saved``, the Pallas forward's (o, lse), as the
    reference's backward takes them; ``f32``: on float32 copies of the
    inputs (rounding no p and no ds), the outputs cast back to the
    inputs' dtypes."""
    _, _, _, _, _, causal, window, block_k = CASES[name]
    xs = (q, k, v, do)
    if f32:
        xs = tuple(x.float() for x in xs)
    o, lse = fa.flash_attention_fwd_reference(*xs[:3], causal=causal,
                                              window=window, block_k=block_k)
    grads = fa.flash_attention_bwd_reference(*xs[:3], *saved, xs[3],
                                             causal=causal, window=window)
    return ((o.to(q.dtype), lse),
            tuple(g.to(x.dtype) for g, x in zip(grads, (q, k, v))))


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("inst", fa.INSTANCES)
def test_plain_versions_match_pallas(inst, name):
    (q, k, v, do), _ = inputs(inst, name)
    assert fa.instance(q, k, v, do) == inst
    want_o, want_grads, saved = pallas(inst, name)
    (o, lse), grads = plain(q, k, v, do, name, saved)
    close(o, want_o)
    assert lse.dtype == torch.float32
    close(lse, jnp.asarray(saved[1].numpy()))
    for g, want in zip(grads, want_grads):
        close(g, want)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("inst", sorted(ROUNDED))
def test_unrounded_control_misses_pallas(inst, name):
    """The control: the plain versions on float32 copies of the inputs,
    which round no p and no ds, miss the Pallas kernels' outputs by more
    than the mean limit wherever the instance rounds p or ds before their
    product."""
    (q, k, v, do), _ = inputs(inst, name)
    want_o, want_grads, saved = pallas(inst, name)
    (o, _), grads = plain(q, k, v, do, name, saved, f32=True)
    got = dict(zip(("o", "dq", "dk", "dv"), (o,) + grads))
    want = dict(zip(("o", "dq", "dk", "dv"), (want_o,) + tuple(want_grads)))
    for n in ROUNDED[inst]:
        _, _, mean, mean_limit = error(got[n], want[n])
        assert mean > mean_limit, (n, mean, mean_limit)


@pytest.mark.parametrize("inst", fa.INSTANCES)
def test_autograd_gives_the_inputs_dtypes(inst):
    """The differentiable entry on CPU tensors: its output is the plain
    forward's in the forward kernel's blocks, and its backward's
    gradients come back in q's, k's and v's dtypes, and equal the plain
    backward's."""
    _, _, _, _, _, causal, window, _ = CASES["gqa_4_2"]
    (q, k, v, do), _ = inputs(inst, "gqa_4_2")
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal)
    assert out.dtype == q.dtype
    got = torch.autograd.grad(out, leaves, do)
    o, lse = fa.flash_attention_fwd_reference(
        q, k, v, causal=causal, block_k=fa.kernel_block_k(q.shape[-1]))
    assert torch.equal(out.detach(), o)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                            causal=causal)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == x.dtype
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtypes", [
    (torch.float16, torch.float16, torch.float16, None),
    (torch.float32, torch.bfloat16, torch.float32, None),
    (torch.bfloat16, torch.bfloat16, torch.float16, None),
    (torch.float32, torch.float32, torch.bfloat16, torch.bfloat16)])
def test_other_dtypes_raise(dtypes):
    """float16, q and k apart, or a ``do`` not in o's dtype: no instance
    takes them, and the kernels raise rather than fall back."""
    q, k, v = (torch.zeros(1, 4, 2, 8, dtype=d) for d in dtypes[:3])
    do = None if dtypes[3] is None else torch.zeros(1, 4, 2, 8,
                                                    dtype=dtypes[3])
    with pytest.raises(TypeError, match="flash kernels take"):
        fa.instance(q, k, v, do)


def test_choose_flash_has_no_dtype_gate():
    """The policy keeps its contract: every length and a qualifying head
    dim on a CUDA device, whatever the operand dtypes."""
    cuda = torch.device("cuda")
    assert fa.choose_flash(512, 64, cuda)
    assert not fa.choose_flash(512, 300, cuda)
    assert not fa.choose_flash(512, 64, torch.device("cpu"))


def test_bounds_count_bf16_operands():
    """A bf16 operand is 2 bytes in the bytes a kernel must move, and a
    product of two bf16 operands takes the bf16 peak (989 TFLOP/s)
    instead of three TF32 products."""
    b, t, h, d = 16, 512, 8, 64
    f32 = fa.forward_work(b, t, h, d, causal=True)
    half = fa.forward_work(b, t, h, d, causal=True, dtype_bytes=2,
                           v_bytes=2)
    lse = b * h * t * 4
    assert half[0] == f32[0]
    assert half[1] - lse == (f32[1] - lse) / 2
    assert fa.PEAK_BF16_FLOPS == 989e12
    ops = f32[0] / fa.PEAK_BF16_FLOPS * 1e3
    bound = fa.forward_bounds(b, t, h, d, causal=True, inst="bf16_bf16")
    assert bound["tc"] == max(ops, half[1] / fa.PEAK_HBM_BYTES * 1e3)
    mixed = fa.forward_bounds(b, t, h, d, causal=True, inst="f32_bf16")
    s_tf32 = f32[0] / 2 * 3 / fa.PEAK_TF32_FLOPS * 1e3
    assert mixed["tc"] >= s_tf32 + f32[0] / 2 / fa.PEAK_BF16_FLOPS * 1e3
    for name, (flops, nbytes) in fa.backward_work(
            b, t, h, d, causal=True, dtype_bytes=2, v_bytes=2).items():
        bound = fa.backward_bounds(b, t, h, d, causal=True,
                                   inst="bf16_bf16")[name]
        assert bound["tc"] == max(flops / fa.PEAK_BF16_FLOPS * 1e3,
                                  nbytes / fa.PEAK_HBM_BYTES * 1e3)

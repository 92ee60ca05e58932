"""The arithmetic of the port's flash forward kernel, emulated on the CPU
(veles_tpu_torch/ops/flash_attention.py: ``flash_attention_fwd_tf32``).
The kernel takes both of its products (s = q·kᵀ and p·v) on the tensor
cores in 3xTF32: each operand split into hi = tf32(x) and lo = tf32(x -
hi), then lo·hi + hi·lo + hi·hi in float32. These tests show that the
emulated forward keeps the kernel's float32 tolerance (1e-4 on o and
lse) where plain TF32 does not, that it matches the JAX package's
Pallas forward (interpret mode on the CPU, as
tests/test_torch_flash_attention.py runs it, and within that file's
rtol 1e-4 / atol 1e-5), and check the tensor-core bound the kernel is
measured against (``forward_bounds``)."""
import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu.ops import flash_attention as jfa

from veles_tpu_torch.ops import flash_attention as fa

TOL = 1e-4
RTOL, ATOL = 1e-4, 1e-5


def fwd_case(seed, b=1, t=512, h=2, kv=2, d=64):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((b, t, heads, d), generator=g)
            for heads in (h, kv, kv)]


def worst(got, ref):
    return max(float((a - r).abs().max()) for a, r in zip(got, ref))


@pytest.mark.parametrize("seed", [0, 1])
def test_tf32x3_forward_keeps_the_kernel_tolerance(seed):
    """T 512 D 64 causal, the serving and training slices' head shape:
    the emulated 3xTF32 forward stays well inside 1e-4 on o and lse."""
    q, k, v = fwd_case(seed)
    ref = fa.flash_attention_fwd_reference(q, k, v, causal=True)
    assert worst(fa.flash_attention_fwd_tf32(q, k, v, causal=True), ref) \
        < TOL / 10


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_tf32_forward_misses_the_kernel_tolerance(seed):
    """Why the kernel splits every operand: with one TF32 product (hi·hi)
    the same forward exceeds 1e-4."""
    q, k, v = fwd_case(seed)
    ref = fa.flash_attention_fwd_reference(q, k, v, causal=True)
    assert worst(fa.flash_attention_fwd_tf32(q, k, v, causal=True,
                                             passes=1), ref) > TOL


@pytest.mark.parametrize("t,causal,window,h,kv,d", [
    (77, True, 0, 4, 2, 64), (200, False, 0, 4, 4, 33),
    (150, True, 40, 8, 1, 64), (1, True, 0, 2, 2, 8),
    (129, True, 0, 2, 2, 160)])
def test_tf32x3_forward_on_the_kernel_edges(t, causal, window, h, kv, d):
    """Ragged T, odd D, GQA with a window, D past 128: within 1e-4 of the
    plain forward."""
    q, k, v = fwd_case(t + d, b=2, t=t, h=h, kv=kv, d=d)
    ref = fa.flash_attention_fwd_reference(q, k, v, causal=causal,
                                           window=window)
    got = fa.flash_attention_fwd_tf32(q, k, v, causal=causal, window=window)
    assert worst(got, ref) < TOL


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2)])
@pytest.mark.parametrize("causal", [False, True])
def test_tf32x3_forward_matches_pallas(causal, h, kv, d):
    """The emulated kernel arithmetic against the JAX package's Pallas
    forward (interpret mode), at tests/test_torch_flash_attention.py's
    sizes and tolerance."""
    rng = numpy.random.RandomState(d + kv)
    q, k, v = [rng.randn(2, 128, heads, d).astype(numpy.float32)
               for heads in (h, kv, kv)]
    jo, jlse = jfa.flash_attention_fwd_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=128, block_k=128)
    o, lse = fa.flash_attention_fwd_tf32(*map(torch.from_numpy, (q, k, v)),
                                         causal=causal)
    numpy.testing.assert_allclose(o.numpy(), numpy.asarray(jo), rtol=RTOL,
                                  atol=ATOL)
    numpy.testing.assert_allclose(lse.permute(0, 2, 1).numpy(),
                                  numpy.asarray(jlse), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b,t,gflop,f32,tc,hbm", [
    # H8 KV8 D64 causal: the serve kernels line, train_lm, a long prefill
    (4, 512, 1.0758, 0.01606, 0.00652, 0.00503),
    (16, 512, 4.3034, 0.06423, 0.02608, 0.02011),
    (2, 2048, 8.5941, 0.12827, 0.05209, 0.01006)])
def test_forward_bounds_at_the_timed_shapes(b, t, gflop, f32, tc, hbm):
    """The forward's float32 FMA and 3xTF32 tensor-core bounds from
    analytic_cost's FLOPs and bytes: bound by operations at every shape
    chip_smoke.py times."""
    flops, nbytes = fa.forward_work(b, t, 8, 64, causal=True, kv=8)
    assert (flops, nbytes) == fa.analytic_cost(b, t, 8, 64, causal=True,
                                               kv=8)
    assert flops / 1e9 == pytest.approx(gflop, abs=1e-4)
    bounds = fa.forward_bounds(b, t, 8, 64, causal=True, kv=8)
    assert bounds["f32"] == pytest.approx(f32, abs=1e-5)
    assert bounds["tc"] == pytest.approx(tc, abs=1e-5)
    assert bounds["tc"] == pytest.approx(3 * flops / fa.PEAK_TF32_FLOPS
                                         * 1e3)
    assert nbytes / fa.PEAK_HBM_BYTES * 1e3 == pytest.approx(hbm, abs=1e-5)
    assert bounds["bound_by"] == "operations"


def test_forward_bounds_turn_to_bytes_at_a_tiny_head_dim():
    """D 1: every pair is a few FLOPs against whole rows of o and lse."""
    bounds = fa.forward_bounds(2, 64, 2, 1)
    assert bounds["bound_by"] == "bytes" and bounds["f32"] == bounds["tc"]

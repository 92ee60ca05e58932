"""The arithmetic of the port's flash backward kernels, emulated on the
CPU (veles_tpu_torch/ops/flash_attention.py: ``tf32_round``,
``tf32x3_einsum``, ``flash_attention_bwd_tf32``). The kernels take every
product on the tensor cores in 3xTF32: each operand split into hi =
tf32(x) and lo = tf32(x - hi) (``cvt.rna.tf32.f32``: to nearest, ties
away from zero), then lo·hi + hi·lo + hi·hi in float32. These tests pin
the rounding, show that 3xTF32 keeps the kernels' float32 tolerance
(1e-4 · max(1, max|plain|)) where plain TF32 does not, and check the
tensor-core bound the kernels are measured against. The emulation
against the JAX package's Pallas backward is in
tests/test_torch_flash_attention_bwd.py."""
import math

import numpy
import pytest
import torch

from veles_tpu_torch.ops import flash_attention as fa

TOL = 1e-4


def bits(x):
    return numpy.array([x], numpy.float32).view(numpy.uint32)[0]


def from_bits(b):
    return float(numpy.array([b], numpy.uint32).view(numpy.float32)[0])


@pytest.mark.parametrize("x,want", [
    (1.0, 1.0),
    (-2.5, -2.5),
    # exact ties (the 14th significant bit set, nothing below): away
    # from zero, for either sign
    (1 + 2 ** -11, 1 + 2 ** -10),
    (-(1 + 2 ** -11), -(1 + 2 ** -10)),
    (1 + 3 * 2 ** -11, 1 + 2 * 2 ** -10),
    # just under a tie: down
    (1 + 2 ** -11 - 2 ** -23, 1.0),
    # the largest finite float overflows to inf, as rna rounds
    (from_bits(0x7F7FFFFF), math.inf),
    # subnormals round like the rest, no flush to zero
    (from_bits(0x00001000), from_bits(0x00002000)),
    (from_bits(0x00000FFF), 0.0),
    (from_bits(0x00011FFF), from_bits(0x00012000)),
])
def test_tf32_round_values(x, want):
    got = fa.tf32_round(torch.tensor([x], dtype=torch.float32))
    assert got.dtype == torch.float32
    assert float(got[0]) == want
    assert bits(float(got[0])) & 0x1FFF == 0


@pytest.mark.parametrize("x", [0.0, -0.0, math.inf, -math.inf])
def test_tf32_round_keeps_zeros_and_infinities(x):
    got = float(fa.tf32_round(torch.tensor([x]))[0])
    assert got == x and math.copysign(1.0, got) == math.copysign(1.0, x)


@pytest.mark.parametrize("nan_bits", [
    0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001,
    # the NaN the card's arithmetic makes (0/0): rounding its bits would
    # carry into -0
    0x7FFFFFFF, 0xFFFFFFFF])
def test_tf32_round_keeps_nan(nan_bits):
    x = torch.tensor(numpy.array([nan_bits], numpy.uint32).view(
        numpy.float32))
    got = fa.tf32_round(x)
    assert got.view(torch.int32).item() == 0x7FC00000


@pytest.mark.parametrize("nan_bits", [0x7FFFFFFF, 0x7F800001])
def test_tf32x3_product_keeps_nan(nan_bits):
    """A NaN operand of a 3xTF32 product makes its row of the result NaN
    and leaves the other rows finite."""
    a = torch.ones(3, 4)
    a[1, 2] = float(numpy.array([nan_bits], numpy.uint32).view(
        numpy.float32)[0])
    got = fa.tf32x3_einsum("ik,jk->ij", a, torch.ones(2, 4))
    assert torch.isnan(got[1]).all()
    assert torch.isfinite(got[[0, 2]]).all()


def test_tf32_round_is_nearest_on_random_values():
    """Against float64 arithmetic: the error is at most half a TF32 ulp,
    and the split x = hi + lo is exact up to lo's own rounding."""
    rng = numpy.random.RandomState(0)
    x = (rng.randn(4096) * 10.0 ** rng.randint(-30, 30, 4096)).astype(
        numpy.float32)
    hi = fa.tf32_round(torch.from_numpy(x)).numpy().astype(numpy.float64)
    ulp = 2.0 ** (numpy.floor(numpy.log2(numpy.abs(x.astype(
        numpy.float64)))) - 10)
    assert (numpy.abs(hi - x) <= ulp / 2).all()
    lo = fa.tf32_round(torch.from_numpy(x) - torch.from_numpy(
        hi.astype(numpy.float32))).numpy()
    assert (numpy.abs(hi + lo - x) <= numpy.abs(x) * 2.0 ** -21).all()


def test_tf32x3_product_is_float32_grade():
    """One product at D 64: 3xTF32 within a few float32 roundings of the
    float64 product, plain TF32 ~1e-3 off."""
    rng = numpy.random.RandomState(1)
    a, b = rng.randn(64, 64), rng.randn(64, 64)
    want = a @ b
    ta, tb = (torch.from_numpy(x.astype(numpy.float32)) for x in (a, b))
    scale = numpy.abs(want).max()
    err3 = numpy.abs(fa.tf32x3_einsum("ik,kj->ij", ta, tb).double().numpy()
                     - want).max() / scale
    err1 = numpy.abs(fa.tf32x3_einsum("ik,kj->ij", ta, tb, passes=1)
                     .double().numpy() - want).max() / scale
    assert err3 < 1e-6
    assert err1 > 1e-4


def bwd_case(seed=0, b=1, t=512, h=2, d=64):
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn((b, t, h, d), generator=g) for _ in range(4))
    o, lse = fa.flash_attention_fwd_reference(q, k, v, causal=True)
    return (q, k, v, o, lse, do), fa.flash_attention_bwd_reference(
        q, k, v, o, lse, do, causal=True)


def worst(got, ref):
    return max(float((a - r).abs().max()) / max(1.0, float(r.abs().max()))
               for a, r in zip(got, ref))


@pytest.mark.parametrize("seed", [0, 1])
def test_tf32x3_backward_keeps_the_kernel_tolerance(seed):
    """T 512 D 64 causal, the training slice's head shape: the emulated
    3xTF32 backward stays well inside 1e-4 · max(1, max|plain|)."""
    args, ref = bwd_case(seed)
    assert worst(fa.flash_attention_bwd_tf32(*args, causal=True), ref) \
        < TOL / 10


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_tf32_backward_misses_the_kernel_tolerance(seed):
    """Why the kernels split every operand: with one TF32 product (hi·hi)
    the same backward exceeds 1e-4 · max(1, max|plain|)."""
    args, ref = bwd_case(seed)
    assert worst(fa.flash_attention_bwd_tf32(*args, causal=True, passes=1),
                 ref) > TOL


def test_backward_bounds_at_the_bench_shape():
    """B16 T512 H8 KV8 D64 causal: float32 FMA bounds 0.128 / 0.096 ms,
    3xTF32 tensor-core bounds 0.052 / 0.039 ms, both above HBM's 0.030 /
    0.025 ms, so both kernels are bound by operations."""
    bounds = fa.backward_bounds(16, 512, 8, 64, causal=True, kv=8)
    work = fa.backward_work(16, 512, 8, 64, causal=True, kv=8)
    for name, f32, tc in (("dkv", 0.12846, 0.05216),
                          ("dq", 0.09634, 0.03912)):
        flops, nbytes = work[name]
        assert bounds[name]["f32"] == pytest.approx(f32, abs=1e-5)
        assert bounds[name]["tc"] == pytest.approx(tc, abs=1e-5)
        assert bounds[name]["tc"] == pytest.approx(
            3 * flops / fa.PEAK_TF32_FLOPS * 1e3)
        assert bounds[name]["tc"] > nbytes / fa.PEAK_HBM_BYTES * 1e3
        assert bounds[name]["bound_by"] == "operations"


def test_backward_bounds_turn_to_bytes_at_a_tiny_head_dim():
    """D 1: every pair is a few FLOPs against whole rows of lse/delta."""
    bounds = fa.backward_bounds(2, 64, 2, 1)
    for b in bounds.values():
        assert b["bound_by"] == "bytes" and b["f32"] == b["tc"]

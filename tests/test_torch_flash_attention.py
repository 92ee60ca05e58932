"""The port's flash-attention forward (veles_tpu_torch/ops/
flash_attention.py) against the JAX package's Pallas kernel, run in
interpret mode on the CPU as tests/test_flash_attention.py runs it, and
against the JAX exact attention for the ragged lengths the Pallas kernel
does not take. On the CPU the port's wrapper runs its plain version; the
hand-written CUDA kernel is held against that plain version on the card
by tests/test_torch_gpu.py and chip_smoke.py.

Tolerance rtol 1e-4 / atol 1e-5, as tests/test_flash_attention.py: both
sides compute in float32 and differ only in summation order."""
import jax.numpy as jnp
import numpy
import pytest
import torch

import veles_tpu as vt
from veles_tpu.nn.attention import expand_kv as jax_expand_kv
from veles_tpu.ops import flash_attention as jfa
from veles_tpu.parallel.ring_attention import (
    attention_reference as jax_attention_reference)

from veles_tpu_torch.config import root as troot
from veles_tpu_torch.ops import flash_attention as fa

RTOL, ATOL = 1e-4, 1e-5


def qkv_np(b, t, h, kv, d, seed):
    rng = numpy.random.RandomState(seed)
    return [rng.randn(b, t, heads, d).astype(numpy.float32)
            for heads in (h, kv, kv)]


def close(a, b):
    numpy.testing.assert_allclose(numpy.asarray(a), numpy.asarray(b),
                                  rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2)])
@pytest.mark.parametrize("causal", [False, True])
def test_fwd_lse_matches_pallas(causal, h, kv, d):
    q, k, v = qkv_np(2, 128, h, kv, d, seed=d + kv)
    jo, jlse = jfa.flash_attention_fwd_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=128, block_k=128)
    o, lse = fa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)),
                                    causal=causal)
    assert o.shape == (2, 128, h, d) and lse.shape == (2, h, 128)
    close(o, jo)
    close(lse.permute(0, 2, 1), jlse)          # (B, H, T) → (B, T, H)


@pytest.mark.parametrize("window,h,kv", [(16, 4, 2), (100, 2, 2),
                                         (255, 4, 1)])
def test_windowed_matches_pallas(window, h, kv):
    prev = vt.root.common.engine.flash_attention
    vt.root.common.engine.flash_attention = "force"
    try:
        q, k, v = qkv_np(1, 256, h, kv, 32, seed=window)
        jo = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True,
                                 window=window, block_q=128, block_k=128)
    finally:
        vt.root.common.engine.flash_attention = prev
    o = fa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                           causal=True, window=window)
    close(o, jo)


@pytest.mark.parametrize("t,causal,window,kv", [
    (77, True, 0, 2), (200, False, 0, 4), (150, True, 40, 1),
    (1, True, 0, 4)])
def test_ragged_t_matches_reference(t, causal, window, kv):
    """Any T: no multiple-of-block rule on the port's side."""
    h = 4
    q, k, v = qkv_np(2, t, h, kv, 64, seed=t)
    ref = jax_attention_reference(
        jnp.asarray(q), jax_expand_kv(None, jnp.asarray(k), h),
        jax_expand_kv(None, jnp.asarray(v), h), causal=causal,
        window=window or None)
    o, lse = fa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)),
                                    causal=causal, window=window)
    close(o, ref)
    assert torch.isfinite(lse).all()


@pytest.mark.parametrize("device,d,flag,expect", [
    ("cuda", 64, True, True), ("cuda", 256, True, True),
    ("cuda", 257, True, False), ("cpu", 64, True, False),
    ("cuda", 64, False, False)])
def test_choose_flash_policy(device, d, flag, expect):
    """On the card every head dim the kernel takes goes through it
    (no TPU crossover); the engine flag turns it off; never on the
    CPU."""
    prev = troot.common.engine.flash_attention
    troot.common.engine.flash_attention = flag
    try:
        assert fa.choose_flash(4096, d, torch.device(device)) is expect
        assert fa.choose_flash(3, d, torch.device(device)) is expect
    finally:
        troot.common.engine.flash_attention = prev


@pytest.mark.parametrize("t,causal,window", [
    (64, False, 0), (100, True, 0), (100, True, 7), (5, True, 9)])
def test_live_pairs_counts_the_mask(t, causal, window):
    rel = numpy.arange(t)[:, None] - numpy.arange(t)[None, :]
    keep = numpy.ones((t, t), bool)
    if causal:
        keep &= rel >= 0
    if window:
        keep &= rel < window
    assert fa.live_pairs(t, causal, window) == int(keep.sum())
    flops, nbytes = fa.analytic_cost(2, t, 4, 16, causal, window, kv=2)
    assert flops == 4.0 * 2 * 4 * keep.sum() * 16
    assert nbytes == 4 * (2 * t * 16 * (4 + 4 + 2 + 2) + 2 * 4 * t)


def test_wrapper_rejects_bad_input():
    q, k, v = map(torch.from_numpy, qkv_np(1, 16, 4, 2, 8, seed=0))
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention_fwd(q, k, v, causal=False, window=4)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention_fwd(q, k, v, causal=True, window=-1)
    with pytest.raises(ValueError, match="divide"):
        fa.flash_attention_fwd(q, k[:, :, :1].expand(1, 16, 3, 8),
                               v[:, :, :1].expand(1, 16, 3, 8))
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention_fwd(q, k[:, :8], v[:, :8])

"""The port's flash-attention backward (veles_tpu_torch/ops/
flash_attention.py: the plain backward, the differentiable
``flash_attention`` and ``flash_attention_bwd_lse``) against the JAX
package's: its Pallas backward pair (``_bwd_pallas_core``) run in
interpret mode on the CPU through the custom VJP, as
tests/test_flash_attention.py runs it, and its blockwise oracle
(``_bwd_blockwise``). On the CPU the port runs its plain backward; the
hand-written CUDA kernels are held against it on the card by
tests/test_torch_gpu.py and chip_smoke.py, and their 3xTF32 arithmetic,
emulated (``flash_attention_bwd_tf32``), against the Pallas pair here.

Tolerance rtol 1e-4 / atol 1e-5 after dividing both sides by max|ref|,
as tests/test_flash_attention.py: float32 on both sides, only the
summation order differs. The JAX side's T is a multiple of its 128-row
blocks."""
import functools

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

import veles_tpu as vt
from veles_tpu.ops import flash_attention as jfa

from veles_tpu_torch.nn.attention import attention_reference, expand_kv
from veles_tpu_torch.ops import flash_attention as fa

RTOL, ATOL = 1e-4, 1e-5
T = 128


@pytest.fixture(autouse=True)
def _force_pallas():
    """The reference's flash path on the CPU: Pallas in interpret mode."""
    prev = vt.root.common.engine.flash_attention
    vt.root.common.engine.flash_attention = "force"
    yield
    vt.root.common.engine.flash_attention = prev


def inputs(b, h, kv, d, seed):
    rng = numpy.random.RandomState(seed)
    return [rng.randn(b, T, heads, d).astype(numpy.float32)
            for heads in (h, kv, kv, h)]


def close(got, want):
    want = numpy.asarray(want)
    scale = float(numpy.abs(want).max())
    numpy.testing.assert_allclose(numpy.asarray(got) / scale, want / scale,
                                  rtol=RTOL, atol=ATOL)


def jax_grads(q, k, v, do, causal, window):
    """dq, dk, dv through the reference's custom VJP: the Pallas
    backward pair in interpret mode."""
    def f(q, k, v):
        return jfa.flash_attention(q, k, v, causal=causal,
                                   window=window or None, block_q=128,
                                   block_k=128, interpret=True)
    _, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    return vjp(jnp.asarray(do))


CASES = {
    # name: (B, H, KV, D, causal, window)
    "causal": (2, 4, 4, 32, True, 0),
    "noncausal": (2, 4, 4, 32, False, 0),
    "window": (1, 4, 4, 32, True, 48),
    "gqa_4_2": (2, 4, 2, 64, True, 0),
    "gqa_4_1": (1, 4, 1, 32, False, 0),
}


@functools.cache
def pallas_case(name):
    """A case's inputs and the reference's Pallas gradients (computed
    once: interpret mode is the slow part)."""
    b, h, kv, d, causal, window = CASES[name]
    q, k, v, do = inputs(b, h, kv, d, seed=len(name))
    return (q, k, v, do), jax_grads(q, k, v, do, causal, window)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_pallas(name):
    b, h, kv, d, causal, window = CASES[name]
    (q, k, v, do), want_grads = pallas_case(name)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = fa.flash_attention_fwd(tq, tk, tv, causal=causal,
                                    window=window)
    got = fa.flash_attention_bwd_reference(tq, tk, tv, o, lse, tdo,
                                           causal=causal, window=window)
    for g, want, x in zip(got, want_grads, (q, k, v)):
        assert g.shape == x.shape
        close(g, want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_autograd_gradients_match_pallas(name):
    """The differentiable ``flash_attention`` (its autograd Function on a
    CPU tensor: plain forward, plain backward) against the Pallas pair,
    and against autograd through the plain attention."""
    b, h, kv, d, causal, window = CASES[name]
    (q, k, v, do), want_grads = pallas_case(name)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal, window=window or None)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for g, want in zip(got, want_grads):
        close(g, want)
    plain = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    ref = attention_reference(plain[0], expand_kv(plain[1], h),
                              expand_kv(plain[2], h), causal=causal,
                              window=window or None)
    for g, want in zip(got, torch.autograd.grad(ref, plain,
                                                torch.from_numpy(do))):
        close(g, want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tf32x3_backward_matches_pallas(name):
    """The kernels' arithmetic (every product 3xTF32, emulated on the CPU
    by ``flash_attention_bwd_tf32``) against the Pallas pair, at the
    float32 tolerance."""
    b, h, kv, d, causal, window = CASES[name]
    (q, k, v, do), want_grads = pallas_case(name)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = fa.flash_attention_fwd(tq, tk, tv, causal=causal,
                                    window=window)
    got = fa.flash_attention_bwd_tf32(tq, tk, tv, o, lse, tdo,
                                      causal=causal, window=window)
    for g, want, x in zip(got, want_grads, (q, k, v)):
        assert g.shape == x.shape and g.dtype == torch.float32
        close(g, want)


@pytest.mark.parametrize("name", ["causal", "gqa_4_2", "window"])
def test_plain_backward_matches_blockwise_oracle(name):
    """Against ``_bwd_blockwise``, the reference's plain-jnp oracle, on
    its folded (B*H, T, D) layout."""
    b, h, kv, d, causal, window = CASES[name]
    q, k, v, do = inputs(b, h, kv, d, seed=3)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = fa.flash_attention_fwd(tq, tk, tv, causal=causal,
                                    window=window)

    def fold(x):
        x = numpy.asarray(x)
        return jnp.asarray(numpy.moveaxis(x, 2, 1).reshape(
            -1, T, x.shape[-1]))

    res = (fold(q), fold(k), fold(v), fold(o.numpy()),
           jnp.asarray(lse.numpy().reshape(b * h, T)))
    want = jfa._bwd_blockwise(causal, 1.0 / numpy.sqrt(d), 64, window, res,
                              fold(do))
    got = fa.flash_attention_bwd_reference(tq, tk, tv, o, lse, tdo,
                                           causal=causal, window=window)
    for g, w, heads in zip(got, want, (h, kv, kv)):
        close(numpy.moveaxis(g.numpy(), 2, 1).reshape(-1, T, d), w)


@pytest.mark.parametrize("h,kv,causal", [(4, 4, True), (4, 2, False)])
def test_bwd_lse_matches_pallas(h, kv, causal):
    """The pair against an EXTERNAL lse/delta (B, T, H), f32 outputs, as
    a ring attention step sees the global normaliser: here arbitrary
    values from a seed."""
    q, k, v, do = inputs(2, h, kv, 32, seed=h + kv)
    rng = numpy.random.RandomState(5)
    lse = (rng.randn(2, T, h) + 4.0).astype(numpy.float32)
    delta = rng.randn(2, T, h).astype(numpy.float32)
    want = jfa.flash_attention_bwd_lse(
        *map(jnp.asarray, (q, k, v, lse, delta, do)), causal=causal,
        block_q=128, block_k=128, interpret=True)
    got = fa.flash_attention_bwd_lse(
        *map(torch.from_numpy, (q, k, v, lse, delta, do)), causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        close(g, w)


def test_cpu_autograd_launches_no_kernel():
    """On CPU tensors the differentiable entry runs the plain forward and
    backward: every input gets its gradient, and the backward kernels'
    counters, which move only on a launch, stay where they were."""
    from veles_tpu_torch.telemetry import counters
    q, k, v, do = inputs(1, 2, 2, 8, seed=0)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    before = (counters.get(fa.DKV_LAUNCHES), counters.get(fa.DQ_LAUNCHES))
    out = fa.flash_attention(*leaves, causal=True)
    out.backward(torch.from_numpy(do))
    assert all(x.grad is not None for x in leaves)
    assert (counters.get(fa.DKV_LAUNCHES),
            counters.get(fa.DQ_LAUNCHES)) == before


@pytest.mark.parametrize("t,causal,window", [(512, True, 0), (300, True, 128),
                                             (257, False, 0)])
def test_backward_work_counts_the_live_pairs(t, causal, window):
    pairs = 16 * 8 * fa.live_pairs(t, causal, window)
    work = fa.backward_work(16, t, 8, 64, causal, window, kv=2)
    assert work["dkv"][0] == 8 * 64 * pairs
    assert work["dq"][0] == 6 * 64 * pairs
    io = 16 * t * 64 * 4
    rows = 2 * 16 * 8 * t * 4
    assert work["dkv"][1] == 2 * io * 8 + 4 * io * 2 + rows
    assert work["dq"][1] == 3 * io * 8 + 2 * io * 2 + rows
    fwd = fa.analytic_cost(16, t, 8, 64, causal, window, kv=2)
    train = fa.analytic_cost(16, t, 8, 64, causal, window, kv=2, train=True)
    assert train == (fwd[0] * 3.5, fwd[1] * 3)

"""Attention core (counterpart of ``veles_tpu/nn/attention.py`` and of
``veles_tpu/parallel/ring_attention.py::attention_reference``).

Single device only: the reference's ring and Ulysses schemes over a
sequence mesh are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops import flash_attention as fa
from ..ops.precision import promote_operands


def expand_kv(x, n_heads: int):
    """(B, T, KV, Dh) → (B, T, H, Dh): share each KV head across its
    H/KV query heads (GQA) — query head h reads kv head h // (H/KV)."""
    b, t, kv, hd = x.shape
    g = n_heads // kv
    if g == 1:
        return x
    return x[:, :, :, None, :].expand(b, t, kv, g, hd).reshape(
        b, t, n_heads, hd)


def attention_reference(q, k, v, causal: bool = False,
                        scale: Optional[float] = None,
                        window: Optional[int] = None):
    """Single-device exact attention: f32 scores, masked with -1e30
    (causal; ``window=W``: each query sees itself plus W-1
    predecessors), full softmax. Mixed operand dtypes are promoted as
    ``jnp.einsum`` promotes them (``torch.einsum`` refuses them): under
    mixed precision the reference gives the first RoPE block q and k in
    float32 and v in bf16, so p stays float32 (it is cast to q's dtype)
    and v is widened — p is not rounded to bf16, unlike in the flash
    kernels. Two bf16 operands give a bf16 product (the scores rounded
    to bf16 before the float32 softmax, as in the reference)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk",
                     *promote_operands(q, k)[:2]).float() * scale
    if window is not None and int(window) < 0:
        raise ValueError("window must be >= 1 (or None)")
    if window and not causal:
        raise ValueError("sliding-window attention requires causal=True")
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        rel = (torch.arange(tq, device=s.device)[:, None]
               - torch.arange(tk, device=s.device)[None, :])
        mask = rel >= 0
        if window:
            mask = mask & (rel < window)
        s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd",
                        *promote_operands(p.to(q.dtype), v)[:2])


def attention_core(q, k, v, *, causal: bool = False,
                   window: Optional[int] = None):
    """The per-shape attention chooser shared by ``TransformerBlock`` and
    the sampler's prefill. q: (B, T, H, Dh); k/v may carry fewer heads
    (GQA) → (B, T, H, Dh). On the card, every head dim the flash kernels
    take goes through the differentiable ``flash_attention``
    (``ops/flash_attention.choose_flash``; its backward is the dK/dV and
    dQ kernels), with grouped k/v read natively; otherwise, and with
    ``root.common.engine.flash_attention = False``, the plain reference
    runs on expanded k/v under autograd."""
    t, hd, h = q.shape[1], q.shape[-1], q.shape[2]
    if fa.choose_flash(t, hd, q.device):
        return fa.flash_attention(q, k, v, causal=causal, window=window)
    return attention_reference(q, expand_kv(k, h), expand_kv(v, h),
                               causal=causal, window=window)

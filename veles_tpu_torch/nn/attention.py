"""Attention core and the multi-head attention unit (counterpart of
``veles_tpu/nn/attention.py`` and of
``veles_tpu/parallel/ring_attention.py::attention_reference``).

:class:`MultiHeadAttention` (layer type "multi_head_attention", paired
with :class:`GDMultiHeadAttention`) projects (B, T, D) to q, k and v,
runs :func:`attention_core` — on the card the flash kernels, forward
and backward, with GQA's grouped k/v read natively — and projects back
through ``wo``. Under mixed precision its products promote as the
reference's ``jnp.dot`` does (``ops/precision.dot``), and the attention
core takes bf16 operands through the kernels' bf16 instances.

Single device only: the reference's ring and Ulysses schemes over a
sequence mesh are not ported yet (ROADMAP Queue 1 item 10); a device
carrying a sequence mesh raises :class:`VelesError`.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy
import torch

from ..config import root
from ..error import VelesError
from ..memory import Array
from .. import prng
from ..ops import flash_attention as fa
from ..ops.precision import dot, promote_operands
from .nn_units import ForwardBase, GradientDescentBase, matches


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
    dQ kernels) where an input needs a gradient, and through the
    registered forward op (``flash_attention_fwd``, one node in an
    exported program) where none does, with grouped k/v read natively
    either way; otherwise, and with
    ``root.common.engine.flash_attention = False``, the plain reference
    runs on expanded k/v under autograd."""
    t, hd, h = q.shape[1], q.shape[-1], q.shape[2]
    if fa.choose_flash(t, hd, q.device):
        if torch.is_grad_enabled() and any(x.requires_grad
                                           for x in (q, k, v)):
            return fa.flash_attention(q, k, v, causal=causal, window=window)
        return fa.flash_attention_fwd(q, k, v, causal=causal,
                                      window=window)[0]
    return attention_reference(q, expand_kv(k, h), expand_kv(v, h),
                               causal=causal, window=window)


class MultiHeadAttention(ForwardBase):
    """(B, T, D) → (B, T, D); parameters ``wq`` and ``wo`` (D, D), ``wk``
    and ``wv`` (D, kv_d) with kv_d = D / n_heads · n_kv_heads, each from
    the keyed stream ``<unit>.<param>`` at stddev ``weights_stddev`` or
    1/sqrt(D). ``n_kv_heads`` < ``n_heads`` is grouped-query attention;
    ``causal`` masks the future."""

    MAPPING = "multi_head_attention"
    PARAMETERIZED = True
    hide_from_registry = False
    PARAM_NAMES = ("wq", "wk", "wv", "wo")

    def __init__(self, workflow, n_heads=4, causal=False, n_kv_heads=None,
                 **kwargs):
        self.weights_stddev = kwargs.pop("weights_stddev", None)
        super().__init__(workflow, **kwargs)
        self.n_heads = int(n_heads)
        self.n_kv_heads = int(n_kv_heads) if n_kv_heads else self.n_heads
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads %d not divisible by n_kv_heads %d"
                             % (self.n_heads, self.n_kv_heads))
        self.causal = bool(causal)

    def output_shape_for(self, input_shape):
        return tuple(input_shape)

    def create_params(self, rng) -> Dict[str, Array]:
        d = self.input.shape[-1]
        if d % self.n_heads:
            raise ValueError("model dim %d not divisible by %d heads"
                             % (d, self.n_heads))
        stddev = self.weights_stddev or (1.0 / numpy.sqrt(d))
        dtype = root.common.engine.precision_type
        kv_d = (d // self.n_heads) * self.n_kv_heads
        params = {}
        for k, cols in (("wq", d), ("wk", kv_d), ("wv", kv_d), ("wo", d)):
            w = numpy.zeros((d, cols), dtype=dtype)
            prng.get("%s.%s" % (self.name, k)).fill_normal(w, stddev)
            params[k] = Array(w, name="%s.%s" % (self.name, k))
        return params

    def initialize(self, device=None, **kwargs):
        mesh = getattr(device, "mesh", None)
        if mesh is not None and "sequence" in getattr(
                mesh, "axis_names", ()) and mesh.shape["sequence"] > 1:
            raise VelesError("%s: attention over a sequence mesh (ring / "
                             "Ulysses) is not ported yet (ROADMAP Queue 1 "
                             "item 10: distribution)" % self.name)
        return super().initialize(device=device, **kwargs)

    def apply(self, params, x):
        b, t, d = x.shape
        h, kv = self.n_heads, self.n_kv_heads
        hd = d // h
        q = dot(x, params["wq"]).reshape(b, t, h, hd)
        k = dot(x, params["wk"]).reshape(b, t, kv, hd)
        v = dot(x, params["wv"]).reshape(b, t, kv, hd)
        o = attention_core(q, k, v, causal=self.causal).reshape(b, t, d)
        return dot(o, params["wo"])


@matches(MultiHeadAttention)
class GDMultiHeadAttention(GradientDescentBase):
    MAPPING = "gd_multi_head_attention"
    hide_from_registry = False

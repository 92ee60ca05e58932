"""Transformer LM layers (counterpart of ``veles_tpu/nn/transformer.py``).

``Embedding``, ``PositionalEmbedding``, ``TransformerBlock`` and
``LMHead`` are ``nn.Module``s holding their parameters under the
reference's names and in its layout (``(d_in, d_out)`` weight matrices),
so a reference parameter tree loads into them name for name
(``convert.params_from_jax``). The sub-layer functions (norms, FFN,
RoPE) are the one copy shared by the full forward and the KV-cached
sampler, as in the reference.

Block (pre-LN, GPT-style):
    h = x + W_o · attn(LN1(x))
    y = h + W2 · gelu(W1 · LN2(h))
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy
import torch
from torch import nn

from .attention import attention_core

Shapes = Dict[str, Tuple[int, ...]]


def _layernorm(x, g, b, eps=1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * g + b


def _gelu(x):
    # tanh approximation — the reference's formula
    c = float(numpy.sqrt(2.0 / numpy.pi).astype("float32"))
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3)))


def _rmsnorm(x, g, eps=1e-5):
    return x / torch.sqrt((x ** 2).mean(dim=-1, keepdim=True) + eps) * g


def _silu(x):
    return x / (1.0 + torch.exp(-x))


def block_norm(block, x, which: str):
    """The block's normalisation sub-layer (``which``: "ln1"/"ln2"),
    shared by the full forward and the sampler. norm="rms" drops the
    mean-centering and the bias (llama convention)."""
    g = getattr(block, which + "_g")
    if block.norm == "rms":
        return _rmsnorm(x, g)
    return _layernorm(x, g, getattr(block, which + "_b"))


def block_ffn(block, x):
    """The block's FFN sub-layer. ffn="swiglu": W2·(silu(W1 x) ⊙ W3 x),
    no biases; default GELU: W2·gelu(W1 x + b1) + b2."""
    if block.ffn == "swiglu":
        return (_silu(x @ block.w1) * (x @ block.w3)) @ block.w2
    return _gelu(x @ block.w1 + block.b1) @ block.w2 + block.b2


def rope_angles(positions, hd: int, base: float = 10000.0):
    """(len(positions), hd//2) float32 rotation angles, computed in numpy
    float32 exactly as the reference computes them, so the full-window
    and the single-position rotations agree bit for bit."""
    half = hd // 2
    inv = base ** (-numpy.arange(half, dtype="float32") / half)
    return (numpy.asarray(positions, dtype="float32")[:, None]
            * inv[None, :]).astype("float32")


def _rotate(x, ang):
    """Half-split rotation of x (B, T, H, Dh) by ang (T, Dh//2)."""
    hd = x.shape[-1]
    half = hd // 2
    ang = torch.from_numpy(ang).to(x.device)
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:2 * half]
    rot1 = x1 * cos - x2 * sin
    rot2 = x1 * sin + x2 * cos
    if 2 * half == hd:
        return torch.cat([rot1, rot2], dim=-1)
    return torch.cat([rot1, rot2, x[..., 2 * half:]], dim=-1)


def _rope(x, base=10000.0):
    """Rotary position embedding on (B, T, H, Dh), HALF-SPLIT pairing
    (GPT-NeoX convention: feature j rotates with j+half), positions
    0..T-1."""
    return _rotate(x, rope_angles(range(x.shape[1]), x.shape[-1], base))


class _Layer(nn.Module):
    """A parameterised layer: ``param_shapes()`` names every parameter
    in the reference's layout."""

    def __init__(self, name: str) -> None:
        super().__init__()
        self.name = name

    def param_shapes(self) -> Shapes:
        raise NotImplementedError

    def _make_params(self, device, dtype) -> None:
        # inference only in this slice: no autograd graph is recorded
        # through the parameters (training is not ported yet)
        for pname, shape in self.param_shapes().items():
            self.register_parameter(pname, nn.Parameter(
                torch.zeros(shape, device=device, dtype=dtype),
                requires_grad=False))


class Embedding(_Layer):
    """(B, T) int tokens → (B, T, D) vectors. Out-of-range ids clamp to
    the edge rows (the reference's ``mode="clip"``)."""

    def __init__(self, vocab_size: int, dim: int, name: str = "embedding",
                 device=None, dtype=torch.float32) -> None:
        super().__init__(name)
        self.vocab_size, self.dim = int(vocab_size), int(dim)
        self._make_params(device, dtype)

    def param_shapes(self) -> Shapes:
        return {"table": (self.vocab_size, self.dim)}

    def forward(self, ids):
        return self.table[ids.long().clamp(0, self.vocab_size - 1)]


class PositionalEmbedding(_Layer):
    """(B, T, D) → (B, T, D): adds a learned per-position table."""

    def __init__(self, max_len: int, dim: int,
                 name: str = "pos_embedding", device=None,
                 dtype=torch.float32) -> None:
        super().__init__(name)
        self.max_len, self.dim = int(max_len), int(dim)
        self._make_params(device, dtype)

    def param_shapes(self) -> Shapes:
        return {"table": (self.max_len, self.dim)}

    def forward(self, x):
        return x + self.table[None, :x.shape[1]]


class TransformerBlock(_Layer):
    """(B, T, D) → (B, T, D): pre-LN attention + FFN, with every option
    of the reference's layer config — GQA ``n_kv_heads``, sliding
    ``window``, ``norm="rms"``, ``ffn="swiglu"``, RoPE and
    ``rope_base``."""

    def __init__(self, dim: int, n_heads: int = 4, ffn_hidden: int = 0,
                 causal: bool = True, rope: bool = False,
                 n_kv_heads: Optional[int] = None,
                 window: Optional[int] = None, norm: str = "layer",
                 ffn: str = "gelu", rope_base: float = 10000.0,
                 name: str = "transformer_block", device=None,
                 dtype=torch.float32) -> None:
        super().__init__(name)
        if norm not in ("layer", "rms"):
            raise ValueError("norm must be 'layer' or 'rms'")
        if ffn not in ("gelu", "swiglu"):
            raise ValueError("ffn must be 'gelu' or 'swiglu'")
        self.dim = int(dim)
        self.n_heads = int(n_heads)
        self.n_kv_heads = int(n_kv_heads) if n_kv_heads else self.n_heads
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads %d not divisible by n_kv_heads %d"
                             % (self.n_heads, self.n_kv_heads))
        if self.dim % self.n_heads:
            raise ValueError("model dim %d not divisible by %d heads"
                             % (self.dim, self.n_heads))
        if window is not None:
            if int(window) < 1:
                raise ValueError("window must be a positive span, got %r"
                                 % (window,))
            if not causal:
                raise ValueError("window requires causal=True")
            window = int(window)
        self.window = window
        self.norm, self.ffn = norm, ffn
        self.ffn_hidden = int(ffn_hidden) or 4 * self.dim
        self.causal = bool(causal)
        self.rope = bool(rope)
        self.rope_base = float(rope_base)
        self._make_params(device, dtype)

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def param_shapes(self) -> Shapes:
        d, f = self.dim, self.ffn_hidden
        kv_d = self.head_dim * self.n_kv_heads
        shapes = {"wq": (d, d), "wk": (d, kv_d), "wv": (d, kv_d),
                  "wo": (d, d), "w1": (d, f), "w2": (f, d),
                  "ln1_g": (d,), "ln2_g": (d,)}
        if self.ffn == "swiglu":
            shapes["w3"] = (d, f)
        else:
            shapes["b1"] = (f,)
            shapes["b2"] = (d,)
        if self.norm == "layer":
            shapes["ln1_b"] = (d,)
            shapes["ln2_b"] = (d,)
        return shapes

    def qkv(self, a_in):
        """Projections of the normed input: q (B, T, H, Dh) and the
        UNREPEATED k, v (B, T, KV, Dh)."""
        b, t, _ = a_in.shape
        hd = self.head_dim
        q = (a_in @ self.wq).reshape(b, t, self.n_heads, hd)
        k = (a_in @ self.wk).reshape(b, t, self.n_kv_heads, hd)
        v = (a_in @ self.wv).reshape(b, t, self.n_kv_heads, hd)
        return q, k, v

    def forward(self, x):
        b, t, d = x.shape
        q, k, v = self.qkv(block_norm(self, x, "ln1"))
        if self.rope:
            q, k = _rope(q, self.rope_base), _rope(k, self.rope_base)
        o = attention_core(q, k, v, causal=self.causal,
                           window=self.window).reshape(b, t, d)
        x = x + o @ self.wo
        return x + block_ffn(self, block_norm(self, x, "ln2"))


class LMHead(_Layer):
    """(B, T, D) → (B, T, V) per-position logits."""

    def __init__(self, dim: int, vocab_size: int, name: str = "lm_head",
                 device=None, dtype=torch.float32) -> None:
        super().__init__(name)
        self.dim, self.vocab_size = int(dim), int(vocab_size)
        self._make_params(device, dtype)

    def param_shapes(self) -> Shapes:
        return {"weights": (self.dim, self.vocab_size),
                "bias": (self.vocab_size,)}

    def forward(self, x):
        return x @ self.weights + self.bias

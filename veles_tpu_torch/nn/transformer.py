"""Transformer LM layers (counterpart of ``veles_tpu/nn/transformer.py``).

Each layer comes in two forms that share one copy of its math, the pure
functions of ``(layer, params, x)`` below (:func:`embed`,
:func:`add_positions`, :func:`block_apply` with :func:`block_norm`,
:func:`block_ffn`, :func:`block_qkv`, :func:`_rope`, and
:func:`lm_logits`):

- ``nn.Module``s for serving — ``Embedding``, ``PositionalEmbedding``,
  ``TransformerBlock``, ``LMHead`` — holding their parameters under the
  reference's names and in its layout (``(d_in, d_out)`` weight
  matrices), so a reference parameter tree loads into them name for
  name (``convert.params_from_jax``); the KV-cached sampler reuses the
  same functions;
- workflow units for training — ``EmbeddingUnit``,
  ``PositionalEmbeddingUnit``, ``TransformerBlockUnit``, ``LMHeadUnit``
  under the reference's mapping names (``embedding``, ``pos_embedding``,
  ``transformer_block``, ``lm_head``), each paired with its GD unit and
  creating its parameters from the reference's keyed streams
  (``prng.get("<unit>.<param>")``), so training starts from the
  reference's initial weights bit for bit.

Block (pre-LN, GPT-style):
    h = x + W_o · attn(LN1(x))
    y = h + W2 · gelu(W1 · LN2(h))

Under mixed precision (the train step's bf16 view of the parameters and
the batch) the dtypes follow the reference's: every product promotes a
mixed pair as ``jnp.dot`` does (``ops/precision.dot``); RoPE's float32
tables make q and k float32 while v stays bf16; the residual stream turns
float32 at the first ``x + o·W_o`` whose o is float32; GELU returns
float32 (its constant is a numpy float32); the logits are float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy
import torch
from torch import nn

from ..config import root
from ..memory import Array
from .. import prng
from ..ops.precision import dot
from .attention import attention_core
from .nn_units import ForwardBase, GradientDescentBase, matches

Shapes = Dict[str, Tuple[int, ...]]
Params = Dict[str, torch.Tensor]


def _layernorm(x, g, b, eps=1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * g + b


def _gelu(x):
    # tanh approximation — the reference's formula. Its constant is a
    # numpy float32 scalar, which jnp does not treat as weak: a bf16 x
    # comes out float32, the tanh's argument computed in float32
    c = float(numpy.sqrt(2.0 / numpy.pi).astype("float32"))
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3).float()))


def _rmsnorm(x, g, eps=1e-5):
    return x / torch.sqrt((x ** 2).mean(dim=-1, keepdim=True) + eps) * g


def _silu(x):
    return x / (1.0 + torch.exp(-x))


def block_norm(block, p: Params, x, which: str):
    """The block's normalisation sub-layer (``which``: "ln1"/"ln2"),
    shared by the full forward and the sampler. norm="rms" drops the
    mean-centering and the bias (llama convention)."""
    if block.norm == "rms":
        return _rmsnorm(x, p[which + "_g"])
    return _layernorm(x, p[which + "_g"], p[which + "_b"])


def block_ffn(block, p: Params, x):
    """The block's FFN sub-layer. ffn="swiglu": W2·(silu(W1 x) ⊙ W3 x),
    no biases; default GELU: W2·gelu(W1 x + b1) + b2."""
    if block.ffn == "swiglu":
        return dot(_silu(dot(x, p["w1"])) * dot(x, p["w3"]), p["w2"])
    return dot(_gelu(dot(x, p["w1"]) + p["b1"]), p["w2"]) + p["b2"]


def block_qkv(block, p: Params, a_in):
    """Projections of the normed input: q (B, T, H, Dh) and the
    UNREPEATED k, v (B, T, KV, Dh)."""
    b, t, d = a_in.shape
    hd = d // block.n_heads
    q = dot(a_in, p["wq"]).reshape(b, t, block.n_heads, hd)
    k = dot(a_in, p["wk"]).reshape(b, t, block.n_kv_heads, hd)
    v = dot(a_in, p["wv"]).reshape(b, t, block.n_kv_heads, hd)
    return q, k, v


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


def block_apply(block, p: Params, x, cache=None, causal=None):
    """The block's composition, (B, T, D) → (B, T, D): the one copy
    behind the training unit, the serving module and the sampler's
    prefill. ``cache`` = (k, v) caches gets the block's UNREPEATED K/V
    in its first T rows (in place); ``causal`` overrides the block's
    mask (the prefill is always causal)."""
    b, t, d = x.shape
    q, k, v = block_qkv(block, p, block_norm(block, p, x, "ln1"))
    if block.rope:
        q, k = _rope(q, block.rope_base), _rope(k, block.rope_base)
    if cache is not None:
        cache[0][:, :t] = k
        cache[1][:, :t] = v
    o = attention_core(q, k, v,
                       causal=block.causal if causal is None else causal,
                       window=block.window).reshape(b, t, d)
    x = x + dot(o, p["wo"])
    return x + block_ffn(block, p, block_norm(block, p, x, "ln2"))


def embed(table, ids):
    """(…) int tokens → (…, D) rows of ``table``; out-of-range ids clamp
    to the edge rows (the reference's ``mode="clip"``)."""
    return table[ids.long().clamp(0, table.shape[0] - 1)]


def add_positions(table, x):
    """(B, T, D) + the learned per-position rows 0..T-1."""
    return x + table[None, :x.shape[1]]


def lm_logits(p: Params, x):
    """(…, D) → (…, V) per-position logits."""
    return dot(x, p["weights"]) + p["bias"]


def _block_config(obj, n_heads, causal, rope, n_kv_heads, window, norm,
                  ffn, rope_base) -> None:
    """Validate a block's layer config and set it on ``obj`` (a module or
    a unit), as the reference's constructor does."""
    if norm not in ("layer", "rms"):
        raise ValueError("norm must be 'layer' or 'rms'")
    if ffn not in ("gelu", "swiglu"):
        raise ValueError("ffn must be 'gelu' or 'swiglu'")
    obj.n_heads = int(n_heads)
    obj.n_kv_heads = int(n_kv_heads) if n_kv_heads else obj.n_heads
    if obj.n_heads % obj.n_kv_heads:
        raise ValueError("n_heads %d not divisible by n_kv_heads %d"
                         % (obj.n_heads, obj.n_kv_heads))
    if window is not None:
        if int(window) < 1:
            raise ValueError("window must be a positive span, got %r"
                             % (window,))
        if not causal:
            raise ValueError("window requires causal=True")
        window = int(window)
    obj.window = window
    obj.norm, obj.ffn = norm, ffn
    obj.causal = bool(causal)
    obj.rope = bool(rope)
    obj.rope_base = float(rope_base)


def _block_shapes(block, d: int, f: int) -> Shapes:
    kv_d = (d // block.n_heads) * block.n_kv_heads
    shapes = {"wq": (d, d), "wk": (d, kv_d), "wv": (d, kv_d),
              "wo": (d, d), "w1": (d, f), "w2": (f, d),
              "ln1_g": (d,), "ln2_g": (d,)}
    if block.ffn == "swiglu":
        shapes["w3"] = (d, f)
    else:
        shapes["b1"] = (f,)
        shapes["b2"] = (d,)
    if block.norm == "layer":
        shapes["ln1_b"] = (d,)
        shapes["ln2_b"] = (d,)
    return shapes


# -- serving modules ----------------------------------------------------------
class _Layer(nn.Module):
    """A parameterised layer: ``param_shapes()`` names every parameter
    in the reference's layout."""

    def __init__(self, name: str) -> None:
        super().__init__()
        self.name = name

    def param_shapes(self) -> Shapes:
        raise NotImplementedError

    def params(self) -> Params:
        """The parameters by their reference names."""
        return dict(self.named_parameters(recurse=False))

    def _make_params(self, device, dtype) -> None:
        # serving modules: no autograd graph is recorded through the
        # parameters (training runs through the units below)
        for pname, shape in self.param_shapes().items():
            self.register_parameter(pname, nn.Parameter(
                torch.zeros(shape, device=device, dtype=dtype),
                requires_grad=False))


class Embedding(_Layer):
    """(B, T) int tokens → (B, T, D) vectors (:func:`embed`)."""

    def __init__(self, vocab_size: int, dim: int, name: str = "embedding",
                 device=None, dtype=torch.float32) -> None:
        super().__init__(name)
        self.vocab_size, self.dim = int(vocab_size), int(dim)
        self._make_params(device, dtype)

    def param_shapes(self) -> Shapes:
        return {"table": (self.vocab_size, self.dim)}

    def forward(self, ids):
        return embed(self.table, ids)


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
        return add_positions(self.table, x)


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
        _block_config(self, n_heads, causal, rope, n_kv_heads, window,
                      norm, ffn, rope_base)
        self.dim = int(dim)
        if self.dim % self.n_heads:
            raise ValueError("model dim %d not divisible by %d heads"
                             % (self.dim, self.n_heads))
        self.ffn_hidden = int(ffn_hidden) or 4 * self.dim
        self._make_params(device, dtype)

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def param_shapes(self) -> Shapes:
        return _block_shapes(self, self.dim, self.ffn_hidden)

    def forward(self, x):
        return block_apply(self, self.params(), x)


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
        return lm_logits(self.params(), x)


# -- training units -----------------------------------------------------------
def _normal(unit, pname: str, shape, stddev) -> Array:
    """A parameter drawn from the reference's keyed stream
    ``<unit>.<param>``."""
    w = numpy.zeros(shape, dtype=root.common.engine.precision_type)
    prng.get("%s.%s" % (unit.name, pname)).fill_normal(w, stddev)
    return Array(w, name="%s.%s" % (unit.name, pname))


class TransformerBlockUnit(ForwardBase):
    """(B, T, D) → (B, T, D) training unit of :func:`block_apply`."""

    MAPPING = "transformer_block"
    PARAMETERIZED = True
    hide_from_registry = False
    PARAM_NAMES = ("wq", "wk", "wv", "wo", "w1", "b1", "w2", "b2",
                   "w3", "ln1_g", "ln1_b", "ln2_g", "ln2_b")

    def __init__(self, workflow, n_heads=4, ffn_hidden=0, causal=True,
                 rope=False, n_kv_heads=None, window=None, norm="layer",
                 ffn="gelu", rope_base=10000.0, **kwargs):
        self.weights_stddev = kwargs.pop("weights_stddev", None)
        super().__init__(workflow, **kwargs)
        _block_config(self, n_heads, causal, rope, n_kv_heads, window,
                      norm, ffn, rope_base)
        self.ffn_hidden = int(ffn_hidden)

    def output_shape_for(self, input_shape):
        return tuple(input_shape)

    def create_params(self, rng):
        d = self.input.shape[-1]
        if d % self.n_heads:
            raise ValueError("model dim %d not divisible by %d heads"
                             % (d, self.n_heads))
        f = self.ffn_hidden or 4 * d
        stddev = self.weights_stddev or (1.0 / numpy.sqrt(d))
        dtype = root.common.engine.precision_type
        params = {}
        for pname, shape in _block_shapes(self, d, f).items():
            if pname.endswith("_g"):
                params[pname] = Array(numpy.ones(shape, dtype=dtype),
                                      name="%s.%s" % (self.name, pname))
            elif len(shape) == 1:
                params[pname] = Array(numpy.zeros(shape, dtype=dtype),
                                      name="%s.%s" % (self.name, pname))
            else:
                params[pname] = _normal(
                    self, pname, shape,
                    1.0 / numpy.sqrt(f) if pname == "w2" else stddev)
        return params

    def apply(self, params, x):
        return block_apply(self, params, x)


class EmbeddingUnit(ForwardBase):
    """(B, T) int tokens → (B, T, D) training unit of :func:`embed`; its
    gradient is autograd's scatter-add into the table."""

    MAPPING = "embedding"
    PARAMETERIZED = True
    hide_from_registry = False
    PARAM_NAMES = ("table",)

    def __init__(self, workflow, vocab_size: int, dim: int,
                 stddev: float = 0.02, **kwargs):
        super().__init__(workflow, **kwargs)
        self.vocab_size = int(vocab_size)
        self.dim = int(dim)
        self.stddev = float(stddev)

    def output_shape_for(self, input_shape):
        return tuple(input_shape) + (self.dim,)

    def create_params(self, rng):
        return {"table": _normal(self, "table", (self.vocab_size, self.dim),
                                 self.stddev)}

    def apply(self, params, x):
        return embed(params["table"], x)


class PositionalEmbeddingUnit(ForwardBase):
    """(B, T, D) → (B, T, D) training unit of :func:`add_positions`; the
    table has as many rows as the input sequence."""

    MAPPING = "pos_embedding"
    PARAMETERIZED = True
    hide_from_registry = False
    PARAM_NAMES = ("table",)

    def __init__(self, workflow, stddev=0.02, **kwargs):
        super().__init__(workflow, **kwargs)
        self.stddev = float(stddev)

    def output_shape_for(self, input_shape):
        return tuple(input_shape)

    def create_params(self, rng):
        t, d = self.input.shape[1], self.input.shape[2]
        return {"table": _normal(self, "table", (t, d), self.stddev)}

    def apply(self, params, x):
        return add_positions(params["table"], x)


class LMHeadUnit(ForwardBase):
    """(B, T, D) → (B, T, V) training unit of :func:`lm_logits`, paired
    with ``loss_function="softmax_seq"``."""

    MAPPING = "lm_head"
    PARAMETERIZED = True
    hide_from_registry = False

    def __init__(self, workflow, vocab_size: int, **kwargs):
        self.weights_stddev = kwargs.pop("weights_stddev", None)
        super().__init__(workflow, **kwargs)
        self.vocab_size = int(vocab_size)

    def output_shape_for(self, input_shape):
        return tuple(input_shape[:-1]) + (self.vocab_size,)

    def create_params(self, rng):
        d = self.input.shape[-1]
        stddev = self.weights_stddev or (1.0 / numpy.sqrt(d))
        return {"weights": _normal(self, "weights", (d, self.vocab_size),
                                   stddev),
                "bias": Array(numpy.zeros(
                    (self.vocab_size,),
                    dtype=root.common.engine.precision_type),
                    name=self.name + ".bias")}

    def apply(self, params, x):
        return lm_logits(params, x)


@matches(TransformerBlockUnit)
class GDTransformerBlock(GradientDescentBase):
    MAPPING = "gd_transformer_block"
    hide_from_registry = False


@matches(EmbeddingUnit)
class GDEmbedding(GradientDescentBase):
    MAPPING = "gd_embedding"
    hide_from_registry = False


@matches(PositionalEmbeddingUnit)
class GDPositionalEmbedding(GradientDescentBase):
    MAPPING = "gd_pos_embedding"
    hide_from_registry = False


@matches(LMHeadUnit)
class GDLMHead(GradientDescentBase):
    MAPPING = "gd_lm_head"
    hide_from_registry = False

"""Flash attention forward: a hand-written Hopper kernel and its plain
torch version (counterpart of ``veles_tpu/ops/flash_attention.py``).

The kernel (``csrc/flash_attention_fwd.cu``) replaces the TPU kernel
``veles_tpu/ops/flash_attention.py::_kernel``: online-softmax attention
that streams K/V tiles instead of materialising the (T, T) scores,
skips tiles the causal/window masks kill, reads grouped K/V (GQA)
without expanding them, and takes any T and any head dim up to
:data:`MAX_D` with no padding.

Layout contract, as in the reference: q ``(B, T, H, Dh)``, k/v
``(B, T, KV, Dh)`` with ``H % KV == 0``, o ``(B, T, H, Dh)``; lse is
returned ``(B, H, T)`` (a view of the kernel's flat ``(B*H, T)``).

:func:`flash_attention_fwd` is the wrapper: on a CUDA tensor it
launches the kernel or raises; on a CPU tensor it runs
:func:`flash_attention_fwd_reference`, the plain version the CPU tests
and ``chip_smoke.py`` hold the kernel against.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from ..config import root
from ..error import VelesError
from ..telemetry.counters import inc

NEG_INF = -1e30

#: largest head dim the kernel takes (its output accumulator lives in
#: registers: DMAX/16 columns of 4 rows per thread)
MAX_D = 256

_SOURCE = "flash_attention_fwd"


def supported(d: int) -> bool:
    """Whether the kernel takes head dim ``d`` (any T is accepted)."""
    return 1 <= int(d) <= MAX_D


def choose_flash(t: int, d: int, device: torch.device) -> bool:
    """THE policy predicate for picking the kernel over the plain torch
    attention. True on a CUDA device whenever the head dim qualifies and
    ``root.common.engine.flash_attention`` is on. The reference gates
    flash behind a sequence-length crossover measured on the TPU; this
    card has no measured crossover yet, so every qualifying length goes
    through the kernel. On the CPU it is False."""
    del t  # no crossover on this card yet
    if not root.common.engine.get("flash_attention", True):
        return False
    return torch.device(device).type == "cuda" and supported(d)


def live_pairs(t: int, causal: bool, window: int = 0) -> int:
    """Number of unmasked (query, key) pairs of one head: the work the
    kernel does after its dead-tile skip and per-element masks."""
    if window:
        w = min(int(window), t)
        return w * (w + 1) // 2 + (t - w) * w
    if causal:
        return t * (t + 1) // 2
    return t * t


def analytic_cost(b: int, t: int, h: int, d: int, causal: bool = False,
                  window: int = 0, kv: Optional[int] = None,
                  dtype_bytes: int = 4) -> Tuple[float, float]:
    """(FLOPs, bytes) of one forward call: 2·D FLOPs per live pair for
    q·k and as many for p·v; bytes are q, k, v read once and o, lse
    written once (k/v at the ``kv`` grouped head count)."""
    kv = h if kv is None else kv
    flops = 4.0 * b * h * live_pairs(t, causal, window) * d
    io = b * t * d * dtype_bytes
    bytes_moved = 2 * io * h + 2 * io * kv + b * h * t * 4
    return flops, float(bytes_moved)


def _check_window(window, causal: bool, t: int) -> int:
    window = int(window or 0)
    if window < 0:
        raise ValueError("window must be >= 1 (or None)")
    if window and not causal:
        raise ValueError("sliding-window attention requires causal=True")
    return 0 if window >= t else window


def flash_attention_fwd_reference(q, k, v, causal: bool = False,
                                  window: Optional[int] = None,
                                  scale: Optional[float] = None):
    """Plain torch full-softmax attention returning ``(o, lse)`` — the
    function the kernel computes, with the same masks (causal; window:
    ``q - k < window``) and the same f32 scores."""
    b, t, h, d = q.shape
    kv = k.shape[2]
    window = _check_window(window, causal, t)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    g = h // kv
    kx = k[:, :, :, None, :].expand(b, t, kv, g, d).reshape(b, t, h, d)
    vx = v[:, :, :, None, :].expand(b, t, kv, g, d).reshape(b, t, h, d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx.float()) * scale
    if causal:
        pos = torch.arange(t, device=q.device)
        rel = pos[:, None] - pos[None, :]
        keep = rel >= 0
        if window:
            keep = keep & (rel < window)
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    lse = torch.logsumexp(s, dim=-1)                       # (B, H, T)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p, vx.float()).to(q.dtype)
    return o, lse


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, T, heads, Dh)")
    b, t, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != t \
            or k.shape[3] != d:
        raise ValueError("k/v shape %s does not match q %s"
                         % (tuple(k.shape), tuple(q.shape)))
    if h % k.shape[2]:
        raise ValueError("k/v head count %d must divide q heads %d"
                         % (k.shape[2], h))
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")


@functools.cache
def _kernel_fn():
    """The kernel's C entry point, built and typed at first use."""
    from . import _build
    fn = _build.load(_SOURCE).veles_flash_attention_fwd_f32
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    return fn


def _launch(q, k, v, causal: bool, window: int, scale: float):
    """Launch the CUDA kernel on the current stream."""
    if not (q.dtype == k.dtype == v.dtype == torch.float32):
        raise TypeError("the flash kernel takes float32 q/k/v, got %s"
                        % ((q.dtype, k.dtype, v.dtype),))
    b, t, h, d = q.shape
    if not supported(d):
        raise ValueError("head dim %d outside the kernel's 1..%d"
                         % (d, MAX_D))
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("q/k/v need a contiguous head dim (stride 1)")
    fn = _kernel_fn()
    o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b, t, h, k.shape[2], d,
                 ctypes.cast(strides, ctypes.c_void_p), float(scale),
                 int(bool(causal)), int(window), stream)
    if err != 0:
        raise RuntimeError("flash_attention_fwd kernel launch failed: "
                           "CUDA error %d" % err)
    inc("veles_flash_attention_launches_total")
    return o, lse.view(b, h, t)


def flash_attention_fwd(q, k, v, causal: bool = False,
                        window: Optional[int] = None,
                        scale: Optional[float] = None):
    """``(o (B, T, H, Dh), lse (B, H, T))`` of attention over q and the
    (possibly grouped) k/v. A CUDA tensor goes through the hand-written
    kernel — or raises; a CPU tensor through the plain version. Each
    kernel launch adds one to ``veles_flash_attention_launches_total``."""
    _check(q, k, v)
    window = _check_window(window, causal, q.shape[1])
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, causal=causal,
                                             window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError("flash_attention_fwd runs on cuda or cpu "
                         "tensors, got %s" % q.device)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        # the kernel writes o outside autograd: a backward through it
        # would give q/k/v a zero gradient without a word
        raise VelesError("flash backward not ported yet: the CUDA flash "
                         "forward cannot run where q/k/v need gradients "
                         "(use torch.no_grad(), or set "
                         "root.common.engine.flash_attention = False)")
    return _launch(q, k, v, causal, window, scale)


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    window: Optional[int] = None):
    """(B, T, H, Dh) × (B, T, KV, Dh) × 2 → (B, T, H, Dh): the output of
    :func:`flash_attention_fwd` (forward only; the backward kernels are
    not ported yet)."""
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               scale=scale)[0]

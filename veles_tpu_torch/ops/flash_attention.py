"""Flash attention: hand-written Hopper kernels for the forward and the
backward, and their plain torch versions (counterpart of
``veles_tpu/ops/flash_attention.py``).

The forward kernel (``csrc/flash_attention_fwd.cu``) replaces the TPU
kernel ``veles_tpu/ops/flash_attention.py::_kernel``: online-softmax
attention that streams K/V tiles instead of materialising the (T, T)
scores, skips tiles the causal/window masks kill, reads grouped K/V (GQA)
without expanding them, and takes any T and any head dim up to
:data:`MAX_D` with no padding; both of its products (q·kᵀ and p·v) run
on the tensor cores in 3xTF32. The backward pair
(``csrc/flash_attention_bwd.cu``) replaces ``_bwd_dkv_kernel`` and
``_bwd_dq_kernel``: dK/dV per K/V tile summed over the query heads of its
group in a fixed order (no atomics), then dQ per Q tile, both
recomputing the probabilities from the forward's log-sum-exp, with every
product on the tensor cores in 3xTF32 too. :func:`tf32_round`, :func:`flash_attention_fwd_tf32` and
:func:`flash_attention_bwd_tf32` emulate that arithmetic on the CPU for
the tests; no entry point uses them.

Layout contract, as in the reference: q ``(B, T, H, Dh)``, k/v
``(B, T, KV, Dh)`` with ``H % KV == 0``, o ``(B, T, H, Dh)``; lse is
returned ``(B, H, T)`` (a view of the kernel's flat ``(B*H, T)``).

:func:`flash_attention` is the differentiable entry (a
``torch.autograd.Function``: forward kernel, then the dK/dV and dQ
kernels in the backward); :func:`flash_attention_fwd` returns
``(o, lse)`` and is forward-only, through the registered operator
``torch.ops.veles_tpu_torch.flash_attention_fwd``
(:func:`flash_attention_fwd_op`), so ``torch.export`` keeps the kernel
as one node of a program; :func:`flash_attention_bwd_lse` runs
the backward pair against a caller's lse/delta. On a CUDA tensor each
launches its kernels or raises; on a CPU tensor each runs the plain
version (:func:`flash_attention_fwd_reference`,
:func:`flash_attention_bwd_reference`) that the CPU tests and
``chip_smoke.py`` hold the kernels against.

Operand types, as the reference's kernels take them: q and k in one
dtype, float32 or bfloat16, v in float32 or bfloat16, and ``do`` in o's
dtype, which is q's: four instances of each kernel (:func:`instance`),
each with its own launch counter besides the kernel's total. Mixed
precision gives the bench LM's first block q and k in float32 (RoPE's
float32 tables promote them) and v in bf16, and a model without RoPE
bf16 throughout. The rounding points are the Pallas kernels': p is
rounded to v's dtype before p·v (to do's before pᵀ·do), ds to q's before
dsᵀ·q and to k's before ds·k, and each output takes its input's dtype;
the scores, lse and delta stay float32. A product whose two operands are
bf16 runs as a bf16 ``mma.sync`` with float32 accumulation; any other
product stays 3xTF32, a bf16 operand widened exactly. Any other dtype
(float16, q and k apart) raises ``TypeError``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from ..config import root
from ..error import VelesError
from ..telemetry import cost as _cost
from ..telemetry.counters import inc

NEG_INF = -1e30

#: largest head dim the kernels take (their accumulators live in
#: registers, in tensor-core C fragments)
MAX_D = 256

_SOURCE = "flash_attention_fwd"
_BWD_SOURCE = "flash_attention_bwd"
FWD_LAUNCHES = "veles_flash_attention_launches_total"
DKV_LAUNCHES = "veles_flash_attention_bwd_dkv_launches_total"
DQ_LAUNCHES = "veles_flash_attention_bwd_dq_launches_total"

#: the operand dtypes the kernels take, by their names in the kernels'
#: C symbols
DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
#: the kernels' (q/k, v) instances, as :func:`instance` names them
INSTANCES = ("f32_f32", "f32_bf16", "bf16_f32", "bf16_bf16")


def instance(q, k, v, do=None) -> str:
    """The kernels' instance for these operands, ``"<qk>_<v>"`` (e.g.
    ``"f32_bf16"``); raises ``TypeError`` on dtypes no instance takes: q
    and k must share float32 or bfloat16, v be float32 or bfloat16, and
    ``do`` (the backward's) have q's dtype."""
    if (q.dtype != k.dtype or q.dtype not in DTYPE_NAMES
            or v.dtype not in DTYPE_NAMES
            or (do is not None and do.dtype != q.dtype)):
        raise TypeError(
            "the flash kernels take q and k in one of float32/bfloat16, v "
            "in float32/bfloat16 and do in q's dtype; got q %s, k %s, v %s%s"
            % (q.dtype, k.dtype, v.dtype,
               "" if do is None else ", do %s" % do.dtype))
    return "%s_%s" % (DTYPE_NAMES[q.dtype], DTYPE_NAMES[v.dtype])


def launch_counter(total: str, inst: str) -> str:
    """The per-instance launch counter of a kernel whose total counter is
    ``total`` (``FWD_LAUNCHES``, ``DKV_LAUNCHES`` or ``DQ_LAUNCHES``),
    e.g. ``veles_flash_attention_launches_f32_bf16_total``."""
    return "%s_%s_total" % (total[:-len("_total")], inst)


def supported(d: int) -> bool:
    """Whether the kernels take head dim ``d`` (any T is accepted)."""
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
    kernels do after their dead-tile skip and per-element masks."""
    if window:
        w = min(int(window), t)
        return w * (w + 1) // 2 + (t - w) * w
    if causal:
        return t * (t + 1) // 2
    return t * t


def analytic_cost(b: int, t: int, h: int, d: int, causal: bool = False,
                  window: int = 0, kv: Optional[int] = None,
                  dtype_bytes: int = 4, train: bool = False,
                  v_bytes: Optional[int] = None) -> Tuple[float, float]:
    """(FLOPs, bytes) of one forward call: 2·D FLOPs per live pair for
    q·k and as many for p·v; bytes are q, k, v read once and o, lse
    written once (k/v at the ``kv`` grouped head count; q, k and o of
    ``dtype_bytes`` each, v of ``v_bytes``, by default the same).
    ``train`` adds the backward at the reference's standard model (3.5×
    the forward's FLOPs, three round trips of the bytes), kept for
    telemetry parity; :func:`backward_work` counts what the port's
    backward kernels need."""
    kv = h if kv is None else kv
    v_bytes = dtype_bytes if v_bytes is None else v_bytes
    flops = 4.0 * b * h * live_pairs(t, causal, window) * d
    io = b * t * d
    bytes_moved = float(io * (2 * h + kv) * dtype_bytes + io * kv * v_bytes
                        + b * h * t * 4)
    if train:
        return flops * 3.5, bytes_moved * 3
    return flops, bytes_moved


def _nbytes(inst: str) -> Tuple[int, int]:
    """Bytes of one q/k/o/do element and of one v element of an
    instance."""
    qk, v = inst.split("_")
    return (2 if qk == "bf16" else 4), (2 if v == "bf16" else 4)


def _products(inst: str, kernel: str) -> Tuple[bool, ...]:
    """Whether each of a kernel's products (2·D FLOPs a live pair each)
    has two bf16 operands: the forward's s and p·v; dK/dV's s, pᵀ·do,
    dp and dsᵀ·q; dQ's s, dp and ds·k."""
    qk, v = (x == "bf16" for x in inst.split("_"))
    both = qk and v
    return {"fwd": (qk, v), "dkv": (qk, qk, both, qk),
            "dq": (qk, both, qk)}[kernel]


def backward_work(b: int, t: int, h: int, d: int, causal: bool = False,
                  window: int = 0, kv: Optional[int] = None,
                  dtype_bytes: int = 4, v_bytes: Optional[int] = None
                  ) -> Dict[str, Tuple[float, float]]:
    """(FLOPs, bytes) each backward kernel needs over this call's live
    pairs: dK/dV 8·D FLOPs a pair (s, dv, dp, dk) and dQ 6·D (s, dp, dq);
    bytes are each input read once (q, do and k of ``dtype_bytes``, v of
    ``v_bytes``, by default the same, and float32 lse and delta) and each
    output written once, in float32 as the kernels write the gradients.
    The function alone needs 10·D a pair: the two-kernel split
    recomputes s and dp."""
    kv = h if kv is None else kv
    v_bytes = dtype_bytes if v_bytes is None else v_bytes
    pairs = float(b * h * live_pairs(t, causal, window))
    io = b * t * d
    rows = 2 * b * h * t * 4                      # lse and delta, f32
    inputs = io * ((2 * h + kv) * dtype_bytes + kv * v_bytes) + rows
    return {"dkv": (8.0 * d * pairs, float(inputs + 2 * io * kv * 4)),
            "dq": (6.0 * d * pairs, float(inputs + io * h * 4))}


#: published dense peaks of one H100 SXM, read from the one table
#: (telemetry/cost.py): float32 FMA on the CUDA cores, TF32 and bf16 on
#: the tensor cores, HBM3 bandwidth
PEAK_F32_FLOPS = _cost.peak_flops("float32", "H100")
PEAK_TF32_FLOPS = _cost.peak_flops("tf32", "H100")
PEAK_BF16_FLOPS = _cost.peak_flops("bfloat16", "H100")
PEAK_HBM_BYTES = _cost.hbm_bandwidth("H100")


def _bounds(flops: float, nbytes: float, inst: str = "f32_f32",
            kernel: str = "fwd") -> Dict[str, float]:
    """A kernel's least time on the card, in ms, for ``flops`` and
    ``nbytes``: ``f32`` with the products on the CUDA cores, ``tc`` with
    them on the tensor cores as the kernel runs them — a product of two
    bf16 operands at the bf16 rate, any other in 3xTF32 (three TF32
    products each) — each the larger of its operations time and the
    bytes over HBM's rate; ``bound_by`` names the side that sets ``tc``.
    ``inst`` and ``kernel`` ("fwd", "dkv" or "dq") say which product
    takes which rate; ``flops`` splits evenly over the products."""
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    prods = _products(inst, kernel)
    per = flops / len(prods)
    t_tc = sum(per / (PEAK_BF16_FLOPS if bf16 else PEAK_TF32_FLOPS / 3)
               for bf16 in prods) * 1e3
    return {"f32": max(flops / PEAK_F32_FLOPS * 1e3, t_bytes),
            "tc": max(t_tc, t_bytes),
            "bound_by": "operations" if t_tc >= t_bytes else "bytes"}


def forward_work(b: int, t: int, h: int, d: int, causal: bool = False,
                 window: int = 0, kv: Optional[int] = None,
                 dtype_bytes: int = 4, v_bytes: Optional[int] = None
                 ) -> Tuple[float, float]:
    """(FLOPs, bytes) the forward kernel needs over this call's live
    pairs: :func:`analytic_cost`'s (4·D FLOPs a pair; q, k, v read once,
    o and lse written once)."""
    return analytic_cost(b, t, h, d, causal, window, kv, dtype_bytes,
                         v_bytes=v_bytes)


def forward_bounds(b: int, t: int, h: int, d: int, causal: bool = False,
                   window: int = 0, kv: Optional[int] = None,
                   inst: str = "f32_f32") -> Dict[str, float]:
    """The forward kernel's least time on the card, in ms, from
    :func:`forward_work` for instance ``inst``: ``f32`` (float32 FMA on
    the CUDA cores) and ``tc`` (on the tensor cores as the kernel runs:
    bf16 products at the bf16 rate, the others in 3xTF32; the one the
    kernel runs against), with ``bound_by``."""
    qk, v = _nbytes(inst)
    return _bounds(*forward_work(b, t, h, d, causal, window, kv, qk, v),
                   inst, "fwd")


def backward_bounds(b: int, t: int, h: int, d: int, causal: bool = False,
                    window: int = 0, kv: Optional[int] = None,
                    inst: str = "f32_f32") -> Dict[str, Dict[str, float]]:
    """Each backward kernel's least time on the card, in ms, from
    :func:`backward_work` for instance ``inst``: ``f32`` with the
    products on the CUDA cores, ``tc`` with them on the tensor cores as
    the kernels run them (bf16 products at the bf16 rate, the others in
    3xTF32), each the larger of its operations time and the bytes over
    HBM's rate. The kernels run against ``tc``; ``bound_by`` names the
    side that sets it."""
    qk, v = _nbytes(inst)
    return {name: _bounds(flops, nbytes, inst, name)
            for name, (flops, nbytes)
            in backward_work(b, t, h, d, causal, window, kv, qk,
                             v).items()}


def tf32_round(x):
    """float32 ``x`` rounded to TF32 (10 explicit mantissa bits) as
    ``cvt.rna.tf32.f32`` rounds: to nearest, ties away from zero, on the
    float32 bit pattern; ±0 and ±inf stay, subnormals round like the
    rest (no flush) and the largest finites overflow to inf. A NaN is not
    rounded (the carry would turn 0x7fffffff into -0): it becomes the
    quiet NaN 0x7fc00000, as the kernels' split makes it. The result is
    float32 with the low 13 bits clear."""
    x = x.float().contiguous()
    bits = (x.view(torch.int32) + 0x1000) & ~0x1FFF
    return torch.where(torch.isnan(x), torch.full_like(x, math.nan),
                       bits.view(torch.float32))


def tf32x3_einsum(eq: str, a, b, passes: int = 3):
    """``torch.einsum(eq, a, b)`` as the kernels take a product on the
    tensor cores: each operand split into hi = tf32(x) and lo =
    tf32(x − hi), then lo·hi + hi·lo + hi·hi summed in float32 (3xTF32);
    ``passes=1`` is the plain TF32 product hi·hi, which the kernels do
    not use (it misses their 1e-4 tolerance)."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    hi = torch.einsum(eq, a_hi, b_hi)
    if passes == 1:
        return hi
    a_lo, b_lo = tf32_round(a.float() - a_hi), tf32_round(b.float() - b_hi)
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
            + hi)


def _check_window(window, causal: bool, t: int) -> int:
    window = int(window or 0)
    if window < 0:
        raise ValueError("window must be >= 1 (or None)")
    if window and not causal:
        raise ValueError("sliding-window attention requires causal=True")
    return 0 if window >= t else window


def _keep(t: int, causal: bool, window: int, device):
    """(T, T) bool mask of the live (query, key) pairs, or None."""
    if not causal:
        return None
    pos = torch.arange(t, device=device)
    rel = pos[:, None] - pos[None, :]
    keep = rel >= 0
    if window:
        keep = keep & (rel < window)
    return keep


def _expand(x, h: int):
    b, t, kv, d = x.shape
    return x[:, :, :, None, :].expand(b, t, kv, h // kv, d).reshape(
        b, t, h, d)


def _scores(q, k, causal: bool, window: int, scale: float,
            einsum=torch.einsum):
    """f32 scaled scores (B, H, T, T) with the masked pairs at NEG_INF."""
    s = einsum("bqhd,bkhd->bhqk", q.float(),
               _expand(k, q.shape[2]).float()) * scale
    keep = _keep(q.shape[1], causal, window, q.device)
    if keep is not None:
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    return s


def _rounded(x, dtype):
    """float32 ``x`` rounded to ``dtype`` (a cast the reference's kernels
    make before a product), as float32."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def kernel_block_k(d: int) -> int:
    """K/V rows the forward kernel streams a step at head dim ``d``
    (``csrc/flash_attention_fwd.cu`` ``launch_for``), counted from key 0:
    the blocks its online softmax takes p's running max over."""
    return 32 if d <= 64 else 16


def _running_max(s, block_k: int):
    """Each score's online-softmax max: its row's max over the blocks of
    ``block_k`` keys from key 0 up to and including its own block."""
    t = s.shape[-1]
    n = -(-t // block_k)
    s = torch.nn.functional.pad(s, (0, n * block_k - t), value=NEG_INF)
    run = s.unflatten(-1, (n, block_k)).amax(-1).cummax(-1).values
    return run.repeat_interleave(block_k, -1)[..., :t]


def flash_attention_fwd_reference(q, k, v, causal: bool = False,
                                  window: Optional[int] = None,
                                  scale: Optional[float] = None,
                                  block_k: Optional[int] = None):
    """Plain torch full-softmax attention returning ``(o, lse)`` — the
    function the kernel computes, with the same masks (causal; window:
    ``q - k < window``), the same f32 scores and the reference kernel's
    rounding: the unnormalised p = exp(s − max) is rounded to v's dtype
    before p·v (a product summed in f32), the row sum stays f32, and o
    takes q's dtype. An online softmax takes p against the running max
    of the K/V blocks seen so far, so a p rounded to bf16 depends on the
    blocks: ``block_k`` keys a block from key 0, as the reference's kernel
    and this port's (:func:`kernel_block_k`) stream them; None, one block
    of the whole row."""
    window = _check_window(window, causal, q.shape[1])
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = _scores(q, k, causal, window, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)                        # (B, H, T, 1)
    if v.dtype == torch.float32 or block_k is None or block_k >= s.shape[-1]:
        pv = _rounded(p, v.dtype)
    else:
        # p rounded against its block's running max, then carried to the
        # row's (a masked score of a block before the row's first live
        # one has p = 1 against NEG_INF, and a carry of 0)
        run = _running_max(s, block_k)
        pv = _rounded(torch.exp(s - run), v.dtype) * torch.exp(run - m)
    o = torch.einsum("bhqk,bkhd->bqhd", pv, _expand(v, q.shape[2]).float())
    o = o / l.permute(0, 2, 1, 3)
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_attention_fwd_tf32(q, k, v, causal: bool = False,
                             window: Optional[int] = None,
                             scale: Optional[float] = None,
                             passes: int = 3):
    """f32 ``(o, lse)`` of :func:`flash_attention_fwd_reference` with both
    products taken as the forward kernel takes them on the tensor cores
    (:func:`tf32x3_einsum`; ``passes=1``: plain TF32): s = q·kᵀ, then the
    unnormalised p = exp(s − max) against v, divided by p's row sum;
    lse = max + log(row sum). A CPU emulation for the tests; no entry point
    calls it."""
    window = _check_window(window, causal, q.shape[1])
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    einsum = functools.partial(tf32x3_einsum, passes=passes)
    s = _scores(q, k, causal, window, scale, einsum)
    m = s.max(dim=-1, keepdim=True).values
    p = torch.exp(s - m)
    keep = _keep(q.shape[1], causal, window, q.device)
    if keep is not None:
        p = torch.where(keep, p, torch.zeros_like(p))
    rowsum = p.sum(-1, keepdim=True)
    o = einsum("bhqk,bkhd->bqhd", p, _expand(v, q.shape[2]).float())
    return (o / rowsum.permute(0, 2, 1, 3),
            (m + torch.log(rowsum))[..., 0])


def _bwd_plain(q, k, v, lse, delta, do, causal: bool, window: int,
               scale: float, einsum=torch.einsum):
    """The backward's function with a full (T, T) f32 recompute: lse and
    delta are (B, H, T); the gradients of grouped k/v sum their query
    heads. p is rounded to do's dtype before pᵀ·do, ds to k's before
    ds·k and to q's before dsᵀ·q, as the reference's kernels cast them;
    every product sums in f32. Returns f32 (dq, dk, dv). ``einsum`` takes
    the five products (:func:`tf32x3_einsum` emulates the kernels'
    tensor-core arithmetic)."""
    b, t, h, d = q.shape
    kv = k.shape[2]
    p = torch.exp(_scores(q, k, causal, window, scale, einsum)
                  - lse[..., None])
    dof = do.float()
    dv = einsum("bhqk,bqhd->bkhd", _rounded(p, do.dtype), dof)
    dp = einsum("bqhd,bkhd->bhqk", dof, _expand(v, h).float())
    ds = p * (dp - delta[..., None]) * scale
    dq = einsum("bhqk,bkhd->bqhd", _rounded(ds, k.dtype),
                _expand(k, h).float())
    dk = einsum("bhqk,bqhd->bkhd", _rounded(ds, q.dtype), q.float())
    g = h // kv
    return (dq, dk.reshape(b, t, kv, g, d).sum(3),
            dv.reshape(b, t, kv, g, d).sum(3))


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal: bool = False,
                                  window: Optional[int] = None,
                                  scale: Optional[float] = None):
    """Plain torch backward of :func:`flash_attention_fwd_reference`:
    ``(dq, dk, dv)`` from the forward's ``o`` and ``lse`` (B, H, T) and
    the upstream gradient ``do``, with ``delta = rowsum(do·o)`` — the
    function the backward kernel pair computes."""
    window = _check_window(window, causal, q.shape[1])
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1)
    dq, dk, dv = _bwd_plain(q, k, v, lse.float(), delta, do, causal, window,
                            scale)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_tf32(q, k, v, o, lse, do, causal: bool = False,
                             window: Optional[int] = None,
                             scale: Optional[float] = None,
                             passes: int = 3):
    """f32 ``(dq, dk, dv)`` of :func:`flash_attention_bwd_reference` with
    every product taken as the backward kernels take it on the tensor
    cores (:func:`tf32x3_einsum`; ``passes=1``: plain TF32). A CPU
    emulation for the tests; no entry point calls it."""
    window = _check_window(window, causal, q.shape[1])
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1)
    return _bwd_plain(q, k, v, lse.float(), delta, do, causal, window, scale,
                      functools.partial(tf32x3_einsum, passes=passes))


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
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError("flash attention runs on cuda or cpu tensors, "
                         "got %s" % q.device)


def _check_kernel_inputs(what: str, *xs) -> str:
    """What every kernel takes: q, k, v (and do) in the dtypes of one of
    its instances (:func:`instance`, which names the one returned), a
    head dim in 1..MAX_D and a contiguous head dim; anything else
    raises."""
    inst = instance(*xs)
    d = xs[0].shape[-1]
    if not supported(d):
        raise ValueError("head dim %d outside the kernel's 1..%d"
                         % (d, MAX_D))
    if any(x.stride(3) != 1 for x in xs):
        raise ValueError("the %s kernel needs a contiguous head dim "
                         "(stride 1)" % what)
    return inst


def _c_fn(source: str, symbol: str, n_ptrs: int):
    """A kernel's C entry point, built and typed at first use: n_ptrs
    pointers, B, T, H, KV, D, the strides, scale, causal, window and the
    stream; it returns cudaGetLastError()."""
    from . import _build
    fn = getattr(_build.load(source), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5
                   + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    return fn


@functools.cache
def _kernel_fn(inst: str):
    return _c_fn(_SOURCE, "veles_flash_attention_fwd_" + inst, 5)


@functools.cache
def _dkv_fn(inst: str):
    return _c_fn(_BWD_SOURCE, "veles_flash_attention_bwd_dkv_" + inst, 8)


@functools.cache
def _dq_fn(inst: str):
    return _c_fn(_BWD_SOURCE, "veles_flash_attention_bwd_dq_" + inst, 7)


def _count(total: str, inst: str) -> None:
    """One launch of a kernel's ``inst`` instance: its total and its
    instance's counters."""
    inc(total)
    inc(launch_counter(total, inst))


def _note_cost(q, k, v, causal: bool, window: int, scale: float = 1.0):
    """Publish a launch's analytic cost (:func:`analytic_cost` at the
    call's shape and operand widths, ``scale`` × the forward's) to the
    active kernel-cost collectors (telemetry/cost.py): the kernel is
    opaque to the FLOP counter, as the Pallas call is to XLA."""
    b, t, h, d = q.shape
    flops, nbytes = analytic_cost(b, t, h, d, causal, window, k.shape[2],
                                  q.element_size(),
                                  v_bytes=v.element_size())
    _cost.note_kernel_cost(_cost.Cost(flops, nbytes).scaled(scale))


def _strides(*xs):
    return (ctypes.c_longlong * (3 * len(xs)))(
        *(s for x in xs for s in x.stride()[:3]))


def _launch(q, k, v, causal: bool, window: int, scale: float):
    """Launch the forward kernel on the current stream: o in q's dtype,
    f32 lse."""
    inst = _check_kernel_inputs("flash_attention_fwd", q, k, v)
    b, t, h, d = q.shape
    fn = _kernel_fn(inst)
    o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v, o)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b, t, h, k.shape[2], d,
                 ctypes.cast(strides, ctypes.c_void_p), float(scale),
                 int(bool(causal)), int(window), stream)
    if err != 0:
        raise RuntimeError("flash_attention_fwd kernel launch failed: "
                           "CUDA error %d" % err)
    _count(FWD_LAUNCHES, inst)
    _note_cost(q, k, v, causal, window)
    return o, lse.view(b, h, t)


def _bwd_operands(q, k, v, do, lse, delta):
    """Checks what the backward kernels take and returns their instance,
    and lse and delta as the contiguous f32 (B*H, T) rows they read."""
    inst = _check_kernel_inputs("flash_attention_bwd", q, k, v, do)
    b, t, h, _ = q.shape
    if do.shape != q.shape:
        raise ValueError("do shape %s does not match q %s"
                         % (tuple(do.shape), tuple(q.shape)))
    return (inst, lse.reshape(b * h, t).to(torch.float32).contiguous(),
            delta.reshape(b * h, t).to(torch.float32).contiguous())


def _bwd_call(fn, name, counter, inst, tensors, q, k, common):
    """One backward kernel's launch on the current stream: pointers of
    ``tensors``, then B, T, H, KV, D, the strides of q, k, v, do and the
    three gradients, scale, causal, window; raises on a refused launch
    and counts a launched one (``counter`` and ``inst``'s)."""
    b, t, h, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(x.data_ptr() for x in tensors), b, t, h, k.shape[2], d,
                 *common, stream)
    if err != 0:
        raise RuntimeError("flash_attention_bwd %s kernel launch failed: "
                           "CUDA error %d" % (name, err))
    _count(counter, inst)


def launch_bwd_dkv(q, k, v, do, lse, delta, causal: bool, window: int,
                   scale: float):
    """The dK/dV kernel: f32 (dk, dv) of grouped k/v (B, T, KV, Dh),
    each kv head summing its query heads in a fixed order. lse and delta
    are (B, H, T) float32."""
    inst, lse, delta = _bwd_operands(q, k, v, do, lse, delta)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    strides = _strides(q, k, v, do, q, dk, dv)     # no dq: q's as filler
    _bwd_call(_dkv_fn(inst), "dK/dV", DKV_LAUNCHES, inst,
              (q, k, v, do, lse, delta, dk, dv), q, k,
              (ctypes.cast(strides, ctypes.c_void_p), float(scale),
               int(bool(causal)), int(window)))
    return dk, dv


def launch_bwd_dq(q, k, v, do, lse, delta, causal: bool, window: int,
                  scale: float):
    """The dQ kernel: f32 dq (B, T, H, Dh), grouped k/v read by index.
    lse and delta are (B, H, T) float32."""
    inst, lse, delta = _bwd_operands(q, k, v, do, lse, delta)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v, do, dq, k, v)      # no dk/dv: k/v's
    _bwd_call(_dq_fn(inst), "dQ", DQ_LAUNCHES, inst,
              (q, k, v, do, lse, delta, dq),
              q, k, (ctypes.cast(strides, ctypes.c_void_p), float(scale),
                     int(bool(causal)), int(window)))
    return dq


def _launch_bwd(q, k, v, do, lse, delta, causal: bool, window: int,
                scale: float):
    """The dK/dV kernel, then the dQ kernel, on the current stream;
    returns f32 (dq, dk, dv). The pair notes the reference's backward
    model: 2.5× the forward's analytic cost (a recompute and four
    gradient products)."""
    dk, dv = launch_bwd_dkv(q, k, v, do, lse, delta, causal, window, scale)
    dq = launch_bwd_dq(q, k, v, do, lse, delta, causal, window, scale)
    _note_cost(q, k, v, causal, window, 2.5)
    return dq, dk, dv


def _prologue(q, k, v, causal, window, scale):
    _check(q, k, v)
    window = _check_window(window, causal, q.shape[1])
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return window, float(scale)


@torch.library.custom_op("veles_tpu_torch::flash_attention_fwd",
                         mutates_args=(), device_types="cuda")
def flash_attention_fwd_op(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, causal: bool, window: int,
                           scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel as a registered operator,
    ``torch.ops.veles_tpu_torch.flash_attention_fwd``: one opaque node in
    a ``torch.export`` program (the serve artifact's prefills, a
    package's ``forward.pt2``), whose CUDA implementation is the launch
    (counted, its cost noted) and whose CPU implementation is the plain
    version. ``window`` is already normalised (0: none) and ``scale``
    resolved; o comes in q's dtype, lse (B, H, T) float32. A process
    that loads such a program imports this module first."""
    return _launch(q, k, v, causal, window, scale)


@flash_attention_fwd_op.register_kernel("cpu")
def _flash_attention_fwd_cpu(q, k, v, causal, window, scale):
    o, lse = flash_attention_fwd_reference(
        q, k, v, causal=causal, window=window, scale=scale,
        block_k=kernel_block_k(q.shape[-1]))
    # the layouts the kernel gives and the fake below promises
    return o.contiguous(), lse.contiguous()


@flash_attention_fwd_op.register_fake
def _flash_attention_fwd_fake(q, k, v, causal, window, scale):
    b, t, h, _ = q.shape
    return (q.new_empty(q.shape),
            q.new_empty((b, h, t), dtype=torch.float32))


def flash_attention_fwd(q, k, v, causal: bool = False,
                        window: Optional[int] = None,
                        scale: Optional[float] = None):
    """``(o (B, T, H, Dh), lse (B, H, T))`` of attention over q and the
    (possibly grouped) k/v, forward only, through the registered
    :func:`flash_attention_fwd_op`. A CUDA tensor goes through the
    hand-written kernel — or raises; a CPU tensor through the plain
    version. Each kernel launch adds one to
    ``veles_flash_attention_launches_total`` and to its instance's
    counter (:func:`launch_counter`)."""
    window, scale = _prologue(q, k, v, causal, window, scale)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        if q.device.type == "cpu":
            # the plain version, under autograd
            return flash_attention_fwd_reference(
                q, k, v, causal=causal, window=window, scale=scale,
                block_k=kernel_block_k(q.shape[-1]))
        # the kernel writes o outside autograd: a backward through it
        # would give q/k/v a zero gradient without a word
        raise VelesError("flash_attention_fwd is forward-only: where q/k/v "
                         "need gradients call flash_attention, whose "
                         "backward runs the dK/dV and dQ kernels")
    return flash_attention_fwd_op(q, k, v, bool(causal), window, scale)


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = False,
                        window: Optional[int] = None,
                        scale: Optional[float] = None):
    """``(dq, dk, dv)`` of attention from the forward's ``o`` and ``lse``
    (B, H, T): on a CUDA tensor ``delta = rowsum(do·o)`` (a torch op, as
    the reference computes it outside its kernels), then the dK/dV and
    dQ kernels — or a raise; on a CPU tensor the plain version. Each
    launch adds one to its counter."""
    window, scale = _prologue(q, k, v, causal, window, scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do,
                                             causal=causal, window=window,
                                             scale=scale)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1)
    dq, dk, dv = _launch_bwd(q, k, v, do, lse, delta, causal, window, scale)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_lse(q, k, v, lse, delta, do, causal: bool = False,
                            scale: Optional[float] = None):
    """The backward pair against an external (global) softmax normalizer:
    f32 ``(dq, dk, dv)`` with ``p = exp(s − lse)``, ``lse`` and
    ``delta = rowsum(do·o)`` given (B, T, H) as the reference's
    ``flash_attention_bwd_lse`` takes them, computed by the caller over
    the full attention (the engine of a ring attention's per-step
    backward). A CUDA tensor launches the kernels or raises; a CPU tensor
    runs the plain version."""
    _, scale = _prologue(q, k, v, causal, None, scale)
    lse = lse.permute(0, 2, 1).float()
    delta = delta.permute(0, 2, 1).float()
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, lse, delta, do, causal, 0, scale)
    return _launch_bwd(q, k, v, do, lse, delta, causal, 0, scale)


class _Flash(torch.autograd.Function):
    """Attention whose forward is the forward kernel (plain version on the
    CPU) and whose backward is the dK/dV then dQ kernels (plain backward
    on the CPU). The saved tensors keep k/v grouped."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        if q.device.type == "cpu":
            o, lse = flash_attention_fwd_reference(
                q, k, v, causal, window, scale, kernel_block_k(q.shape[-1]))
        else:
            o, lse = _launch(q, k, v, causal, window, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, window, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    window: Optional[int] = None):
    """(B, T, H, Dh) × (B, T, KV, Dh) × 2 → (B, T, H, Dh), differentiable:
    the output of :func:`flash_attention_fwd`, with the backward kernel
    pair behind autograd."""
    window, scale = _prologue(q, k, v, causal, window, scale)
    return _Flash.apply(q, k, v, bool(causal), window, scale)

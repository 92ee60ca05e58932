"""Matmul precision policy, the mixed-precision helpers and the int8
quantization primitives (counterpart of
``veles_tpu/ops/precision.py`` ``matmul_precision``,
``promote_operands`` and its int8 primitives, and of the train step's
``_amp_cast``).

A float32 product must be a full float32 product, for parity with the
float32 reference. PyTorch keeps cuBLAS matmuls in full float32 by
default but lets cuDNN run float32 convolutions in TF32 (about three
decimal digits), and lets cuBLAS reduce the split-K partial sums of a
bf16 or float16 product in that type instead of float32; any of these
defaults can be changed by other code in the process. So the policy is
set explicitly, all four switches off: a bf16 product then accumulates in
float32, as the reference's ``preferred_element_type`` states. The port
has no ``compute_dtype`` knob yet: where the reference's default
``compute_dtype="bfloat16"`` takes one bf16 pass over float32 operands
on its TPU, every float32 product here is a full float32 product.
The convolutions (``nn/conv.py``, ``nn/deconv.py``) run through cuDNN
under the same policy: a float32 conv is a full float32 conv, a bf16
one accumulates in float32 and rounds its result to bf16 once.
"""

from __future__ import annotations

import functools

import numpy
import torch


def apply_f32_policy() -> None:
    """Turn TF32 off for cuBLAS matmuls and cuDNN convolutions, and the
    reduced-precision reductions of bf16 and float16 matmuls."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False


def promote_operands(x, w):
    """Both operands of a product cast to their promoted common dtype, and
    that dtype: ``torch.matmul`` refuses an f32 activation times a bf16
    parameter, which ``jnp.dot`` promotes."""
    ct = torch.promote_types(x.dtype, w.dtype)
    return x.to(ct), w.to(ct), ct


def dot(x, w):
    """``x @ w`` with the operands promoted first, as ``jnp.dot`` takes a
    mixed pair: the result has the promoted dtype."""
    x, w, _ = promote_operands(x, w)
    return x @ w


def dot_f32(x, w):
    """``x @ w`` with a float32 result: the reference's ``jnp.dot(...,
    preferred_element_type=float32)``. The operands are widened to
    float32 first — exact for bf16 values, whose products are exact in
    float32 — so the sum is a float32 one on every device, with no
    dependence on a library's mixed-dtype product."""
    return x.float() @ w.float()


def amp_cast(tree):
    """The bf16 view of a (nested dict) tree for mixed precision: float32
    tensors cast to bf16, anything else as it is. Autograd through the
    cast returns float32 gradients to float32 masters."""
    if isinstance(tree, dict):
        return {k: amp_cast(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.float32:
        return tree.to(torch.bfloat16)
    return tree


@functools.lru_cache(maxsize=None)
def _weak(value: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(value, dtype=dtype))


def weak_scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as ``jnp`` takes a Python scalar
    beside an array of that dtype (weak typing). torch multiplies a bf16
    tensor by an unrounded float32 scalar; by this rounded one, the
    product of two bf16 values is exact in float32 and rounds once, as
    the reference's does."""
    return _weak(float(value), dtype)


# -- int8 quantization primitives (veles_tpu_torch/quant/) ------------------
#
# The reference's symmetric linear quantization, bit for bit: q = round(x /
# s) clipped to [-127, 127], x̂ = q · s, with s = max|x| / 127 over the
# reduction group, the amax taken in float32, a true division (not a
# product by 1/s), round-half-to-even, every step in float32. "per_channel"
# keeps one scale per OUTPUT column of a 2-D weight (axis -1), "per_tensor"
# one scalar. A group whose amax is not > 0 gets scale 1: an all-zero group,
# and a group holding a NaN (the amax is NaN). An element that is NaN
# after the division quantizes to 0, as the reference's float → int8
# conversion gives it on the CPU; the port makes that explicit so that the
# card gives the same. So a NaN element becomes 0 and its group's others
# round against scale 1; an infinity makes its group's scale inf and every
# element of the group 0 (finite / inf = 0, inf / inf = NaN), unless a NaN
# shares the group (scale 1: the infinity clips to ±127).

#: symmetric int8 clip bound (−128 is unused so +x and −x quantize
#: symmetrically)
INT8_QMAX = 127.0


def _as_tensor(x):
    """A torch tensor of ``x`` (a tensor as it is, numpy arrays and
    scalars on the CPU)."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, numpy.ndarray) and not x.flags.writeable:
        x = x.copy()        # torch refuses to share a read-only buffer
    return torch.as_tensor(x)


def _to_int8(y):
    """float32 → int8 after the clip; NaN → 0 (the reference's CPU
    conversion)."""
    y = torch.clamp(y, -INT8_QMAX, INT8_QMAX)
    return torch.where(torch.isnan(y), torch.zeros_like(y), y).to(torch.int8)


def _scale_of(amax):
    # the divisor is a tensor on amax's device: CUDA divides a tensor by
    # a Python scalar as a product with its reciprocal, which rounds
    # other scales than the true division the CPU (and the reference)
    # does
    return torch.where(amax > 0, amax / torch.full_like(amax, INT8_QMAX),
                       torch.ones_like(amax)).to(torch.float32)


def torch_dtype(dtype):
    """A torch dtype from a torch dtype, a numpy dtype or a name
    ("float32", "bfloat16")."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = str(getattr(dtype, "name", dtype)).split(".")[-1]
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise TypeError("no torch dtype named %r" % (name,))
    return out


def quantize_int8(arr, axis=None):
    """``arr`` (float) → ``(q int8, scale float32)`` on ``arr``'s device.
    ``axis=None`` = one 0-d scale (per-tensor); ``axis=k`` = per-channel
    scales along that axis, keeping ``arr``'s rank with size-1 reduced
    dims, so ``q * scale`` broadcasts back (a 2-D weight's scale is
    (1, N) for ``axis=-1``)."""
    x = _as_tensor(arr).float()
    if axis is None:
        amax = x.abs().amax() if x.numel() else x.new_zeros(())
    else:
        axis = axis % x.dim()
        red = tuple(i for i in range(x.dim()) if i != axis)
        amax = x.abs().amax(dim=red, keepdim=True)
    scale = _scale_of(amax)
    return _to_int8(torch.round(x / scale)), scale


def dequantize_int8(q, scale, dtype=None):
    """``q · scale`` in float32, then in ``dtype`` (default float32)."""
    out = _as_tensor(q).to(torch.float32) * _as_tensor(scale)
    dtype = torch_dtype(dtype)
    return out if dtype is None else out.to(dtype)


def quantize_rows_int8(x):
    """Per-row symmetric int8 for K/V rows: ``x`` (..., T, H, Dh) →
    ``(q int8, scales (..., T) float32)``, one scale per cached
    position, its amax over the row's (H, Dh) block. Re-quantizing a
    dequantized row with its own scale gives its bits back."""
    x = _as_tensor(x).float()
    scale = _scale_of(x.abs().amax(dim=(-2, -1)))
    return _to_int8(torch.round(x / scale[..., None, None])), scale


def dequantize_rows_int8(q, scale, dtype=None):
    """Inverse of :func:`quantize_rows_int8`: the scales broadcast over
    each position's (H, Dh) block, in float32, then in ``dtype``."""
    out = (_as_tensor(q).to(torch.float32)
           * _as_tensor(scale)[..., None, None])
    dtype = torch_dtype(dtype)
    return out if dtype is None else out.to(dtype)

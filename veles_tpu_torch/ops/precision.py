"""Matmul precision policy and the mixed-precision helpers (counterpart of
``veles_tpu/ops/precision.py`` ``matmul_precision`` and
``promote_operands``, and of the train step's ``_amp_cast``).

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

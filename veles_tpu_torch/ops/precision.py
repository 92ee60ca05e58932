"""Matmul precision policy (counterpart of ``veles_tpu/ops/precision.py``
``matmul_precision``).

This slice runs float32 end to end, for parity with the float32
reference: a float32 product must be a full float32 product. PyTorch
keeps cuBLAS matmuls in full float32 by default but lets cuDNN run
float32 convolutions in TF32 (about three decimal digits), and either
default can be changed by other code in the process — so the policy is
set explicitly, both switches off. Mapping ``compute_dtype=bfloat16``
to bf16 or TF32 is later work.
"""

from __future__ import annotations

import torch


def apply_f32_policy() -> None:
    """Turn TF32 off for cuBLAS matmuls and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

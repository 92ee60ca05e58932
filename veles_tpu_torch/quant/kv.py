"""int8 storage of the continuous engine's paged KV pool (counterpart of
``veles_tpu/quant/kv.py``).

    float block:  (pages, page_size, KV, Dh) K and V      — dtype bytes
    int8  block:  (pages, page_size, KV, Dh) int8 K and V
                  + (pages, page_size) float32 K and V scales

One scale per cached position: the prefill quantizes its prompt rows
once, each decode step writes exactly one new row with a fresh scale,
and no written row is ever re-scaled, so there is no error accumulation
across steps, only the one-time rounding of each row. A page's payload
and its scales go through the same page ids.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.precision import (dequantize_rows_int8,  # noqa: F401
                             quantize_rows_int8)


def block_page_pool(pages: int, page_size: int, n_kv: int, hd: int,
                    dtype, quantized: bool, device=None) -> Tuple:
    """One block's paged pool: float ``(kp, vp)`` shaped ``(pages,
    page_size, n_kv, hd)``, or int8 ``(kq, vq, k_scale, v_scale)`` with
    float32 ``(pages, page_size)`` scales. Zeros throughout: scale 0
    dequantizes an untouched row to exact 0.0, the float pool's starting
    content (and 0 times a NaN left in fresh memory would be NaN)."""
    shape = (pages, page_size, n_kv, hd)
    if not quantized:
        return tuple(torch.zeros(shape, dtype=dtype, device=device)
                     for _ in range(2))
    return (torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros((pages, page_size), dtype=torch.float32,
                        device=device),
            torch.zeros((pages, page_size), dtype=torch.float32,
                        device=device))


def pool_nbytes(caches) -> int:
    """Bytes of a pool, every block's payloads and scales."""
    return int(sum(t.numel() * t.element_size()
                   for block in caches or () for t in block))

"""int8 serving and int8 snapshots (counterpart of ``veles_tpu/quant/``).

Two planes, both off by default and leaving the float path untouched:

- **weights** (:mod:`weights`): per-channel symmetric int8 for the
  serving stack's 2-D matmul weights (``root.common.quant.weights``,
  ``--quant-weights``), dequantized on read just before each product,
  and the offline ``python -m veles_tpu_torch quantize SNAPSHOT``
  whose snapshots any build of either package resumes from;
- **KV pool** (:mod:`kv`): int8 K/V payloads with one float32 scale per
  cached position (``root.common.quant.kv``, ``--quant-kv``): 1,032
  bytes a position of a block's K+V at 8 heads of 64 where float32
  takes 4,096.

The numeric primitives live in ``ops/precision.py``. The reference's
third plane, the AOT serve artifact, is ROADMAP Queue 1 item 4.5.
"""

from __future__ import annotations

from .kv import (block_page_pool, dequantize_rows_int8,  # noqa: F401
                 pool_nbytes, quantize_rows_int8)
from .weights import (GRANULARITIES, DequantView,  # noqa: F401
                      dequantize_params, dequantize_state,
                      is_quantized_params, quantize_params,
                      quantize_params_spec, quantize_state)

#: every counter the quantization and artifact planes increment (the
#: reference's names, registered in telemetry/counters.py); all stay 0
#: in a quant-off run, and the artifact ones until item 4.5
QUANT_COUNTERS = (
    "veles_quant_params_total",
    "veles_quant_bytes_saved_total",
    "veles_quant_calibrations_total",
    "veles_artifact_loads_total",
    "veles_artifact_load_failures_total",
)


def policy() -> dict:
    """The active quantization policy
    (``root.common.quant.{weights,kv,granularity}``) as plain values."""
    from ..config import root
    from .weights import granularity_from_config
    return {
        "weights": bool(root.common.quant.get("weights", False)),
        "kv": bool(root.common.quant.get("kv", False)),
        "granularity": granularity_from_config(),
    }

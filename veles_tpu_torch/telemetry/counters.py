"""Monotonic counters (minimal counterpart of
``veles_tpu/telemetry/counters.py``).

A flat, thread-safe name → value registry. Only registered names can be
incremented, so a typo fails loudly instead of counting into a series
nobody reads.
"""

from __future__ import annotations

import threading
from typing import Dict

#: every counter this package increments, with what one unit means
DESCRIPTIONS: Dict[str, str] = {
    "veles_decode_dispatches_total":
        "host-driven decode programs: one prefill plus one per "
        "further decode step",
    "veles_decode_tokens_total": "tokens decoded (rows x n_new)",
    "veles_flash_attention_launches_total":
        "launches of the hand-written flash-attention forward kernel",
    "veles_flash_attention_bwd_dkv_launches_total":
        "launches of the hand-written flash-attention dK/dV backward "
        "kernel",
    "veles_flash_attention_bwd_dq_launches_total":
        "launches of the hand-written flash-attention dQ backward kernel",
    "veles_fused_fc_launches_total":
        "launches of the hand-written whole-epoch fused-FC SGD kernel "
        "(one per trained epoch on the fused path)",
}


class CounterRegistry:
    """Flat, thread-safe name → value map of monotonic counters."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._values: Dict[str, float] = {}

    def inc(self, name: str, value: float = 1) -> float:
        """Add ``value`` (default 1) to ``name``; returns the new total."""
        if name not in DESCRIPTIONS:
            raise KeyError("unregistered counter %r" % (name,))
        with self._lock:
            new = self._values.get(name, 0) + value
            self._values[name] = new
        return new

    def get(self, name: str) -> float:
        with self._lock:
            return self._values.get(name, 0)

    def reset(self) -> None:
        """Set every counter to 0 (a measurement window's start)."""
        with self._lock:
            self._values.clear()


#: the process-wide registry
counters = CounterRegistry()
inc = counters.inc
get = counters.get

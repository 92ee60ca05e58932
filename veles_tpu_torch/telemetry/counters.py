"""Monotonic counters (minimal counterpart of
``veles_tpu/telemetry/counters.py``).

A flat, thread-safe name → value registry. Only registered names can be
incremented, so a typo fails loudly instead of counting into a series
nobody reads. :func:`metrics_text` renders the registry and a caller's
gauges as the plain-text exposition page behind ``GET /metrics``.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

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
    # continuous-batching serving engine (serving/), the reference's
    # names
    "veles_serving_admitted_total":
        "Requests admitted into continuous-batching KV-cache slots",
    "veles_serving_retired_total":
        "Slot rows retired (eos_id emitted or own n_new reached)",
    "veles_serving_prefill_dispatches_total":
        "Bucketed prefill programs dispatched by the serving engine",
    "veles_serving_decode_dispatches_total":
        "Pooled fixed-shape decode steps dispatched by the serving "
        "engine",
    "veles_serving_tokens_total":
        "Tokens emitted by the continuous-batching engine",
    "veles_serving_queue_wait_seconds_total":
        "Seconds requests waited in the serving queue before a slot",
    "veles_serving_expired_total":
        "Queued generation requests answered 503 past their deadline",
    "veles_serving_pages_alloc_total":
        "KV-cache pages allocated from the paged serving pool "
        "(admission prefills + decode-time growth)",
    "veles_serving_pages_free_total":
        "KV-cache pages returned to the paged serving pool at row "
        "retirement",
    "veles_serving_pages_exhausted_total":
        "Page allocations refused by an exhausted pool (admission "
        "waits; decode-time growth sheds 503 + Retry-After)",
    "veles_shed_requests_total":
        "Requests answered 503 + Retry-After (expired in the queue, or "
        "shed by the serving pool)",
    # the resilience plane (resilience/), the reference's names and
    # HELP strings
    "veles_faults_injected_total":
        "Faults fired by the deterministic injection plane",
    "veles_retries_total":
        "Operations retried by a RetryPolicy (backoff performed)",
    "veles_snapshots_quarantined_total":
        "Corrupt snapshots renamed *.corrupt during chain restore",
    "veles_manifest_cursor_defaults_total":
        "Snapshot manifests read without an {epoch, step, world_size} "
        "cursor (pre-elastic manifests; defaulted, never a crash)",
    # the O(1)-state lane's state-checkpoint prefix cache
    # (serving.O1_COUNTERS, the reference's names and HELP strings); 0
    # until that cache is ported
    "veles_o1_state_checkpoints_total":
        "Recurrent state snapshots cached at page_size-token block "
        "boundaries after a prefill scan (the state lane's prefix-"
        "cache writes)",
    "veles_o1_state_restores_total":
        "Admissions that adopted a cached state checkpoint copy-on-"
        "write and scanned only the unmatched prompt suffix",
    "veles_o1_state_restored_tokens_total":
        "Prompt tokens skipped by adopting state checkpoints instead "
        "of re-scanning them (the restore savings, summed)",
    "veles_o1_state_rescans_total":
        "State restores degraded to a full re-scan from zeros "
        "(injected serve.state_restore checkpoint loss; answers stay "
        "correct, only the scan work is repaid)",
    "veles_o1_state_evictions_total":
        "State-cache checkpoint blocks dropped by LRU leaf eviction "
        "(the soft max_blocks budget)",
}

# each flash kernel's launches also by its (q/k, v) dtype instance
# (ops/flash_attention.instance), so that a run shows which one it took
for _name, _kernel in (("launches", "forward"),
                       ("bwd_dkv_launches", "dK/dV backward"),
                       ("bwd_dq_launches", "dQ backward")):
    for _qk in ("f32", "bf16"):
        for _v in ("f32", "bf16"):
            DESCRIPTIONS["veles_flash_attention_%s_%s_%s_total"
                         % (_name, _qk, _v)] = (
                "launches of the hand-written flash-attention %s kernel "
                "with q/k in %s and v in %s" % (_kernel, _qk, _v))

#: Content-Type of every /metrics reply
METRICS_CONTENT_TYPE = "text/plain; version=0.0.4"


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

    def snapshot(self) -> Dict[str, float]:
        """Point-in-time copy of every counter."""
        with self._lock:
            return dict(self._values)

    def delta(self, before: Dict[str, float]) -> Dict[str, float]:
        """Per-counter growth since a :meth:`snapshot`; counters that
        did not grow are omitted."""
        out = {}
        for k, v in self.snapshot().items():
            d = v - before.get(k, 0)
            if d:
                out[k] = d
        return out

    def reset(self) -> None:
        """Set every counter to 0 (a measurement window's start)."""
        with self._lock:
            self._values.clear()


def _number(value) -> str:
    # integral values print without a trailing .0
    val = float(value)
    return str(int(val)) if val.is_integer() else repr(val)


def metrics_text(gauges: Optional[Dict[str, float]] = None) -> str:
    """The /metrics page in the plain-text exposition format: every
    counter of the registry (one snapshot), then the caller's gauges."""
    lines = []
    for name, val in sorted(counters.snapshot().items()):
        lines += ["# HELP %s %s" % (name, DESCRIPTIONS[name]),
                  "# TYPE %s counter" % name,
                  "%s %s" % (name, _number(val))]
    for name, val in sorted((gauges or {}).items()):
        lines += ["# TYPE %s gauge" % name, "%s %s" % (name, _number(val))]
    return "\n".join(lines) + "\n"


#: the process-wide registry
counters = CounterRegistry()
inc = counters.inc
get = counters.get

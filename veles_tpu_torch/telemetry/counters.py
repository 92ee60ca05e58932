"""Monotonic counters and fixed-bucket histograms (counterpart of
``veles_tpu/telemetry/counters.py``).

A flat, thread-safe name → value registry of counters that count events
the framework itself causes (kernel launches, decode dispatches, served
tokens, spans), so a check on them is exact whatever the clock does, and
its latency twin: fixed-bucket histograms of the serving SLOs. Only
registered names can be incremented or observed, so a typo fails loudly
instead of counting into a series nobody reads. :func:`metrics_text`
renders both registries, each histogram's bucket-derived p50/p90/p99
and a caller's gauges as the plain-text exposition page behind
``GET /metrics``; for the names both packages describe the page is the
reference's, byte for byte.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Tuple

#: every counter this package increments, with what one unit means (the
#: /metrics HELP lines; the reference's wording where it has the name)
DESCRIPTIONS: Dict[str, str] = {
    "veles_unit_runs_total":
        "Unit.run invocations through the workflow scheduler",
    "veles_decode_tokens_total":
        "Tokens emitted by the generation stack",
    "veles_decode_dispatches_total":
        "Device dispatches spent producing those tokens",
    "veles_spans_total":
        "Telemetry spans recorded",
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
    "veles_serving_spec_rounds_total":
        "On-device draft/verify speculation rounds run over slot-pool "
        "rows",
    "veles_serving_beam_steps_total":
        "Fixed-shape beam top-k steps run over slot-pool hypothesis "
        "groups",
    "veles_shed_requests_total":
        "Serving requests shed with 503 + Retry-After",
    "veles_watchdog_trips_total":
        "step_watchdog threshold trips (possible hangs)",
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
    # the elastic training plane (resilience/elastic.py)
    "veles_elastic_generations_total":
        "Elastic training generations started (first generation "
        "included)",
    "veles_elastic_preemptions_total":
        "Host-loss events that ended a generation (heartbeat lapse, "
        "join failure, or an injected distributed.host_loss fault)",
    "veles_elastic_reshard_seconds_total":
        "Seconds spent restoring + resharding state at elastic "
        "generation handoffs",
    "veles_elastic_barrier_timeouts_total":
        "Elastic survivor barriers that failed or timed out",
    # the blocked linear-algebra family (linalg/)
    "veles_linalg_block_ops_total":
        "Host-side blocked linear-algebra dispatches (k-panel dots, "
        "potrf/trsm panels, SUMMA launches) — the linalg.block_op "
        "fault chokepoint",
    "veles_linalg_matmuls_total":
        "Blocked matmuls completed (single-device panel loop or "
        "SUMMA over the 2D mesh)",
    "veles_linalg_factorizations_total":
        "Blocked Cholesky factorizations completed",
    "veles_linalg_solves_total":
        "Linear solves completed (cholesky_solve calls and CG "
        "workflow finishes)",
    "veles_linalg_iterations_total":
        "Conjugate-gradient iterations run (CGStep executions)",
    "veles_linalg_residual_checks_total":
        "verify_residual trusted-path checks performed (|b-Ax|/|b| "
        "against the stated bound)",
    "veles_linalg_residual_failures_total":
        "Residual checks FAILED — the solve raised instead of "
        "returning a silently-wrong answer (chaos corrupt lands here)",
    # the device-time measurement plane (telemetry/devtime.py)
    "veles_devtime_captures_total":
        "Profiler trace captures that yielded device-stream "
        "self-time",
    "veles_devtime_fallbacks_total":
        "Device-time measurements served by the host-sync wall-clock "
        "fallback (profiler unavailable or no device streams)",
    "veles_bench_legacy_sections_total":
        "Gate sections compared on wall-clock because a legacy bench "
        "document carries no device_time_s fields",
    # model-health observability (telemetry/tensormon.py)
    "veles_tensormon_samples_total":
        "Tensor-statistics samples drained from the jitted train step",
    "veles_model_nan_total":
        "Non-finite (NaN/Inf) values detected in gradients, loss or "
        "activations by the tensormon taps",
    "veles_model_health_errors_total":
        "ModelHealthError raised by the NaN sentinel (halt policies)",
    # the flight recorder (telemetry/recorder.py)
    "veles_blackbox_dumps_total":
        "Flight-recorder black-box dumps written",
    # the /metrics renderer below
    "veles_metrics_name_collisions_total":
        "Caller-supplied /metrics gauges dropped because their name "
        "shadowed an already-rendered counter/histogram series "
        "(duplicate names are invalid Prometheus exposition)",
    # the span ring's pull path and JSONL sink (telemetry/spans.py)
    "veles_trace_rotations_total":
        "JSONL --trace-file rotations (the sink grew past "
        "root.common.trace.rotate_bytes; the previous segment is "
        "kept as <path>.1, older ones dropped)",
    "veles_trace_span_pulls_total":
        "Span-ring pulls served over GET /trace/spans (router + "
        "serving APIs; the fleet trace assembler's read path)",
    # int8 serving (quant/) and the serve artifact
    # (export/serve_artifact.py), the reference's names and HELP
    # strings; the quant ones 0 in a quant-off run, the artifact ones
    # without --serve-artifact
    "veles_quant_params_total":
        "Parameter tensors quantized to int8 (per-channel symmetric)",
    "veles_quant_bytes_saved_total":
        "Bytes saved by int8 weight quantization (float minus "
        "int8+scale storage)",
    "veles_quant_calibrations_total":
        "Weight-quantization calibration passes (amax scale scans)",
    "veles_artifact_loads_total":
        "AOT serve-artifacts loaded by the serving engine",
    "veles_artifact_load_failures_total":
        "AOT serve-artifact loads that failed and fell back to "
        "live jit (corrupt/mismatched/injected)",
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
    # token-level resume and drain by handoff (serving/engine.py,
    # serving/recurrent.py; the reference's names and HELP strings)
"veles_resume_tokens_total":
        "Tokens carried into a resumed decode instead of being "
        "re-decoded (the failover savings, summed over resumes)",
"veles_handoff_requests_total":
        "In-flight requests a draining replica handed back with "
        "progress (503 + resume) instead of aborting or riding out "
        "the full generation",
    # the QoS plane (serving/overload.py, the engines' preemption;
    # the reference's names and HELP strings)
"veles_qos_preemptions_total":
        "Batch decode rows preempted at a step boundary to free "
        "slots for waiting interactive requests (the row requeues "
        "with its emitted tokens and resumes bit-identical)",
"veles_qos_preempted_tokens_total":
        "Tokens already decoded by preempted batch rows at the "
        "moment of preemption (all carried through the resume, none "
        "re-decoded)",
"veles_qos_batch_deferrals_total":
        "Queued batch requests jumped by interactive arrivals in the "
        "priority-aware admission order (each deferral counts once "
        "per sweep it was overtaken in)",
"veles_qos_throttled_total":
        "Batch requests refused admission by the router's AIMD "
        "controller or brownout ladder (503 + scaled Retry-After; "
        "interactive is never throttled)",
"veles_qos_brownout_transitions_total":
        "Brownout ladder level changes in either direction "
        "(normal -> cap_n_new -> no_spec -> shed_batch and back)",
"veles_qos_degraded_requests_total":
        "Admitted requests degraded by the brownout ladder (n_new "
        "capped or speculative decoding stripped)",
"veles_qos_retry_denied_total":
        "Failover retries denied by the router-wide retry token "
        "bucket (storm control: failed first attempts still answer, "
        "they just do not amplify)",
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

#: every histogram this package observes: HELP string and FIXED bucket
#: upper bounds (seconds), the reference's. Fixed buckets keep fleet
#: aggregation exact: summing the same bounds across N /metrics
#: endpoints is lossless.
HISTOGRAMS = {
    # request-plane serving SLOs (serving/scheduler.py Ticket
    # accounting)
    "veles_serving_queue_wait_seconds": {
        "help": "Seconds a serving request waited in the queue "
                "before admission (deadline-shed/expired requests "
                "record their full wait)",
        "buckets": (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                    0.5, 1.0, 2.5, 5.0, 10.0, 30.0),
    },
    "veles_serving_ttft_seconds": {
        "help": "Time to first token: request enqueue to the first "
                "generated token (prefill output), per request",
        "buckets": (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                    0.5, 1.0, 2.5, 5.0, 10.0, 30.0),
    },
    "veles_serving_tpot_seconds": {
        "help": "Time per output token after the first (decode "
                "steady-state), per retired request",
        "buckets": (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                    0.05, 0.1, 0.25, 0.5, 1.0),
    },
    "veles_serving_e2e_seconds": {
        "help": "End-to-end serving latency: request enqueue to the "
                "answered ticket, per retired request",
        "buckets": (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                    5.0, 10.0, 30.0, 60.0, 120.0),
    },
}

#: the bucket-derived quantiles metrics_text exposes as gauges
QUANTILE_GAUGES = ((0.5, "p50"), (0.9, "p90"), (0.99, "p99"))

#: Content-Type of every /metrics reply
METRICS_CONTENT_TYPE = "text/plain; version=0.0.4"


def describe_counter(name: str) -> str:
    return DESCRIPTIONS[name]


def describe_histogram(name: str) -> str:
    return HISTOGRAMS[name]["help"]


def histogram_buckets(name: str) -> Tuple[float, ...]:
    if name not in HISTOGRAMS:
        raise KeyError("unregistered histogram %r" % (name,))
    return tuple(HISTOGRAMS[name]["buckets"])


def histogram_quantile(bounds, counts, q: float) -> Optional[float]:
    """Prometheus ``histogram_quantile`` from fixed buckets:
    ``counts[i]`` is the NON-cumulative count of bucket ``bounds[i]``
    (``counts[-1]`` the +Inf overflow). Linear interpolation inside the
    winning bucket; a rank in the overflow bucket reports the largest
    finite bound (the histogram cannot see past it). None when the
    histogram is empty."""
    total = sum(counts)
    if total <= 0:
        return None
    rank = q * total
    cum = 0.0
    for i, cnt in enumerate(counts):
        prev = cum
        cum += cnt
        if cum >= rank and cnt > 0:
            if i >= len(bounds):            # +Inf overflow bucket
                return float(bounds[-1]) if bounds else None
            lower = float(bounds[i - 1]) if i > 0 else 0.0
            upper = float(bounds[i])
            return lower + (upper - lower) * (rank - prev) / cnt
    return float(bounds[-1]) if bounds else None


class HistogramRegistry:
    """Thread-safe fixed-bucket histograms: name → (bucket counts, sum).
    Entries appear on first :meth:`observe`, so an idle process renders
    no histogram rows at all."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        #: name -> per-bucket counts, len(bounds) + 1 (+Inf overflow)
        self._counts: Dict[str, List[int]] = {}
        self._sums: Dict[str, float] = {}
        self._bounds: Dict[str, Tuple[float, ...]] = {}

    def observe(self, name: str, value: float) -> None:
        """Record one sample into ``name``'s fixed buckets."""
        value = float(value)
        with self._lock:
            counts = self._counts.get(name)
            if counts is None:
                bounds = histogram_buckets(name)
                self._bounds[name] = bounds
                counts = self._counts[name] = [0] * (len(bounds) + 1)
                self._sums[name] = 0.0
            counts[bisect.bisect_left(self._bounds[name], value)] += 1
            self._sums[name] += value

    def count(self, name: str) -> int:
        with self._lock:
            return sum(self._counts.get(name, ()))

    def sum(self, name: str) -> float:
        with self._lock:
            return self._sums.get(name, 0.0)

    def snapshot(self) -> Dict[str, Dict]:
        """{name: {bounds, counts, sum, count}} at one instant."""
        with self._lock:
            return {name: {"bounds": self._bounds[name],
                           "counts": tuple(counts),
                           "sum": self._sums[name],
                           "count": sum(counts)}
                    for name, counts in self._counts.items()}

    def quantile(self, name: str, q: float) -> Optional[float]:
        """Bucket-interpolated quantile; None when no samples."""
        with self._lock:
            counts = self._counts.get(name)
            if counts is None:
                return None
            bounds, counts = self._bounds[name], tuple(counts)
        return histogram_quantile(bounds, counts, q)

    def reset(self) -> None:
        """Drop every histogram (a measurement window's start)."""
        with self._lock:
            self._counts.clear()
            self._sums.clear()
            self._bounds.clear()

    def prometheus_text(self, snap: Optional[Dict] = None) -> str:
        """Histogram exposition: cumulative ``_bucket{le=}`` series plus
        ``_sum``/``_count`` per recorded histogram."""
        snap = self.snapshot() if snap is None else snap
        lines = []
        for name in sorted(snap):
            h = snap[name]
            lines.append("# HELP %s %s" % (name, describe_histogram(name)))
            lines.append("# TYPE %s histogram" % name)
            cum = 0
            for bound, cnt in zip(h["bounds"], h["counts"]):
                cum += cnt
                lines.append('%s_bucket{le="%s"} %d'
                             % (name, format(float(bound), "g"), cum))
            lines.append('%s_bucket{le="+Inf"} %d' % (name, h["count"]))
            s = float(h["sum"])
            lines.append("%s_sum %s" % (name, int(s) if s.is_integer()
                                        else round(s, 9)))
            lines.append("%s_count %d" % (name, h["count"]))
        return "\n".join(lines) + "\n" if lines else ""


#: the process-wide histogram registry
histograms = HistogramRegistry()


def observe(name: str, value: float) -> None:
    histograms.observe(name, value)


#: increment observers (the flight recorder's, telemetry/recorder.py):
#: called as ``hook(name, value, new_total)`` after the registry lock is
#: released, exceptions swallowed — an observer can never deadlock or
#: take an instrumented call site down
_inc_hooks = []


def add_inc_hook(fn) -> None:
    if fn not in _inc_hooks:
        _inc_hooks.append(fn)


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
        for hook in _inc_hooks:
            try:
                hook(name, value, new)
            except Exception:       # noqa: BLE001 — observers only
                pass
        return new

    def get(self, name: str) -> float:
        with self._lock:
            return self._values.get(name, 0)

    def snapshot(self) -> Dict[str, float]:
        """Point-in-time copy of every counter."""
        with self._lock:
            return dict(self._values)

    def delta(self, before: Dict[str, float],
              names: Optional[tuple] = None) -> Dict[str, float]:
        """Per-counter growth since a :meth:`snapshot` (over ``names``
        only, when given); counters that did not grow are omitted."""
        now = self.snapshot()
        out = {}
        for k in (names if names is not None else now.keys()):
            d = now.get(k, 0) - before.get(k, 0)
            if d:
                out[k] = d
        return out

    def reset(self) -> None:
        """Set every counter to 0 (a measurement window's start)."""
        with self._lock:
            self._values.clear()

    def prometheus_text(self) -> str:
        """The counters in the exposition format, from one snapshot."""
        lines = []
        for name, val in sorted(self.snapshot().items()):
            lines += ["# HELP %s %s" % (name, describe_counter(name)),
                      "# TYPE %s counter" % name,
                      "%s %s" % (name, int(val) if float(val).is_integer()
                                 else val)]
        return "\n".join(lines) + "\n"


#: the process-wide registry
counters = CounterRegistry()


def gauge_text(name: str, value, help_text: Optional[str] = None) -> str:
    """One gauge in the exposition format."""
    lines = []
    if help_text:
        lines.append("# HELP %s %s" % (name, help_text))
    lines.append("# TYPE %s gauge" % name)
    val = float(value)
    lines.append("%s %s" % (name, int(val) if val.is_integer() else val))
    return "\n".join(lines) + "\n"


def metrics_text(gauges: Optional[dict] = None) -> str:
    """The /metrics page: the counters, the histograms with their
    bucket-estimated p50/p90/p99 gauges, then the caller's gauges
    (name → value, or (value, help)) in the caller's order. A caller
    gauge whose name shadows a series already on the page is dropped
    and counted (``veles_metrics_name_collisions_total``): duplicate
    names are invalid exposition. The collision counter itself shows on
    the next scrape, the counter section being snapshotted already."""
    text = counters.prometheus_text()
    taken = set(counters.snapshot())
    hsnap = histograms.snapshot()
    text += histograms.prometheus_text(hsnap)
    for name in sorted(hsnap):
        taken.update((name, name + "_bucket", name + "_sum",
                      name + "_count"))
        h = hsnap[name]
        if not h["count"]:
            continue
        for q, label in QUANTILE_GAUGES:
            value = histogram_quantile(h["bounds"], h["counts"], q)
            gname = "%s_%s" % (name, label)
            text += gauge_text(gname, round(value, 9),
                               "Bucket-estimated %s of %s" % (label, name))
            taken.add(gname)
    for name, val in (gauges or {}).items():
        if name in taken:
            counters.inc("veles_metrics_name_collisions_total")
            continue
        help_text = None
        if isinstance(val, tuple):
            val, help_text = val
        text += gauge_text(name, val, help_text)
        taken.add(name)
    return text


def inc(name: str, value: float = 1) -> float:
    return counters.inc(name, value)


def get(name: str) -> float:
    return counters.get(name)


def snapshot() -> Dict[str, float]:
    return counters.snapshot()


def prometheus_text() -> str:
    return counters.prometheus_text()

"""Device time: the measurement plane (counterpart of
``veles_tpu/telemetry/devtime.py``).

Device *self-time* — the seconds the card's streams spent executing
kernels, copies and fills — is what a wall clock on a host shared with
other work cannot give. :func:`measure` captures a run with
``torch.profiler`` (CPU and CUDA activities), exports the capture as a
Chrome trace and reads it here:

- :func:`device_events` keeps the device lanes: in a capture of
  ``torch.profiler`` (kineto's format) the complete (``ph == "X"``)
  events of categories ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` in
  the GPU processes (``process_labels`` "GPU N"), one lane per stream
  (``tid``); the GPU lane's ``gpu_user_annotation`` ranges are envelopes
  of those and never count. A trace in the reference's XLA format
  (``/device:…`` processes, "XLA Ops" lanes) is read as the reference
  reads it;
- :func:`device_self_time` interval-unions each stream's events, so
  nested or overlapping events never count twice (two busy streams do
  sum);
- :func:`attribute_spans` maps the device intervals onto the telemetry
  span records (:mod:`~veles_tpu_torch.telemetry.spans`) by time
  overlap.

On the card a capture is the only source: a capture that holds no
device event raises, it never falls back to host time. The counted
host-sync source (``source="host_sync"``, the synced wall time as the
device-time estimate, ``veles_devtime_fallbacks_total``) serves only a
caller that asked for the CPU, as the tests do.

The comparison arithmetic (:func:`compare_sections`) and its tolerances
are the reference's, unchanged.
"""

from __future__ import annotations

import gzip
import json
import logging
import os
import tempfile
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from .counters import inc

log = logging.getLogger("veles_tpu_torch.telemetry")

#: the categories of the device work in a ``torch.profiler`` capture
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

#: the host-side marker :func:`measure` records at a known host time:
#: its CPU event in the capture puts the span clock on the trace clock
ANCHOR = "veles_tpu_torch.devtime.anchor"
#: anchors a capture records; the clocks meet at the tightest
ANCHORS = 3

#: max allowed growth of device_time_per_epoch between two bench
#: documents — the device-time gate's noise tolerance, the reference's
#: value (its drift was measured on its own chips; the port's has not
#: been measured on the card yet)
DEVTIME_TOLERANCE = 1.25

#: wall-clock tolerance for LEGACY sections (documents stamped before
#: the device-time format), the reference's value: it only catches a
#: collapse, and every legacy comparison is counted
LEGACY_TOLERANCE = 8.0


# -- trace-event stream parsing ---------------------------------------------

def load_trace_events(path: str) -> List[Dict[str, Any]]:
    """Load a Chrome trace-event file (``.json`` or ``.json.gz``;
    either a ``{"traceEvents": [...]}`` document or a bare event
    list). A torn/truncated file — a capture killed mid-write — is
    salvaged event by event with ONE counted warning instead of
    raising, mirroring ``spans.read_jsonl``'s hardening: a partial
    trace must still summarize."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read().decode("utf-8", errors="replace")
    try:
        doc = json.loads(raw)
    except ValueError:
        return _salvage_events(raw, path)
    if isinstance(doc, list):
        return [e for e in doc if isinstance(e, dict)]
    if isinstance(doc, dict):
        evs = doc.get("traceEvents", [])
        return [e for e in evs if isinstance(e, dict)]
    raise ValueError("not a trace-event document: %s" % path)


def _salvage_events(raw: str, path: str) -> List[Dict[str, Any]]:
    """Recover the complete event prefix of a truncated trace: scan
    the ``traceEvents`` array (or a bare list) object by object with
    an incremental decoder; stop at the first undecodable tail."""
    start = raw.find("[", max(0, raw.find('"traceEvents"')))
    if start < 0:
        raise ValueError("no traceEvents array found in %s" % path)
    decoder = json.JSONDecoder()
    out: List[Dict[str, Any]] = []
    i = start + 1
    n = len(raw)
    while i < n:
        while i < n and raw[i] in " \t\r\n,":
            i += 1
        if i >= n or raw[i] == "]":
            break
        try:
            obj, end = decoder.raw_decode(raw, i)
        except ValueError:
            break
        if isinstance(obj, dict):
            out.append(obj)
        i = end
    log.warning(
        "salvaged %d complete trace event(s) from torn trace %s "
        "(mid-write truncated tail skipped)", len(out), path)
    return out


def _metadata(events: Iterable[Dict[str, Any]]
              ) -> Tuple[Dict[Any, str], Dict[Tuple[Any, Any], str]]:
    """(process names by pid, thread names by (pid, tid)) from the
    ``ph == "M"`` metadata events (which may trail the data events). A
    process's ``process_labels`` ("GPU 0", "CPU" in a ``torch.profiler``
    capture, where every ``process_name`` is the program's) names it
    over its ``process_name``; thread names lose trailing blanks."""
    procs: Dict[Any, str] = {}
    labels: Dict[Any, str] = {}
    threads: Dict[Tuple[Any, Any], str] = {}
    for ev in events:
        if ev.get("ph") != "M":
            continue
        name = ev.get("name")
        args = ev.get("args") or {}
        if name == "process_name":
            procs[ev.get("pid")] = str(args.get("name", ""))
        elif name == "process_labels":
            labels[ev.get("pid")] = str(args.get("labels", ""))
        elif name == "thread_name":
            threads[(ev.get("pid"), ev.get("tid"))] = \
                str(args.get("name", "")).strip()
    procs.update(labels)
    return procs, threads


def _is_device_process(name: str) -> bool:
    """A device process: XLA's ``/device:TPU:0`` (``/device:GPU:0``),
    or a ``torch.profiler`` capture's "GPU N"; the host shows as
    ``/host:CPU`` or "CPU" plus runtime processes."""
    n = name.lower()
    return ("/device:" in n and "cpu" not in n) or n.startswith("gpu")


def _interval_union_us(intervals: List[Tuple[float, float]]) -> float:
    """Total covered microseconds of possibly nested/overlapping
    ``(start, end)`` intervals — THE self-time primitive: an op event
    nested inside a fusion event (or two overlapping sub-streams of
    one stream) must count its covered time once, not twice."""
    total = 0.0
    end_prev = None
    start_prev = None
    for start, end in sorted(intervals):
        if end_prev is None or start > end_prev:
            if end_prev is not None:
                total += end_prev - start_prev
            start_prev, end_prev = start, end
        elif end > end_prev:
            end_prev = end
    if end_prev is not None:
        total += end_prev - start_prev
    return total


def device_events(events: Iterable[Dict[str, Any]]
                  ) -> List[Dict[str, Any]]:
    """The complete (``ph == "X"``) events that ran on device streams.
    In a ``torch.profiler`` capture: the kernel, memcpy and memset
    events (:data:`DEVICE_CATEGORIES`) of the GPU processes, whatever
    else shares their lanes (``gpu_user_annotation`` envelopes) left
    out. In an XLA trace (no such category): the device processes'
    events and, where a device process names an "XLA Ops" thread, only
    those threads — the other lanes ("XLA Modules", "Steps") are
    ENVELOPES around the same ops and would double the self-time."""
    events = list(events)
    procs, threads = _metadata(events)
    dev_pids = {pid for pid, name in procs.items()
                if _is_device_process(name)}
    kineto = [ev for ev in events if ev.get("ph") == "X"
              and str(ev.get("cat", "")).lower() in DEVICE_CATEGORIES]
    if kineto:
        return [ev for ev in kineto
                if not dev_pids or ev.get("pid") in dev_pids]
    ops_tids = {key for key, name in threads.items()
                if key[0] in dev_pids and "xla ops" in name.lower()}
    ops_pids = {pid for pid, _tid in ops_tids}
    out = []
    for ev in events:
        if ev.get("ph") != "X" or ev.get("pid") not in dev_pids:
            continue
        if ev.get("pid") in ops_pids \
                and (ev.get("pid"), ev.get("tid")) not in ops_tids:
            continue
        out.append(ev)
    return out


def device_self_time(events: Iterable[Dict[str, Any]]
                     ) -> Dict[str, Any]:
    """Per-stream and total device self-time of a trace-event stream:
    ``{"device_time_s", "by_stream": {label: seconds}, "n_events"}``.
    Streams are (device process, thread) pairs; each stream's
    self-time is the interval union of its events, so nesting inside
    one stream never double counts (concurrent streams DO sum — two
    busy cores are two cores' worth of self-time)."""
    events = list(events)
    procs, threads = _metadata(events)
    per: Dict[Tuple[Any, Any], List[Tuple[float, float]]] = {}
    n = 0
    for ev in device_events(events):
        ts = float(ev.get("ts", 0.0))
        dur = float(ev.get("dur", 0.0))
        per.setdefault((ev.get("pid"), ev.get("tid")), []).append(
            (ts, ts + dur))
        n += 1
    by_stream = {}
    total = 0.0
    for (pid, tid), ivals in sorted(per.items(), key=lambda kv: str(kv[0])):
        us = _interval_union_us(ivals)
        label = "%s/%s" % (procs.get(pid, "pid%s" % pid),
                           threads.get((pid, tid), "tid%s" % tid))
        by_stream[label] = by_stream.get(label, 0.0) + us / 1e6
        total += us
    return {"device_time_s": total / 1e6, "by_stream": by_stream,
            "n_events": n}


def attribute_spans(events: Iterable[Dict[str, Any]],
                    span_records: Iterable[Dict[str, Any]],
                    offset_us: Optional[float] = None
                    ) -> Dict[str, Dict[str, float]]:
    """Device self-time per telemetry span NAME: for every span record
    (``{"name", "ts" (epoch s), "dur" (s)}`` — the
    :mod:`~veles_tpu_torch.telemetry.spans` schema), the interval union of
    device-stream events overlapping the span's window, clipped to it.

    The two clocks differ: spans carry host epoch seconds, profiler
    events carry trace-clock microseconds. ``offset_us`` is
    ``device_ts − host_ts·1e6`` for one common instant; when None it
    is estimated by aligning the earliest device event to the
    earliest span start — exact enough when the capture brackets the
    spans (how :func:`measure` uses it), stated here because it IS an
    approximation. Same-name spans aggregate; a parent span's window
    includes its children's (self-time here is *device* self-time per
    span window, not host-tree-exclusive time)."""
    span_records = [r for r in span_records
                    if "name" in r and "ts" in r]
    # device times from the first event's start: at a trace clock of
    # ~1e15 µs a float64 ts + dur keeps only ~0.1 µs, so an event wholly
    # inside a span would count a rounded length, not its dur
    evs = device_events(events)
    base = min((float(e.get("ts", 0.0)) for e in evs), default=0.0)
    devs = [(float(e.get("ts", 0.0)) - base,
             float(e.get("ts", 0.0)) - base + float(e.get("dur", 0.0)))
            for e in evs]
    if offset_us is None:
        if not devs or not span_records:
            return {}
        offset_us = (base
                     - min(float(r["ts"]) for r in span_records) * 1e6)
    out: Dict[str, Dict[str, float]] = {}
    for rec in span_records:
        s0 = float(rec["ts"]) * 1e6 + offset_us - base
        s1 = s0 + float(rec.get("dur", 0.0)) * 1e6
        clipped = [(max(a, s0), min(b, s1)) for a, b in devs
                   if b > s0 and a < s1]
        row = out.setdefault(rec["name"],
                             {"device_time_s": 0.0, "spans": 0,
                              "events": 0})
        row["device_time_s"] += _interval_union_us(clipped) / 1e6
        row["spans"] += 1
        row["events"] += len(clipped)
    return out


# -- capture ------------------------------------------------------------------

def _anchor_offset_us(events: List[Dict[str, Any]], h0,
                      h1: Optional[float] = None) -> Optional[float]:
    """``trace_us − host_epoch_s·1e6`` from the :data:`ANCHOR` events,
    each recorded between two host clock reads: ``h0`` and ``h1`` for one
    anchor, or ``h0`` a sequence of ``(h0, h1)`` brackets, one an anchor
    in recording order. An event's midpoint and its bracket's are one
    instant, to within half the bracket's slack over the event's length;
    the anchor with the least slack is used, since a host stall between
    an anchor and its clock read (a collection, a thread switch) widens
    that anchor's bracket only. None when the capture lacks the events."""
    brackets = [(h0, h1)] if h1 is not None else list(h0)
    anchors = sorted((ev for ev in events if ev.get("ph") == "X"
                      and ev.get("name") == ANCHOR),
                     key=lambda ev: float(ev["ts"]))
    best = None
    for ev, (a, b) in zip(anchors, brackets):
        dur = float(ev.get("dur", 0.0))
        slack = (b - a) * 1e6 - dur
        if best is None or slack < best[0]:
            best = (slack, float(ev["ts"]) + dur / 2 - (a + b) / 2 * 1e6)
    return None if best is None else best[1]


def _by_kernel(events: List[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """Per device-event name: its events and summed device seconds."""
    out: Dict[str, Dict[str, Any]] = {}
    for ev in device_events(events):
        row = out.setdefault(str(ev.get("name", "")),
                             {"events": 0, "device_time_s": 0.0})
        row["events"] += 1
        row["device_time_s"] += float(ev.get("dur", 0.0)) / 1e6
    return out


def measure(fn: Callable[[], Any], sync: Optional[Callable[[], Any]] = None,
            calls: int = 1,
            span_records: Optional[List[Dict[str, Any]]] = None,
            device=None) -> Dict[str, Any]:
    """ONE device-time measurement: run ``fn`` ``calls`` times between
    syncs (default ``torch.cuda.synchronize``) on ``device`` (default
    the card; ``backends.device_for``: raises without one). Returns::

        {"device_time_s", "wall_time_s", "calls", "device_time_per_call",
         "idle_share", "source": "profiler" | "host_sync"
         [, "by_stream", "by_kernel", "clock", "spans"]}

    ``idle_share`` is ``1 − device_time_s / wall_time_s``.

    On the card the run is captured with ``torch.profiler`` (CPU and
    CUDA activities), the exported Chrome trace parsed for device-stream
    self-time (``veles_devtime_captures_total``), per kernel name
    (``by_kernel``: events and summed seconds), and attributed onto the
    telemetry spans that closed in the window (``span_records``;
    default: the global span recorder's records from the window) under
    ``spans``. The two clocks meet at :data:`ANCHOR`, markers recorded
    between two host clock reads each inside the capture, the tightest of
    :data:`ANCHORS` (``clock: "anchor"``); a capture without it falls back to the reference's
    earliest-event estimate (``clock: "estimated"``). A capture that
    holds no device event raises :class:`~veles_tpu_torch.error.
    VelesError`: nothing on the card falls back to host time.

    On the CPU (``device="cpu"``) the synced wall time IS the device
    time, stamped ``source="host_sync"`` and counted
    (``veles_devtime_fallbacks_total``)."""
    from ..backends import device_for
    from ..error import VelesError
    dev = device_for(device)
    calls = max(1, int(calls))
    if sync is None:
        import torch
        sync = ((lambda: torch.cuda.synchronize(dev))
                if dev.type == "cuda" else (lambda: None))
    if dev.type != "cuda":
        sync()
        t0 = time.time()
        for _ in range(calls):
            fn()
        sync()
        wall = time.time() - t0
        inc("veles_devtime_fallbacks_total")
        return {"device_time_s": wall, "wall_time_s": wall,
                "calls": calls, "device_time_per_call": wall / calls,
                "idle_share": 0.0, "source": "host_sync"}
    from torch.profiler import ProfilerActivity, profile, record_function
    sync()
    t_epoch0 = time.time()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        brackets = []
        for _ in range(ANCHORS):
            h0 = time.time()
            with record_function(ANCHOR):
                pass
            brackets.append((h0, time.time()))
        t0 = time.time()
        for _ in range(calls):
            fn()
        sync()
        wall = time.time() - t0
    fd, path = tempfile.mkstemp(prefix="veles_devtime_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = load_trace_events(path)
    finally:
        os.remove(path)
    parsed = device_self_time(events)
    if parsed["n_events"] == 0 or parsed["device_time_s"] <= 0:
        raise VelesError(
            "devtime: the torch.profiler capture on %s holds no device "
            "event (%d events in all): CUPTI traced nothing, and host "
            "time is no stand-in for device time" % (dev, len(events)))
    inc("veles_devtime_captures_total")
    out = {"device_time_s": parsed["device_time_s"], "wall_time_s": wall,
           "calls": calls,
           "device_time_per_call": parsed["device_time_s"] / calls,
           "idle_share": 1.0 - parsed["device_time_s"] / wall,
           "source": "profiler", "by_stream": parsed["by_stream"],
           "by_kernel": _by_kernel(events)}
    offset = _anchor_offset_us(events, brackets)
    out["clock"] = "anchor" if offset is not None else "estimated"
    if span_records is None:
        from .spans import recorder as _span_recorder
        span_records = [r for r in _span_recorder.records()
                        if r.get("ts", 0) >= t_epoch0]
    if span_records:
        out["spans"] = attribute_spans(events, span_records, offset)
    return out


# -- gate arithmetic ----------------------------------------------------------

def section_invariants(name: str, sec: Dict[str, Any]) -> List[str]:
    """Harness invariants every devtime section record must satisfy —
    what the gate proves on CPU CI, where timing ratios are
    meaningless: fields present, positive device time, wall ≥ device
    (minus float slack), a known source."""
    failures = []
    for key in ("device_time_s", "wall_time_s", "source",
                "device_time_per_epoch"):
        if key not in sec:
            failures.append("%s: devtime record lacks %s" % (name, key))
    if failures:
        return failures
    if not sec["device_time_s"] > 0:
        failures.append("%s: device_time_s = %r (must be > 0)"
                        % (name, sec["device_time_s"]))
    if sec["wall_time_s"] < sec["device_time_s"] * 0.999:
        failures.append(
            "%s: wall_time_s %.6f < device_time_s %.6f — device "
            "self-time cannot exceed the synced wall window"
            % (name, sec["wall_time_s"], sec["device_time_s"]))
    if sec["source"] not in ("profiler", "host_sync"):
        failures.append("%s: unknown devtime source %r"
                        % (name, sec["source"]))
    return failures


def compare_sections(name: str, base: Optional[Dict[str, Any]],
                     cur: Optional[Dict[str, Any]],
                     base_rate: Optional[float] = None,
                     cur_rate: Optional[float] = None,
                     timing: bool = True,
                     tolerance: float = DEVTIME_TOLERANCE) -> List[str]:
    """The device-time gate for one section pair; returns failure
    strings (empty = pass).

    - both carry devtime records → harness invariants always; the
      ``device_time_per_epoch`` ratio may not exceed ``tolerance``
      when ``timing`` (False on CPU/smoke documents, where the gate
      proves invariants only);
    - the CURRENT doc lost the record while the baseline has it →
      fail (format regression);
    - a LEGACY side (pre-devtime ``BENCH_*.json``) → counted
      ``veles_bench_legacy_sections_total`` warning and a wall-clock
      rate comparison at :data:`LEGACY_TOLERANCE` (throughput may not
      collapse below baseline/tolerance), so old baselines neither
      crash the gate nor silently stop gating."""
    failures: List[str] = []
    if cur is not None:
        failures += section_invariants(name, cur)
    if base is None or cur is None:
        if base is not None and cur is None:
            failures.append(
                "%s: current document lost its devtime record while "
                "the baseline has one — the device-time format must "
                "not regress" % name)
            return failures
        # legacy pairing: count + wall-clock fallback
        inc("veles_bench_legacy_sections_total")
        log.warning(
            "devtime gate: section %s compared on wall-clock only "
            "(legacy document without device_time_s)", name)
        if base_rate and cur_rate is not None \
                and cur_rate < base_rate / tolerance_legacy():
            failures.append(
                "%s: legacy wall-clock rate collapsed %.1f -> %.1f "
                "(> %.1fx, beyond even relay weather)"
                % (name, base_rate, cur_rate, tolerance_legacy()))
        return failures
    if failures or not timing:
        return failures
    b = base.get("device_time_per_epoch")
    c = cur.get("device_time_per_epoch")
    if not b or c is None:
        return failures
    ratio = float(c) / float(b)
    if ratio > tolerance + 1e-9:
        failures.append(
            "%s: device_time_per_epoch regressed %.6fs -> %.6fs "
            "(%.3fx > %.2fx tolerance)" % (name, b, c, ratio, tolerance))
    return failures


def tolerance_legacy() -> float:
    return LEGACY_TOLERANCE

"""Span JSONL → Chrome ``trace_event`` JSON, Perfetto-viewable
(counterpart of ``veles_tpu/telemetry/chrome_trace.py``).

Complete ("X") events carry each span's duration, thread and counter
deltas in ``args``, plus counter ("C") tracks for the counters spans
carry (kernel launches, decode dispatches), so the timeline shows
accounting next to wall time. Format reference: the "Trace Event
Format" spec (Google); only the stable subset below is emitted. The
reference's multi-process ``fleet_trace_events`` is not ported yet.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, List

from . import spans

#: trace_event phases this exporter emits (and the validator accepts)
PHASES = ("X", "C", "M")


def _lane_events(recs: List[Dict[str, Any]], pid: int, t0: float
                 ) -> List[Dict[str, Any]]:
    """One process lane's data events: every span record becomes a
    complete ("X") event on lane ``pid``, timestamps µs relative to
    ``t0`` (epoch seconds). Counter ("C") tracks plot RUNNING TOTALS:
    each span record carries the counter's delta over that span;
    Perfetto wants the cumulative series, so accumulate in record
    order (the recorder ring appends at span end — chronological in
    end time). Top-level spans only: a nested span's delta is already
    inside its ancestors' deltas, so summing every depth would
    multiply-count."""
    events: List[Dict[str, Any]] = []
    running: Dict[str, float] = {}
    for rec in recs:
        args = {k: v for k, v in rec.items()
                if k not in ("name", "ts", "dur", "tid", "sid",
                             "seq", "parent", "depth")}
        ev = {
            "name": str(rec["name"]),
            "cat": str(rec.get("cat", "veles")),
            "ph": "X",
            "ts": (float(rec["ts"]) - t0) * 1e6,
            "dur": max(float(rec.get("dur", 0.0)), 0.0) * 1e6,
            "pid": pid,
            "tid": int(rec.get("tid", 0)),
            "args": args,
        }
        events.append(ev)
        if rec.get("depth", 0) != 0:
            continue
        for key, val in (rec.get("counters") or {}).items():
            running[key] = running.get(key, 0) + val
            events.append({
                "name": key, "ph": "C", "pid": pid,
                "ts": (float(rec["ts"]) - t0 + float(
                    rec.get("dur", 0.0))) * 1e6,
                "args": {key: running[key]},
            })
    return events


def to_trace_events(records: Iterable[Dict[str, Any]]
                    ) -> List[Dict[str, Any]]:
    """Span records (spans.py dicts) → trace_event list. Timestamps
    become microseconds relative to the earliest span so Perfetto's
    timeline starts at ~0 instead of the unix epoch."""
    recs = [r for r in records if "ts" in r and "name" in r]
    if not recs:
        return []
    t0 = min(float(r["ts"]) for r in recs)
    pid = os.getpid()
    events: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": "veles_tpu_torch"},
    }]
    events += _lane_events(recs, pid, t0)
    return events


def export(jsonl_path: str, out_path: str,
           request_id: str = None) -> int:
    """Read span JSONL, write a Chrome trace JSON; returns the number
    of spans exported. ``request_id`` keeps only the spans tagged
    with that serving request's id (the per-request lifecycle spans
    the Ticket emits plus any engine span carrying the tag) — one
    request's timeline without hand-grepping the JSONL. Raises
    ValueError when the input has no spans (an empty trace silently
    loading as a blank Perfetto page helps nobody)."""
    records = spans.read_jsonl(jsonl_path)
    if request_id is not None:
        # the shared correlation predicate: request_id OR trace_id —
        # one flag serves both "this replica's request" and "this
        # fleet trace's local spans", agreeing with blackbox inspect
        records = [r for r in records
                   if spans.matches_request(r, request_id)]
        if not records:
            raise ValueError(
                "no span records tagged request_id=%s in %s"
                % (request_id, jsonl_path))
    if not records:
        raise ValueError("no span records in %s" % jsonl_path)
    doc = {"traceEvents": to_trace_events(records),
           "displayTimeUnit": "ms"}
    errors = validate(doc)
    if errors:        # exporter bug, not user input — fail loudly
        raise ValueError("invalid trace produced: %s" % errors[:3])
    with open(out_path, "w") as f:
        json.dump(doc, f)
    return len(records)


def validate(doc: Any) -> List[str]:
    """Schema check against the trace_event subset this module emits
    (what the tests gate on): returns a list of violations, empty when
    the document is loadable by Perfetto."""
    errors: List[str] = []
    if not isinstance(doc, dict):
        return ["top level must be a JSON object"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents must be a list"]
    for i, ev in enumerate(events):
        where = "traceEvents[%d]" % i
        if not isinstance(ev, dict):
            errors.append("%s: not an object" % where)
            continue
        if not isinstance(ev.get("name"), str) or not ev.get("name"):
            errors.append("%s: missing name" % where)
        ph = ev.get("ph")
        if ph not in PHASES:
            errors.append("%s: bad phase %r" % (where, ph))
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                errors.append("%s: bad ts %r" % (where, ts))
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append("%s: bad dur %r" % (where, dur))
        if ph == "C" and not isinstance(ev.get("args"), dict):
            errors.append("%s: counter event needs args" % where)
        if not isinstance(ev.get("pid", 0), int):
            errors.append("%s: pid must be int" % where)
        if not isinstance(ev.get("tid", 0), int):
            errors.append("%s: tid must be int" % where)
    return errors

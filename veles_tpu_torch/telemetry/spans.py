"""Spans: nested timing intervals with counter deltas (counterpart of
``veles_tpu/telemetry/spans.py``; same record schema, switch and ring).

A span brackets one piece of framework work — a unit's ``run``, a
workflow's scheduler pass, one epoch block of the train step, a serving
prefill or decode step — and records, besides wall time, the counter
deltas of that interval: how many hand-written kernels were launched
and how many decode programs dispatched inside it. Nesting is tracked
per thread so the JSONL stream reconstructs the call tree, and
:mod:`~veles_tpu_torch.telemetry.chrome_trace` converts it to Chrome
``trace_event`` JSON for Perfetto; :mod:`~veles_tpu_torch.telemetry.
devtime` maps the card's kernel time onto span names.

A span is host-only: opening or closing one reads the host clock and
the counter registry, never a tensor, and never synchronises the card,
so a traced run queues exactly the device work an untraced one does.

Usage::

    with span("unit.run", unit="loader"):
        ...
    @spanned("decode")
    def decode(...): ...

The recorder keeps an in-memory ring (one deque append per span) and
optionally streams JSONL to a file (``set_sink``). Span records are
plain dicts::

    {"name": ..., "ts": ..., "dur": ..., "depth": ..., "parent": ...,
     "sid": ..., "tid": ..., "counters": {...}, ...attrs}
"""

from __future__ import annotations

import collections
import functools
import itertools
import json
import os
import threading
import time
from typing import Any, Deque, Dict, Iterable, List, Optional, Tuple

from .counters import counters

#: counters whose per-span deltas ride in every span record: the
#: hand-written kernels' launches and the decode dispatches (the port's
#: device programs); the rest of the registry is process-global only (a
#: span that launched nothing carries no counter keys at all)
SPAN_COUNTERS = ("veles_flash_attention_launches_total",
                 "veles_flash_attention_bwd_dkv_launches_total",
                 "veles_flash_attention_bwd_dq_launches_total",
                 "veles_fused_fc_launches_total",
                 "veles_decode_dispatches_total")

_ids = itertools.count(1)

#: span-close observers installed by the flight recorder
#: (telemetry/recorder.py): called with the completed record AFTER the
#: ring lock is released; exceptions swallowed.
_close_hooks = []


def add_close_hook(fn) -> None:
    if fn not in _close_hooks:
        _close_hooks.append(fn)


#: cached config NODE (not values): the root.common.trace node is
#: stable, so caching it keeps the per-span knob lookups to one dict get
#: while config writes stay immediately visible
_cfg_node = None


def _cfg(name: str, default):
    global _cfg_node
    try:
        if _cfg_node is None:
            from ..config import root
            _cfg_node = root.common.trace
        return _cfg_node.get(name, default)
    except Exception:            # noqa: BLE001 — config not importable
        return default


def _cfg_int(name: str, default: int) -> int:
    """Integer config knob, malformed values degraded to the default:
    these lookups sit on the span APPEND path, where an operator's
    ``span_ring = "64k"`` must not turn every instrumented ``with
    span(...)`` exit in the tree into a ValueError."""
    value = _cfg(name, default)
    if value is None:
        return default
    try:
        return int(value)            # 0 stays 0 — "disabled" knobs
    except (TypeError, ValueError):
        return default


def _enabled() -> bool:
    """THE span on/off switch (``root.common.trace.spans``), honored
    centrally by the recorder so every instrumented site — Unit.run,
    workflow.run/initialize, the train step, the decoders, the serving
    engines and the request lifecycle — obeys one knob."""
    return bool(_cfg("spans", True))


class _Frame:
    __slots__ = ("name", "sid", "t0", "before", "attrs", "disabled")

    def __init__(self, name, sid, t0, before, attrs, disabled=False):
        self.name, self.sid, self.t0 = name, sid, t0
        self.before, self.attrs = before, attrs
        self.disabled = disabled


class SpanRecorder:
    """Ring of completed span records + optional JSONL file sink.

    The ring is the span plane's bounded black box (the span twin of
    the flight recorder's 4096-event discipline): long-running
    serving replicas keep their recent spans pullable over
    ``GET /trace/spans?since=CURSOR`` without ever needing a sink
    file. Every appended record carries a process-
    monotonic ``seq`` — the pull cursor — and the ring's capacity
    follows ``root.common.trace.span_ring`` (default 65536)."""

    def __init__(self, maxlen: int = 65536,
                 follow_config: bool = False) -> None:
        self._lock = threading.Lock()
        self._ring: Deque[Dict[str, Any]] = collections.deque(
            maxlen=maxlen)
        self._file = None
        self._path: Optional[str] = None
        self._tls = threading.local()
        #: process-monotonic append sequence — the /trace/spans cursor
        self._seq = 0
        #: bytes appended to the current sink file (rotation ledger)
        self._sink_bytes = 0
        #: True only on the process-global instance: the ring tracks
        #: the root.common.trace.span_ring capacity knob (explicit
        #: capacities — tests — stay fixed)
        self._follow_config = follow_config

    # -- sink ----------------------------------------------------------------
    def set_sink(self, path: Optional[str]) -> None:
        """Stream completed spans as JSON lines to ``path`` (append);
        None closes the sink. The in-memory ring keeps recording either
        way."""
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None
                self._path = None
            if path:
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                # LINE buffered: each record reaches the fd whole at
                # its newline, so another handle appending to the same
                # file can never interleave mid-JSON-line
                self._file = open(path, "a", buffering=1)
                self._path = path
                try:
                    self._sink_bytes = os.path.getsize(path)
                except OSError:
                    self._sink_bytes = 0

    @property
    def sink_path(self) -> Optional[str]:
        return self._path

    # -- span lifecycle ------------------------------------------------------
    def _stack(self) -> List[_Frame]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def begin(self, name: str, **attrs: Any) -> _Frame:
        if not _enabled():
            # disabled: hand back an inert frame (attrs writes land in
            # a discarded dict) — no stack push, no counter snapshot
            return _Frame(name, 0, 0.0, {}, attrs, disabled=True)
        frame = _Frame(name, next(_ids), time.time(),
                       counters.snapshot(), attrs)
        self._stack().append(frame)
        return frame

    def end(self, frame: _Frame) -> Dict[str, Any]:
        if frame.disabled:
            return {}
        stack = self._stack()
        # pop through to our frame: a leaked child (generator never
        # closed, exception path) must not corrupt later nesting
        while stack and stack[-1] is not frame:
            stack.pop()
        if stack:
            stack.pop()
        rec: Dict[str, Any] = {
            "name": frame.name,
            "ts": frame.t0,
            "dur": time.time() - frame.t0,
            "depth": len(stack),
            "parent": stack[-1].sid if stack else None,
            "sid": frame.sid,
            "tid": threading.get_ident(),
        }
        delta = counters.delta(frame.before, SPAN_COUNTERS)
        if delta:
            rec["counters"] = delta
        rec.update(frame.attrs)
        self._append(rec)
        return rec

    def _append(self, rec: Dict[str, Any]) -> None:
        """Shared tail of :meth:`end`/:meth:`emit`: stamp the pull
        cursor, honor the ring-capacity knob, append, stream to the
        sink (rotating past ``root.common.trace.rotate_bytes``), then
        run the close hooks outside the lock."""
        counters.inc("veles_spans_total")
        rotated = False
        with self._lock:
            if self._follow_config:
                # honor a changed span_ring knob (the global instance
                # is built at import, before any config lands)
                want = _cfg_int("span_ring", self._ring.maxlen)
                if want > 0 and want != self._ring.maxlen:
                    self._ring = collections.deque(self._ring,
                                                   maxlen=want)
            self._seq += 1
            rec["seq"] = self._seq
            self._ring.append(rec)
            if self._file is not None:
                line = json.dumps(rec, default=str) + "\n"
                self._file.write(line)
                # BYTE ledger (set_sink/rotation reseed it from
                # getsize): json.dumps ASCII-escapes by default, but
                # default=str stringifies arbitrary attrs — count
                # encoded bytes, not code points
                self._sink_bytes += len(line.encode("utf-8"))
                rotated = self._maybe_rotate_locked()
        if rotated:
            counters.inc("veles_trace_rotations_total")
        for hook in _close_hooks:
            try:
                hook(rec)
            except Exception:       # noqa: BLE001 — observers only
                pass

    def _maybe_rotate_locked(self) -> bool:
        """Rotate the JSONL sink once it grows past
        ``root.common.trace.rotate_bytes`` (default 64 MiB; 0
        disables): the full segment moves to ``<path>.1`` — dropping
        the previous ``.1``, the journal's segment-drop pattern — and
        a fresh file opens at ``<path>``, so a long-running serving
        process's trace file is bounded by ~2x the knob instead of
        growing with traffic history. Counted
        ``veles_trace_rotations_total`` (by the caller, outside the
        lock)."""
        limit = _cfg_int("rotate_bytes", 64 << 20)
        if limit <= 0 or self._sink_bytes < limit \
                or self._file is None or self._path is None:
            return False
        try:
            self._file.close()
            os.replace(self._path, self._path + ".1")
            self._file = open(self._path, "a", buffering=1)
            self._sink_bytes = 0
            return True
        except OSError:
            # a failed rotation must not kill span recording: reopen
            # the (possibly still-present) sink and keep appending
            try:
                self._file = open(self._path, "a", buffering=1)
                self._sink_bytes = os.path.getsize(self._path)
            except OSError as e:
                # double failure (disk gone, permissions flipped):
                # the sink is DEAD — say so and stop reporting it as
                # active, instead of silently dropping every span
                import logging
                logging.getLogger("veles_tpu_torch.telemetry").warning(
                    "trace sink %s lost during rotation (%s: %s) — "
                    "span file streaming stops; the in-memory ring "
                    "keeps recording", self._path,
                    type(e).__name__, e)
                self._file = None
                self._path = None
            return False

    def emit(self, name: str, ts: float, dur: float,
             **attrs: Any) -> Dict[str, Any]:
        """Record an ALREADY-MEASURED interval as a completed span —
        the retrospective twin of begin/end, for timelines assembled
        from host timestamps after the fact (the per-request lifecycle
        spans the serving plane emits at ticket terminal: queue wait,
        prefill, decode — each tagged ``request_id`` so
        ``chrome_trace.export(..., request_id=ID)`` renders one
        request's timeline).
        No nesting (depth 0) and no counter deltas: the interval was
        not bracketed live, so attributing registry deltas to it would
        be a lie. Honors the ``root.common.trace.spans`` switch."""
        if not _enabled():
            return {}
        rec: Dict[str, Any] = {
            "name": name,
            "ts": float(ts),
            "dur": max(float(dur), 0.0),
            "depth": 0,
            "parent": None,
            "sid": next(_ids),
            "tid": threading.get_ident(),
        }
        rec.update(attrs)
        self._append(rec)
        return rec

    # -- introspection -------------------------------------------------------
    def records(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            recs = list(self._ring)
        if name is not None:
            recs = [r for r in recs if r["name"] == name]
        return recs

    def cursor(self) -> int:
        """The current pull cursor (the newest record's seq) without
        copying any records — for callers that only want a position
        to pull *from* later."""
        with self._lock:
            return self._seq

    def records_since(self, cursor: int
                      ) -> Tuple[List[Dict[str, Any]], int]:
        """(records appended after ``cursor``, the new cursor) — the
        incremental read behind ``GET /trace/spans?since=CURSOR``. A
        cursor older than the ring's tail silently skips the evicted
        records (bounded ring, same contract as the flight
        recorder); cursor 0 returns everything still buffered."""
        cursor = int(cursor)
        out: List[Dict[str, Any]] = []
        with self._lock:
            # seq climbs with ring order: walk from the newest end
            # and stop at the cursor, so an incremental pull near
            # the tip never scans the whole 65536-record ring under
            # the lock the append path shares
            for rec in reversed(self._ring):
                if int(rec.get("seq", 0)) <= cursor:
                    break
                out.append(rec)
            nxt = self._seq
        out.reverse()
        return out, nxt

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def to_jsonl(self, path: str) -> int:
        """Dump the ring as JSON lines; returns the record count."""
        recs = self.records()
        with open(path, "w") as f:
            for rec in recs:
                f.write(json.dumps(rec, default=str) + "\n")
        return len(recs)


#: THE process-global recorder (mirrors counters.counters).
recorder = SpanRecorder(follow_config=True)

#: process-unique instance token for the /trace/spans header: pids
#: are per-HOST, so a multi-host fleet can hold two distinct
#: processes with one pid — the fleet assembler groups on this token
#: (falling back to pid for payloads from older builds) so they
#: never merge into one lane or steal each other's clock offset
import uuid as _uuid                                    # noqa: E402

instance_id = _uuid.uuid4().hex[:12]


def pull_payload(since: int = 0, name: str = "") -> str:
    """The ``GET /trace/spans?since=CURSOR`` response body: one JSONL
    header line identifying the process (pid, service name, the new
    cursor, this host's wall clock at render time) followed by one
    line per span record appended after ``since``. JSONL on purpose —
    a response torn mid-record (dead replica, truncated read)
    salvages line by line exactly like :func:`read_jsonl`, instead of
    one torn JSON document losing everything. Served by
    ``GenerationAPI``; the reference's fleet trace assembler reads it.
    Counted ``veles_trace_span_pulls_total``."""
    recs, cursor = recorder.records_since(since)
    header = {"kind": "spans.header", "pid": os.getpid(),
              "instance": instance_id,
              "name": str(name or ""), "cursor": cursor,
              "wall": time.time(), "spans": len(recs)}
    counters.inc("veles_trace_span_pulls_total")
    return "\n".join(json.dumps(r, default=str)
                     for r in [header] + recs) + "\n"


class span:
    """``with span("name", key=val): ...`` — records one span on the
    global recorder. Re-entrant and thread-safe; exceptions still close
    the span (flagged ``error=True``)."""

    def __init__(self, name: str, **attrs: Any) -> None:
        self._name, self._attrs = name, attrs
        self.record: Optional[Dict[str, Any]] = None

    def __enter__(self) -> "span":
        self._frame = recorder.begin(self._name, **self._attrs)
        return self

    def __exit__(self, exc_type, *exc: Any) -> None:
        if exc_type is not None:
            self._frame.attrs["error"] = True
        self.record = recorder.end(self._frame)


def matches_request(record: Dict[str, Any], request: str) -> bool:
    """Does a span record / flight event belong to one serving
    request? Matches the ``request_id`` OR the fleet ``trace_id`` tag
    — THE one correlation predicate ``chrome_trace.export`` and
    ``recorder.inspect`` share, so the two views can never disagree on
    which records tell a request's story."""
    rid = str(request)
    return str(record.get("request_id")) == rid \
        or str(record.get("trace_id")) == rid


def emit(name: str, ts: float, dur: float, **attrs: Any
         ) -> Dict[str, Any]:
    """Module-level :meth:`SpanRecorder.emit` on the global recorder
    (mirrors :class:`span`)."""
    return recorder.emit(name, ts, dur, **attrs)


def spanned(name: Optional[str] = None, **attrs: Any):
    """Decorator form: ``@spanned("phase")`` or bare ``@spanned()``
    (span named after the function)."""
    def deco(fn):
        span_name = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any):
            with span(span_name, **attrs):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Load span records back from a JSONL file (skips lines that are
    not span records, so a file shared with logger events loads too).
    Lines that fail to parse at all — a mid-write-truncated tail, a
    torn append — are skipped with ONE counted warning instead of
    raising: a partially-written trace must still export."""
    out = []
    bad = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                bad += 1
                continue
            if isinstance(rec, dict) and "name" in rec and "ts" in rec:
                out.append(rec)
    if bad:
        import logging
        logging.getLogger("veles_tpu_torch.telemetry").warning(
            "skipped %d malformed JSONL line(s) in %s (empty or "
            "mid-write truncated records)", bad, path)
    return out


def tree(records: Iterable[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Reconstruct nesting: returns root records with ``children``
    lists attached (records are shallow-copied; input order kept)."""
    by_sid: Dict[Any, Dict[str, Any]] = {}
    roots: List[Dict[str, Any]] = []
    for rec in records:
        node = dict(rec)
        node["children"] = []
        by_sid[node.get("sid")] = node
    for node in by_sid.values():
        parent = by_sid.get(node.get("parent"))
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    return roots

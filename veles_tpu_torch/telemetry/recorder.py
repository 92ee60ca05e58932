"""Flight recorder: the crash black box (counterpart of
``veles_tpu/telemetry/recorder.py``; the same dump format, which either
package's :func:`inspect` reads).

A bounded, thread-safe ring (default 4096 events) subscribed to the
observability surfaces that exist:

- **span closes** (:mod:`~veles_tpu_torch.telemetry.spans` close hook) —
  every completed ``unit.run`` / ``workflow.run`` / serving span;
- **alarm-counter increments** (:mod:`~veles_tpu_torch.telemetry.
  counters` inc hook) — fault injections, shed requests, snapshot
  quarantines — plus any single increment of at least
  ``root.common.telemetry.recorder.counter_threshold``;
- **request lifecycle events** noted by the serving scheduler
  (``flight.note("request", ...)``).

On an unhandled ``Workflow.run`` exception or SIGTERM the ring dumps to
``blackbox-<ts>_<pid>.jsonl`` in the snapshot directory; crash-path
dumps honor ``root.common.telemetry.recorder.autodump`` (default off:
test suites raise through ``Workflow.run`` on purpose all the time).
The reference also subscribes to its logger's events; the port's
logger has none.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

from ..config import root
from .counters import add_inc_hook as _add_inc_hook
from .counters import inc as _counter_inc
from .spans import add_close_hook as _add_close_hook
# the ONE request-correlation predicate (spans.py owns it), re-exported
# as the black box's face of it
from .spans import matches_request                    # noqa: F401

#: default ring capacity (events)
DEFAULT_CAPACITY = 4096

#: counters whose EVERY increment is a flight-recorder event — the
#: "something went wrong" set, the reference's less the planes not
#: ported (watchdog, side-plane, tensormon); ordinary accounting
#: counters only record at or above ``counter_threshold``
ALARM_COUNTERS = frozenset((
    "veles_faults_injected_total",
    "veles_shed_requests_total",
    "veles_snapshots_quarantined_total",
))

#: cached config NODE (not values): config writes stay immediately
#: visible while the per-event lookup is one dict get
_cfg_node = None


def _cfg(name: str, default):
    global _cfg_node
    try:
        if _cfg_node is None:
            _cfg_node = root.common.telemetry.recorder
        return _cfg_node.get(name, default)
    except Exception:        # noqa: BLE001 — config not importable
        return default


class FlightRecorder:
    """Bounded, thread-safe ring of observability events + dump."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 follow_config: bool = False) -> None:
        self._lock = threading.Lock()
        self._ring: Deque[Dict[str, Any]] = collections.deque(
            maxlen=int(capacity))
        self._recorded = 0
        self._sigterm_installed = False
        #: True only on the process-global instance: tracks the
        #: root.common.telemetry.recorder.capacity knob
        self._follow_config = follow_config

    # -- recording -----------------------------------------------------------
    def enabled(self) -> bool:
        return bool(_cfg("enabled", True))

    def note(self, kind: str, **data: Any) -> None:
        """Append one event to the ring (newest wins once full)."""
        if not self.enabled():
            return
        rec = {"kind": kind, "t": time.time()}
        rec.update(data)
        with self._lock:
            if self._follow_config:
                want = int(_cfg("capacity", self._ring.maxlen)
                           or self._ring.maxlen)
                if want > 0 and want != self._ring.maxlen:
                    self._ring = collections.deque(self._ring,
                                                   maxlen=want)
            self._ring.append(rec)
            self._recorded += 1

    def records(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            recs = list(self._ring)
        if kind is not None:
            recs = [r for r in recs if r.get("kind") == kind]
        return recs

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"recorded": self._recorded,
                    "buffered": len(self._ring),
                    "capacity": self._ring.maxlen}

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._recorded = 0

    # -- dumping -------------------------------------------------------------
    def dump(self, reason: str, directory: Optional[str] = None,
             path: Optional[str] = None) -> str:
        """Write the ring as ``blackbox-<ts>_<pid>.jsonl`` (header line
        first) into ``directory`` (default: the snapshot directory).
        Atomic: tmp write + fsync + rename."""
        from ..resilience.faults import fire as fire_fault
        # the `recorder.dump` injection point: raise/crash exercise the
        # "black box itself fails" path, corrupt damages the dump bytes
        fault = fire_fault("recorder.dump")
        with self._lock:
            events = list(self._ring)
        if path is None:
            if directory is None:
                directory = str(root.common.dirs.snapshots)
            os.makedirs(directory, exist_ok=True)
            base = os.path.join(directory, "blackbox-%s_%d" % (
                time.strftime("%Y%m%d_%H%M%S"), os.getpid()))
            # a second dump in the same second must not replace the
            # first's forensics
            path, n = base + ".jsonl", 1
            while os.path.exists(path):
                n += 1
                path = "%s-%d.jsonl" % (base, n)
        else:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        header = {"kind": "blackbox.header", "reason": reason,
                  "t": time.time(), "pid": os.getpid(),
                  "events": len(events)}
        data = ("\n".join(json.dumps(r, default=str)
                          for r in [header] + events) + "\n").encode()
        if fault is not None:
            data = fault.corrupt(data)
        tmp = path + ".tmp"
        with open(tmp, "wb") as fout:
            fout.write(data)
            fout.flush()
            os.fsync(fout.fileno())
        os.replace(tmp, path)
        _counter_inc("veles_blackbox_dumps_total")
        logging.getLogger("veles_tpu_torch.telemetry").warning(
            "flight recorder black box -> %s (%d events; reason: %s)",
            path, len(events), reason)
        return path

    def autodump_enabled(self) -> bool:
        return bool(_cfg("autodump", False))

    def crash_dump(self, reason: str) -> Optional[str]:
        """The crash-path dump: a no-op unless ``autodump`` is armed,
        and NEVER raises — the black box must not mask the crash it is
        documenting."""
        if not self.autodump_enabled():
            return None
        try:
            return self.dump(reason)
        except Exception as e:        # noqa: BLE001 — see docstring
            logging.getLogger("veles_tpu_torch.telemetry").warning(
                "flight recorder dump failed (%s: %s)",
                type(e).__name__, e)
            return None

    # -- SIGTERM -------------------------------------------------------------
    def install_sigterm(self) -> bool:
        """Chain a SIGTERM handler that crash-dumps before the previous
        disposition runs. Main thread only; True when installed."""
        if self._sigterm_installed:
            return True
        import signal
        if threading.current_thread() is not threading.main_thread():
            return False
        prev = signal.getsignal(signal.SIGTERM)

        def handler(signum, frame):
            self.crash_dump("SIGTERM")
            if callable(prev):
                prev(signum, frame)
            elif prev is signal.SIG_IGN:
                return          # keep the previously-ignored fate
            else:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        try:
            signal.signal(signal.SIGTERM, handler)
        except (ValueError, OSError):
            return False
        self._sigterm_installed = True
        return True


#: the process-global flight recorder
flight = FlightRecorder(follow_config=True)


# -- black-box file access ----------------------------------------------------

def read_blackbox(path: str) -> Tuple[Optional[Dict[str, Any]],
                                      List[Dict[str, Any]]]:
    """(header, events) from a black-box dump; malformed lines are
    skipped (a dump written mid-crash may be torn)."""
    header: Optional[Dict[str, Any]] = None
    events: List[Dict[str, Any]] = []
    with open(path, errors="replace") as fin:
        for line in fin:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if not isinstance(rec, dict):
                continue
            if rec.get("kind") == "blackbox.header" and header is None:
                header = rec
            else:
                events.append(rec)
    return header, events


def inspect(path: str, request: Optional[str] = None) -> Dict[str, Any]:
    """Summary of a black-box dump: reason, event count, per-kind
    counts, covered time range; ``request`` narrows the view to one
    request's events (request_id or trace_id)."""
    header, events = read_blackbox(path)
    total = len(events)
    if request is not None:
        events = [e for e in events if matches_request(e, request)]
    by_kind: Dict[str, int] = {}
    for rec in events:
        kind = str(rec.get("kind", "?"))
        by_kind[kind] = by_kind.get(kind, 0) + 1
    times = [r["t"] for r in events if isinstance(r.get("t"), (int, float))]
    out = {
        "path": path,
        "reason": (header or {}).get("reason"),
        "dumped_at": (header or {}).get("t"),
        "pid": (header or {}).get("pid"),
        "events": len(events),
        "by_kind": by_kind,
        "span_seconds": (round(max(times) - min(times), 3)
                         if len(times) > 1 else 0.0),
    }
    if request is not None:
        out["request"] = str(request)
        out["events_total"] = total
    return out


# -- subscriptions ------------------------------------------------------------

def _on_counter(name: str, value: float, total: float) -> None:
    if name in ALARM_COUNTERS:
        flight.note("counter", counter=name, delta=value, total=total)
        return
    thr = _cfg("counter_threshold", 0)
    if thr and value >= float(thr):
        flight.note("counter", counter=name, delta=value, total=total)


def _on_span_close(rec: Dict[str, Any]) -> None:
    ev = {"name": rec.get("name"), "dur": rec.get("dur"),
          "tid": rec.get("tid")}
    for key in ("unit", "workflow", "error", "steps", "counters"):
        if key in rec:
            ev[key] = rec[key]
    flight.note("span", **ev)


_add_inc_hook(_on_counter)
_add_close_hook(_on_span_close)

"""Workflow: unit container, scheduler and results root (counterpart of
``veles_tpu/workflow.py``).

The scheduler is a deterministic, serial, gate-driven loop in Python:
breadth-first from ``start_point`` until the ``EndPoint`` runs. It is
cheap because the compute inside a step unit is a few device calls
that cover a whole minibatch plan or epoch block.
"""

from __future__ import annotations

import collections
import hashlib
import inspect
import time
from typing import Any, Dict, List, Optional

from .error import Bug
from .mutable import Bool
from .plumbing import EndPoint, StartPoint
from .units import Unit


class Workflow(Unit):
    """Container of units; itself a Unit so workflows nest."""

    hide_from_registry = True

    def __init__(self, workflow=None, **kwargs):
        self._units: List[Unit] = []
        max_steps = kwargs.pop("max_steps", None)
        super().__init__(workflow, **kwargs)
        self.stopped = Bool(False)
        self.start_point = StartPoint(self)
        self.end_point = EndPoint(self)
        self._run_time = 0.0
        #: safety valve: raise after this many scheduler steps
        self._max_steps = max_steps
        #: set by ``snapshotter.resume``/``restore_latest``
        self.restored_from_snapshot = False

    # -- container protocol -------------------------------------------------
    def add_ref(self, unit: Unit) -> None:
        if unit is not self and unit not in self._units:
            self._units.append(unit)

    def del_ref(self, unit: Unit) -> None:
        if unit in self._units:
            self._units.remove(unit)
            unit.unlink_all()

    @property
    def units(self) -> List[Unit]:
        return list(self._units)

    def __iter__(self):
        return iter(self._units)

    def __len__(self):
        return len(self._units)

    def __getitem__(self, name: str) -> Unit:
        for u in self._units:
            if u.name == name:
                return u
        raise KeyError(name)

    def units_in_dependency_order(self) -> List[Unit]:
        """Breadth-first from start_point over control links; units not
        reachable from it come last."""
        seen: Dict[Unit, None] = {}
        queue = collections.deque([self.start_point])
        while queue:
            u = queue.popleft()
            if u in seen:
                continue
            seen[u] = None
            for v in sorted(u.links_to, key=lambda x: x.name):
                queue.append(v)
        for u in self._units:
            if u not in seen:
                seen[u] = None
        return list(seen)

    # -- lifecycle ----------------------------------------------------------
    def initialize(self, **kwargs) -> Optional[bool]:
        """Initialise units in dependency order; a unit returning True is
        re-queued until the pending set stops shrinking."""
        pending = self.units_in_dependency_order()
        while pending:
            again: List[Unit] = []
            for u in pending:
                if u.initialize(**kwargs):
                    again.append(u)
            if len(again) == len(pending):
                missing = {u.name: u.verify_demands() for u in again}
                raise Bug("initialization deadlock; unsatisfied demands: "
                          "%s" % missing)
            pending = again
        self._initialized = True
        return None

    def run(self) -> None:
        """Process units breadth-first from start_point until stopped."""
        if not self._initialized:
            raise Bug("workflow %s run before initialize" % self.name)
        self.stopped <<= False
        # an interrupted previous run may have left join gates half open
        for u in self._units:
            u._reset_fired()
        t0 = time.time()
        queue = collections.deque([self.start_point])
        steps = 0
        try:
            while queue and not bool(self.stopped):
                unit = queue.popleft()
                for downstream in unit.process():
                    if bool(self.stopped):
                        break
                    if downstream.open_gate(unit):
                        queue.append(downstream)
                steps += 1
                if self._max_steps is not None and steps > self._max_steps:
                    raise Bug("workflow %s exceeded max_steps=%d" %
                              (self.name, self._max_steps))
        finally:
            self._run_time += time.time() - t0

    def on_workflow_finished(self) -> None:
        """Called by the EndPoint: stop the loop, then every unit."""
        self.stopped <<= True
        for u in self._units:
            u.stop()

    def stop(self) -> None:
        self.stopped <<= True

    def gather_results(self) -> Dict[str, Any]:
        """Metrics of every unit exposing ``get_metric_values``."""
        results: Dict[str, Any] = {}
        for u in self._units:
            getter = getattr(u, "get_metric_values", None)
            if callable(getter):
                results.update(getter())
        return results

    def checksum(self) -> str:
        """sha256 of the workflow class's source (the reference's
        snapshot identity; the unit names when the source is not
        available)."""
        try:
            src = inspect.getsource(type(self))
        except (OSError, TypeError):
            src = repr(sorted(u.name for u in self._units))
        return hashlib.sha256(src.encode()).hexdigest()

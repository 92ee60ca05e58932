"""Unit: the dataflow node of the framework (counterpart of
``veles_tpu/units.py``; framework-agnostic Python).

A unit has control links (``link_from``), attribute links
(``link_attrs``), demanded attributes (``demand``) and a lifecycle
(``initialize``/``run``/``stop``). The unit graph is the authoring and
orchestration layer: per-minibatch compute happens inside step units
(``nn/train_step.py``), and the gate/link machinery runs in plain Python
between steps.

Gate semantics:

- ``gate_block``   — when True the unit neither runs nor propagates;
- ``gate_skip``    — when True the unit does not run but still propagates;
- ``ignores_gate`` — run as soon as any upstream fires, not all.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterable, List, Optional, Set

from .error import BadUnitLink, Bug
from .logger import Logger
from .mutable import Bool, LinkableAttribute


class UnitRegistry(type):
    """Metaclass census of every unit class; ``mapping`` resolves the
    layer-type names of ``StandardWorkflow`` configs (``MAPPING``)."""

    units: Set[type] = set()
    #: name → class for units registered with ``MAPPING``
    mapping: Dict[str, type] = {}

    def __init__(cls, name, bases, clsdict):
        super().__init__(name, bases, clsdict)
        if not clsdict.get("hide_from_registry", False):
            UnitRegistry.units.add(cls)
        mapping = clsdict.get("MAPPING")
        if mapping:
            existing = UnitRegistry.mapping.get(mapping)
            if existing is not None and existing.__name__ != name:
                raise Bug("duplicate unit MAPPING %r (%s vs %s)" %
                          (mapping, existing.__name__, name))
            UnitRegistry.mapping[mapping] = cls


class Unit(Logger, metaclass=UnitRegistry):
    """A node in a Workflow graph."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs) -> None:
        super().__init__()
        self.name: str = kwargs.pop("name", type(self).__name__)
        self.view_group: str = kwargs.pop("view_group", "PLUMBING")
        self.gate_block = Bool(False)
        self.gate_skip = Bool(False)
        self.ignores_gate = Bool(kwargs.pop("ignores_gate", False))
        #: upstream control edges: unit → fired flag
        self.links_from: Dict["Unit", bool] = {}
        #: downstream control edges
        self.links_to: Set["Unit"] = set()
        self._demanded: Set[str] = set()
        self._initialized = False
        self.timers: Dict[str, float] = {"run": 0.0}
        self.run_count = 0
        self.workflow = workflow
        if workflow is not None:
            workflow.add_ref(self)

    # -- graph wiring -------------------------------------------------------
    def link_from(self, *units: "Unit") -> "Unit":
        """Add control edges ``unit → self``."""
        for u in units:
            if u is self:
                raise BadUnitLink("%s: cannot link to itself" % self.name)
            self.links_from[u] = False
            u.links_to.add(self)
        return self

    def unlink_from(self, *units: "Unit") -> "Unit":
        for u in units:
            self.links_from.pop(u, None)
            u.links_to.discard(self)
        return self

    def unlink_all(self) -> None:
        for u in list(self.links_from):
            self.unlink_from(u)
        for u in list(self.links_to):
            u.unlink_from(self)

    def link_attrs(self, other: "Unit", *mappings: Any,
                   two_way: bool = False) -> "Unit":
        """Alias attributes of ``other`` into self: each mapping is either
        ``"attr"`` or ``("my_attr", "their_attr")``."""
        for m in mappings:
            mine, theirs = (m, m) if isinstance(m, str) else m
            LinkableAttribute.link(self, mine, other, theirs,
                                   two_way=two_way)
        return self

    def demand(self, *attrs: str) -> None:
        """Declare attributes that must be non-None by initialize time."""
        self._demanded.update(attrs)

    # -- lifecycle ----------------------------------------------------------
    @property
    def is_initialized(self) -> bool:
        return self._initialized

    def verify_demands(self) -> List[str]:
        return [a for a in sorted(self._demanded)
                if getattr(self, a, None) is None]

    def initialize(self, **kwargs) -> Optional[bool]:
        """Prepare to run. Return True to be re-queued after the rest of
        the graph has initialised (partial initialisation)."""
        missing = self.verify_demands()
        if missing:
            self.debug("%s: waiting for demanded attrs %s", self.name,
                       missing)
            return True
        self._initialized = True
        return None

    def run(self) -> None:
        """One unit of work, in Python, between device steps."""

    def stop(self) -> None:
        """Cooperative cancellation hook."""

    # -- gate machinery -----------------------------------------------------
    def open_gate(self, src: "Unit") -> bool:
        """Record that ``src`` fired; True when self may proceed."""
        if src not in self.links_from:
            raise Bug("%s notified by non-upstream %s" % (self.name,
                                                          src.name))
        self.links_from[src] = True
        if bool(self.ignores_gate) or all(self.links_from.values()):
            self._reset_fired()
            return True
        return False

    def _reset_fired(self) -> None:
        for k in self.links_from:
            self.links_from[k] = False

    def process(self) -> Iterable["Unit"]:
        """Run (honouring gates) and return the downstream units to
        notify, in name order so the scheduler is deterministic."""
        if bool(self.gate_block):
            return ()
        if not bool(self.gate_skip):
            t0 = time.time()
            self.run()
            self.timers["run"] += time.time() - t0
            self.run_count += 1
        return tuple(sorted(self.links_to, key=lambda u: u.name))

    def __repr__(self) -> str:
        return "<%s %r>" % (type(self).__name__, self.name)


class TrivialUnit(Unit):
    """A unit that does nothing when run (a join point)."""

    hide_from_registry = True

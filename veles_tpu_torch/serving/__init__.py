"""The port's serving plane (counterpart of ``veles_tpu/serving/``):
request tickets and the slot scheduler (``scheduler.py``), the paged KV
pool's allocator (``pages.py``), the continuous-batching engine
(``engine.py``) and the O(1)-state lane for recurrent stacks
(``recurrent.py``)."""

from __future__ import annotations

import threading
from typing import Dict

from ..error import VelesError

#: process-global registry of live engines (one occupancy gauge set per
#: engine)
_engines: Dict[str, "ContinuousEngine"] = {}
_engines_lock = threading.Lock()


def register_engine(engine: "ContinuousEngine") -> None:
    with _engines_lock:
        _engines[engine.name] = engine


def unregister_engine(engine: "ContinuousEngine") -> None:
    with _engines_lock:
        if _engines.get(engine.name) is engine:
            del _engines[engine.name]


def engines() -> Dict[str, "ContinuousEngine"]:
    """name → live engine snapshot."""
    with _engines_lock:
        return dict(_engines)


#: the counters of the O(1)-state lane's state-checkpoint prefix cache,
#: the reference's names (registered in telemetry/counters.py); they
#: stay 0 until that cache is ported
O1_COUNTERS = (
    "veles_o1_state_checkpoints_total",
    "veles_o1_state_restores_total",
    "veles_o1_state_restored_tokens_total",
    "veles_o1_state_rescans_total",
    "veles_o1_state_evictions_total",
)


def parse_buckets(spec) -> tuple:
    """Prefill bucket lengths from config/CLI: a sequence of ints or a
    comma-separated string ("16,32,64"); sorted, deduplicated."""
    if isinstance(spec, str):
        spec = [s for s in (part.strip() for part in spec.split(","))
                if s]
    buckets = sorted({int(b) for b in spec})
    if not buckets or buckets[0] < 1:
        raise VelesError("serving buckets must be positive ints, got %r"
                         % (spec,))
    return tuple(buckets)


from .engine import ContinuousEngine, make_request  # noqa: E402,F401
from .recurrent import (RecurrentEngine, generate_recurrent,  # noqa: E402,F401
                        split_recurrent_stack)

"""Resilience plane of the port (counterpart of
``veles_tpu/resilience/``): the parts the snapshot plane needs.

- :mod:`faults` — the deterministic, seeded fault-injection plane
  (``VELES_FAULTS`` / ``root.common.resilience.faults``);
- :mod:`retry` — :class:`~veles_tpu_torch.resilience.retry.RetryPolicy`
  (exponential backoff + full jitter), which the sqlite snapshot sink
  retries its insert with;
- :mod:`checkpoint_chain` — crash-safe snapshots: fsync'd commits,
  SHA-256 sidecar manifests, verification at load, newest-valid restore
  past quarantined ``*.corrupt`` files, ``keep_last`` pruning.

The reference's health, elastic and overlap parts are not ported yet.
"""

from __future__ import annotations

from .faults import (FaultInjected, FaultPlane, fire,     # noqa: F401
                     list_points, parse_spec, plane, register_point)
from .retry import RetryPolicy, TransientError            # noqa: F401
from .checkpoint_chain import (SnapshotCorruptError,      # noqa: F401
                               chain, cursor_of, load_latest,
                               prune, quarantine,
                               restore_latest, verify)

#: the counters this plane increments (telemetry/counters.py)
RESILIENCE_COUNTERS = (
    "veles_faults_injected_total",
    "veles_retries_total",
    "veles_snapshots_quarantined_total",
    "veles_manifest_cursor_defaults_total",
)

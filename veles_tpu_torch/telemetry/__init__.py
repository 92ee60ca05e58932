"""Telemetry of the port (counterpart of ``veles_tpu/telemetry``):

- :mod:`counters` — process-wide counter and histogram registries and
  the ``/metrics`` page;
- :mod:`spans` — nested host-side spans with counter deltas, a ring
  pulled over ``GET /trace/spans`` and an optional JSONL sink;
- :mod:`recorder` — the flight recorder (crash black box);
- :mod:`chrome_trace` — span JSONL → Chrome ``trace_event`` JSON;
- :mod:`cost` — FLOPs/bytes of a call, the kernels' analytic costs and
  the card's peaks;
- :mod:`devtime` — device self-time from a ``torch.profiler`` capture,
  attributed to span names.

Not ported yet: ``tensormon``, ``timeseries``, ``alerts``, ``fleet``.

As in the reference, the package attribute ``recorder`` is the SPAN
recorder instance; import the flight recorder by full path
(``veles_tpu_torch.telemetry.recorder``). Unlike the reference's, the
package attribute ``counters`` stays the MODULE (``counters.get``,
``counters.counters``), as the port has always had it.
"""

from __future__ import annotations

from .counters import (describe_counter, inc,                    # noqa: F401
                       prometheus_text, snapshot)
# the flight-recorder MODULE must import before the span-recorder
# INSTANCE below: loading a submodule binds the package attribute
# ``recorder`` to the module; the next line rebinds it to the
# SpanRecorder instance, the reference's export
from .recorder import FlightRecorder, flight                      # noqa: F401
from .spans import span, spanned, SpanRecorder, recorder          # noqa: F401
from .cost import Cost, CostModel, peak_bf16_flops                # noqa: F401

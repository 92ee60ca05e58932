"""Model-health taps and the NaN sentinel (counterpart of
``veles_tpu/telemetry/tensormon.py``).

The statistics are torch scalars on the step's device, computed from
values the train step already has (the parameters before and after the
update, the gradients, the loss and the head's output), and summed into
the same device accumulators as the step's metrics. They reach the host
only with the per-epoch metric drain that happens anyway: the taps add
no synchronising call. With ``root.common.telemetry.tensormon.enabled``
off (the default) the step runs the same code as without them.

Per drained sample the monitor derives the global gradient L2 norm
(per-step RMS over the drained window), per-layer weight norms and
update/weight ratios, NaN/Inf counts over the gradients, the loss and
the head's output, and the share of head activations at or above
``sat_threshold``. They go to a ``tensormon.sample`` span, the flight
recorder and the ``veles_model_*`` gauges (:meth:`TensorMonitor.gauges`
for ``counters.metrics_text``); NaN detections count
``veles_model_nan_total``.

The NaN sentinel (``root.common.telemetry.tensormon.nan_policy``):

- ``warn`` — log and count, training continues;
- ``halt`` — mark ``model_health`` unready (``/readyz`` 503), dump the
  flight recorder, raise :class:`ModelHealthError`;
- ``snapshot_and_halt`` — first commit a snapshot through the
  workflow's Snapshotter (the checkpoint chain), then halt.
"""

from __future__ import annotations

import logging
import math
import re
import threading
from typing import Any, Dict, List, Optional

import torch

from ..config import root
from ..error import VelesError
from .counters import inc


class ModelHealthError(VelesError):
    """Raised by the NaN sentinel (policy ``halt`` or
    ``snapshot_and_halt``) when the train step saw non-finite values."""


#: accepted nan_policy values
POLICIES = ("warn", "halt", "snapshot_and_halt")

#: key prefix of the monitor's accumulator entries: the train step adds
#: them only when monitoring is on and strips them from the drained
#: metrics before the Decision sees them
MON_PREFIX = "mon_"


def enabled() -> bool:
    """``root.common.telemetry.tensormon.enabled`` (default False)."""
    try:
        return bool(root.common.telemetry.tensormon.get("enabled", False))
    except Exception:        # noqa: BLE001 — no config tree
        return False


def settings() -> Dict[str, Any]:
    """The resolved knobs; a bad policy raises at initialize, not at
    the first NaN."""
    node = root.common.telemetry.tensormon
    policy = str(node.get("nan_policy", "warn") or "warn")
    if policy not in POLICIES:
        raise VelesError(
            "root.common.telemetry.tensormon.nan_policy %r is not one "
            "of %s" % (policy, "/".join(POLICIES)))
    sat = node.get("sat_threshold", 6.0)
    return {
        "every": max(1, int(node.get("every", 1) or 1)),
        "policy": policy,
        # an explicit 0 (everything counts as saturated) must survive
        "sat_threshold": float(6.0 if sat is None else sat),
    }


# -- the device side -----------------------------------------------------------

def _leaves(tree) -> List[torch.Tensor]:
    """The leaves of a nested dict in sorted key order (the reference's
    tree order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def _zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=device)


def zero_stats(layer_names, device=None) -> Dict[str, torch.Tensor]:
    """Zero accumulators under :func:`step_stats`'s keys, float32
    scalars on ``device``."""
    out = {k: _zero(device) for k in ("mon_steps", "mon_nan", "mon_grad_sq",
                                      "mon_sat", "mon_act_n")}
    for name in sorted(layer_names):
        out["mon_wsq/%s" % name] = _zero(device)
        out["mon_usq/%s" % name] = _zero(device)
    return out


def _sumsq(tree, device) -> torch.Tensor:
    leaves = _leaves(tree)
    if not leaves:
        return _zero(device)
    return sum(torch.sum(torch.square(leaf.float())) for leaf in leaves)


def _nonfinite(tree, device) -> torch.Tensor:
    leaves = _leaves(tree)
    if not leaves:
        return _zero(device)
    return sum(torch.sum((~torch.isfinite(leaf.float())).float())
               for leaf in leaves)


def step_stats(params, new_params, grads, loss, out=None,
               sat_threshold: float = 6.0) -> Dict[str, torch.Tensor]:
    """The statistics of ONE optimiser step as float32 device scalars,
    sums only (the accumulators add them). ``out`` is the head's output
    when the step has it (the gradient-accumulation path passes None:
    saturation reads 0 there)."""
    device = loss.device
    loss32 = loss.float()
    stats = {
        "mon_steps": torch.ones((), dtype=torch.float32, device=device),
        "mon_grad_sq": _sumsq(grads, device),
        "mon_nan": (_nonfinite(grads, device)
                    + (~torch.isfinite(loss32)).float()),
    }
    if out is not None:
        a = torch.abs(out.float())
        stats["mon_sat"] = torch.sum((a >= sat_threshold).float())
        # a fill, not a copy from the host
        stats["mon_act_n"] = torch.full((), float(out.numel()),
                                        dtype=torch.float32, device=device)
        stats["mon_nan"] = stats["mon_nan"] + _nonfinite(out, device)
    else:
        stats["mon_sat"] = _zero(device)
        stats["mon_act_n"] = _zero(device)
    for name in sorted(params):
        stats["mon_wsq/%s" % name] = _sumsq(new_params[name], device)
        upd = {k: new_params[name][k].float() - params[name][k].float()
               for k in params[name]}
        stats["mon_usq/%s" % name] = _sumsq(upd, device)
    return stats


# -- the host side -------------------------------------------------------------

def _safe(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_]", "_", name)


class TensorMonitor:
    """The host-side consumer of drained monitor accumulators: derives
    the statistics, runs the NaN sentinel, feeds the spans and the
    flight recorder. One process-wide instance (:data:`monitor`)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._samples = 0
        self._last: Dict[str, Any] = {}
        self._layers: Dict[str, Dict[str, float]] = {}

    def observe(self, step_unit, mon: Dict[str, float]) -> None:
        """Process one drained sample (host floats keyed ``mon_*``). May
        raise :class:`ModelHealthError` under a halting policy, on the
        scheduler path where a crashed step would surface."""
        cfg = getattr(step_unit, "_tensormon", None) or {}
        every = max(1, int(cfg.get("every", 1)))
        steps = max(float(mon.get("mon_steps", 0.0)), 1.0)
        nan = float(mon.get("mon_nan", 0.0))
        act_n = float(mon.get("mon_act_n", 0.0))
        summary = {
            "grad_norm": math.sqrt(
                max(float(mon.get("mon_grad_sq", 0.0)), 0.0) / steps),
            "nan": nan,
            "act_saturation": (float(mon.get("mon_sat", 0.0)) / act_n
                               if act_n else 0.0),
            "steps": steps,
        }
        layers: Dict[str, Dict[str, float]] = {}
        for key, val in mon.items():
            if not key.startswith("mon_wsq/"):
                continue
            name = key[len("mon_wsq/"):]
            wnorm = math.sqrt(max(float(val), 0.0) / steps)
            unorm = math.sqrt(
                max(float(mon.get("mon_usq/%s" % name, 0.0)), 0.0) / steps)
            layers[name] = {
                "weight_norm": wnorm,
                "update_ratio": (unorm / wnorm) if wnorm else 0.0,
            }
        with self._lock:
            self._samples += 1
            n = self._samples
            self._last = dict(summary)
            self._layers = layers
        inc("veles_tensormon_samples_total")
        if n % every == 0:
            # a zero-length span: the sample lands in the span ring and
            # the --trace-file stream beside the dispatch spans
            from .spans import span
            attrs = {k: round(v, 6) if isinstance(v, float) else v
                     for k, v in summary.items()}
            with span("tensormon.sample", **attrs):
                pass
            from .recorder import flight
            flight.note("tensormon", **summary)
        if nan > 0:
            inc("veles_model_nan_total", nan)
            self._sentinel(step_unit, cfg, summary)

    def _sentinel(self, step_unit, cfg: Dict[str, Any],
                  summary: Dict[str, Any]) -> None:
        policy = str(cfg.get("policy", "warn"))
        log = logging.getLogger("veles_tpu_torch.telemetry")
        from .recorder import flight
        flight.note("tensormon.nan", policy=policy, **summary)
        log.warning(
            "tensormon: %d non-finite value(s) in the train step "
            "(grad_norm=%s, policy=%s)", int(summary["nan"]),
            summary["grad_norm"], policy)
        if policy == "warn":
            return
        # readiness drops first, then the forensic snapshot and the
        # black box land on disk, then the typed error unwinds the run
        from ..resilience.health import mark_unready
        mark_unready("model_health")
        inc("veles_model_health_errors_total")
        snap_path: Optional[str] = None
        if policy == "snapshot_and_halt":
            snap = self._find_snapshotter(step_unit)
            if snap is None:
                log.warning("tensormon: snapshot_and_halt but the "
                            "workflow has no Snapshotter unit — halting "
                            "without a forensic checkpoint")
            else:
                try:
                    snap_path = snap.export()
                except Exception as e:    # noqa: BLE001 — still halt
                    log.warning("tensormon: forensic snapshot failed "
                                "(%s: %s)", type(e).__name__, e)
        try:
            dump_path = flight.dump(
                "nan sentinel: %d non-finite value(s), policy=%s"
                % (int(summary["nan"]), policy))
        except Exception:        # noqa: BLE001 — never mask the halt
            dump_path = None
        raise ModelHealthError(
            "non-finite values detected in the train step (%d NaN/Inf; "
            "grad_norm=%s). Model health is unready; %s%s"
            % (int(summary["nan"]), summary["grad_norm"],
               ("forensic snapshot: %s; " % snap_path) if snap_path
               else "",
               ("black box: %s" % dump_path) if dump_path
               else "no black box written"))

    @staticmethod
    def _find_snapshotter(step_unit):
        from ..snapshotter import Snapshotter
        wf = getattr(step_unit, "workflow", None)
        snap = getattr(wf, "snapshotter", None)
        if isinstance(snap, Snapshotter):
            return snap
        for unit in getattr(wf, "units", []) or []:
            if isinstance(unit, Snapshotter):
                return unit
        return None

    def gauges(self) -> Dict[str, Any]:
        """``/metrics`` gauges (name → (value, help)); empty until the
        first sample, so a monitoring-off process renders none."""
        with self._lock:
            last = dict(self._last)
            layers = {k: dict(v) for k, v in self._layers.items()}
        if not last:
            return {}
        out = {
            "veles_model_grad_norm": (
                last["grad_norm"],
                "Global gradient L2 norm (per-step RMS, last sample)"),
            "veles_model_act_saturation": (
                last["act_saturation"],
                "Fraction of head activations at/above sat_threshold"),
        }
        for name, vals in sorted(layers.items()):
            safe = _safe(name)
            out["veles_model_weight_norm_" + safe] = (
                vals["weight_norm"], "Weight L2 norm of layer " + name)
            out["veles_model_update_ratio_" + safe] = (
                vals["update_ratio"],
                "Update/weight norm ratio of layer " + name)
        return out

    def last_sample(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._last)

    def reset(self) -> None:
        """Tests only."""
        with self._lock:
            self._samples = 0
            self._last = {}
            self._layers = {}


#: the process-wide monitor
monitor = TensorMonitor()


def extract_mon(entries: List[Dict[int, Dict[str, float]]],
                train_cls: int) -> List[Dict[str, float]]:
    """Pop the ``mon_*`` keys out of drained per-epoch metric dicts (in
    place) and return them as one sample per epoch: the Decision never
    sees the monitor's accumulators."""
    samples: List[Dict[str, float]] = []
    for entry in entries:
        metrics = entry.get(train_cls)
        if not metrics:
            continue
        mon = {k: metrics.pop(k) for k in list(metrics)
               if k.startswith(MON_PREFIX)}
        if mon:
            samples.append(mon)
    return samples

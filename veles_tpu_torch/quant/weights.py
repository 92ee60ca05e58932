"""int8 weight quantization of parameter trees and snapshots (counterpart
of ``veles_tpu/quant/weights.py``).

Two surfaces, one numeric core (``ops/precision.py``):

- :func:`quantize_params` turns a serving parameter tree
  (``nn.sampling.params_of``'s ``{unit: {name: tensor}}``) into its
  quantized twin, where every eligible 2-D matmul weight becomes a
  ``{"q": int8, "scale": float32}`` record on the weight's device.
  :class:`DequantView` reads such a unit back: each weight is rebuilt as
  ``q · s`` when a product asks for it, so no float copy of every layer
  lives beside the int8 one; :func:`dequantize_params` rebuilds a whole
  tree at once, with the same bits.
- :func:`quantize_state` / :func:`dequantize_state` do the same to a
  snapshot state tree (``python -m veles_tpu_torch quantize``): eligible
  arrays of every unit's state become ``{"__quant__": "int8", "q",
  "scale", "dtype", "granularity"}`` records, the reference's, so a
  state quantized by either package loads in the other.
  ``snapshotter.load_snapshot`` dequantizes on every read.

Eligibility is structural, as the reference's: 2-D floating-point
arrays of at least :data:`MIN_ELEMENTS` elements that are not embedding
``table``s (their rows are the activations). Biases, norm gains and
generator state are never touched. A per-channel scale keeps the
weight's rank, (1, N); a per-tensor scale is 0-d.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, NamedTuple, Tuple

import numpy
import torch

from ..config import root
from ..error import VelesError
from ..ops.precision import dequantize_int8, quantize_int8, torch_dtype
from ..resilience.faults import fire as fire_fault
from ..telemetry.counters import inc

#: snapshot-side marker key (a dict wearing it replaces the original
#: array; readers rebuild it with dequantize_state)
STATE_MARKER = "__quant__"

GRANULARITIES = ("per_channel", "per_tensor")

#: arrays smaller than this stay float: the scale sidecar and the risk
#: beat the saving on tiny tensors
MIN_ELEMENTS = 256


class TensorSpec(NamedTuple):
    """Shape and dtype of a tensor that :func:`quantize_params` will
    produce (:func:`quantize_params_spec`)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def granularity_from_config() -> str:
    return _check_granularity(
        str(root.common.quant.get("granularity", "per_channel")))


def _resolve_granularity(granularity: str = None) -> str:
    """The default and the check, in one place for every entry point."""
    return _check_granularity(granularity or granularity_from_config())


def _check_granularity(granularity: str) -> str:
    if granularity not in GRANULARITIES:
        raise VelesError("quant granularity %r not in %s"
                         % (granularity, GRANULARITIES))
    return granularity


def _is_float(arr) -> bool:
    if isinstance(arr, torch.Tensor):
        return arr.is_floating_point()
    return numpy.dtype(getattr(arr, "dtype", numpy.float32)).kind == "f"


def _numel(arr) -> int:
    return arr.numel() if isinstance(arr, torch.Tensor) else int(arr.size)


def _itemsize(arr) -> int:
    if isinstance(arr, torch.Tensor):
        return arr.element_size()
    return numpy.dtype(str(arr.dtype)).itemsize


def _eligible(name: str, arr) -> bool:
    if getattr(arr, "ndim", 0) != 2 or name == "table":
        return False
    return _numel(arr) >= MIN_ELEMENTS and _is_float(arr)


def _axis_for(granularity: str):
    return -1 if granularity == "per_channel" else None


def _is_record(val) -> bool:
    return isinstance(val, dict) and "q" in val


def is_quantized_params(params: Dict[str, Dict[str, Any]]) -> bool:
    """True when ``params`` carries at least one quantized leaf."""
    return any(_is_record(val) for unit in params.values()
               for val in unit.values())


def _calibrate(units: Dict[str, Any], granularity: str, make_record,
               eligible=_eligible
               ) -> Tuple[Dict[str, Any], Dict[str, int]]:
    """The calibration walk (amax scan and int8 conversion) shared by
    :func:`quantize_params` and :func:`quantize_state`: one eligibility
    pass, one byte tally, one set of counter increments. The
    ``quant.calibrate`` fault point fires before the scan. Entries that
    are not dicts ride through untouched."""
    fire_fault("quant.calibrate")
    axis = _axis_for(granularity)
    out: Dict[str, Any] = {}
    n = before = after = 0
    for uname, uparams in units.items():
        if not isinstance(uparams, dict):
            out[uname] = uparams
            continue
        qp = {}
        for pname, arr in uparams.items():
            if eligible(pname, arr):
                q, scale = quantize_int8(arr, axis=axis)
                qp[pname] = make_record(arr, q, scale)
                n += 1
                before += _numel(arr) * _itemsize(arr)
                after += q.numel() + scale.numel() * 4
            else:
                qp[pname] = arr
        out[uname] = qp
    inc("veles_quant_calibrations_total")
    if n:
        inc("veles_quant_params_total", n)
        inc("veles_quant_bytes_saved_total", max(0, before - after))
    return out, {"params": n, "bytes_before": before,
                 "bytes_after": after}


def quantize_tensor(name: str, arr, granularity: str = None):
    """One tensor, for other writers (``export/package.py``): ``(q,
    scale)`` when ``(name, arr)`` is an eligible matmul weight, else
    None; eligibility and the axis policy stay defined here."""
    granularity = _resolve_granularity(granularity)
    if not _eligible(name, arr):
        return None
    return quantize_int8(arr, axis=_axis_for(granularity))


def quantize_params(params: Dict[str, Dict[str, Any]],
                    granularity: str = None
                    ) -> Tuple[Dict[str, Dict[str, Any]], Dict[str, int]]:
    """Serving parameter tree → (quantized tree, report). The report
    carries ``{"params", "bytes_before", "bytes_after"}``; the counters
    ``veles_quant_params_total``, ``veles_quant_bytes_saved_total`` and
    ``veles_quant_calibrations_total`` tally the same numbers."""
    granularity = _resolve_granularity(granularity)
    return _calibrate(params, granularity,
                      lambda arr, q, scale: {"q": q, "scale": scale})


def quantize_params_spec(params: Dict[str, Dict[str, Any]],
                         granularity: str = None
                         ) -> Dict[str, Dict[str, Any]]:
    """The :class:`TensorSpec` tree :func:`quantize_params` will give,
    computed without the amax scan: no device work, no counters, no
    ``quant.calibrate`` fault point."""
    granularity = _resolve_granularity(granularity)
    axis = _axis_for(granularity)
    out: Dict[str, Dict[str, Any]] = {}
    for uname, uparams in params.items():
        qp = {}
        for pname, arr in uparams.items():
            shape = tuple(arr.shape)
            if _eligible(pname, arr):
                if axis is None:
                    sshape = ()
                else:
                    ax = axis % len(shape)
                    sshape = tuple(n if i == ax else 1
                                   for i, n in enumerate(shape))
                qp[pname] = {"q": TensorSpec(shape, torch.int8),
                             "scale": TensorSpec(sshape, torch.float32)}
            else:
                qp[pname] = TensorSpec(shape, torch_dtype(arr.dtype))
        out[uname] = qp
    return out


class DequantView(Mapping):
    """One unit of a quantized tree read as float parameters: a record
    is rebuilt as ``q · s`` in ``dtype`` each time it is read, just
    before the product that asks for it; other entries as they are."""

    def __init__(self, unit: Dict[str, Any], dtype=None) -> None:
        self._unit = unit
        self._dtype = dtype

    def __getitem__(self, name):
        val = self._unit[name]
        if _is_record(val):
            return dequantize_int8(val["q"], val["scale"],
                                   dtype=self._dtype)
        return val

    def __iter__(self):
        return iter(self._unit)

    def __len__(self) -> int:
        return len(self._unit)


def dequantize_params(params: Dict[str, Dict[str, Any]], dtype=None
                      ) -> Dict[str, Dict[str, Any]]:
    """The float tree of a quantized one (records → ``q · s`` in
    ``dtype``, float32 by default; other entries as they are)."""
    return {uname: dict(DequantView(uparams, dtype))
            for uname, uparams in params.items()}


# -- snapshot surface (python -m veles_tpu_torch quantize) -------------------

def quantize_state(state: Dict[str, Any], granularity: str = None
                   ) -> Tuple[Dict[str, Any], Dict[str, int]]:
    """Snapshot state tree → its quantized twin (a new dict; ``state``
    is not changed). Only ``__units__`` entries are touched, and of
    them only numpy arrays; ``__meta__["quant"]`` records the
    granularity and the count."""
    granularity = _resolve_granularity(granularity)

    def record(arr, q, scale):
        return {
            STATE_MARKER: "int8",
            "q": q.numpy(),
            "scale": scale.numpy(),
            "dtype": str(arr.dtype),
            "granularity": granularity,
        }

    units, report = _calibrate(
        state.get("__units__", {}), granularity, record,
        eligible=lambda pname, arr: isinstance(arr, numpy.ndarray)
        and _eligible(pname, arr))
    out = dict(state)
    out["__units__"] = units
    meta = dict(out.get("__meta__", {}))
    meta["quant"] = {"granularity": granularity,
                     "params": report["params"]}
    out["__meta__"] = meta
    return out, report


def _state_array(uname: str, pname: str, val) -> numpy.ndarray:
    """A snapshot record → its float numpy array."""
    scheme = val[STATE_MARKER]
    if scheme != "int8":
        raise VelesError(
            "snapshot: unknown quant scheme %r for %s.%s — this build "
            "reads int8 only (version skew? re-quantize with this "
            "veles_tpu_torch)" % (scheme, uname, pname))
    if "q" not in val or "scale" not in val:
        raise VelesError(
            "snapshot: quant record for %s.%s is missing its q/scale "
            "tensors — the snapshot is corrupt or was written by a "
            "broken quantizer" % (uname, pname))
    out = dequantize_int8(numpy.asarray(val["q"]),
                          numpy.asarray(val["scale"])).numpy()
    dtype = val.get("dtype", "float32")
    try:
        return out.astype(numpy.dtype(dtype))
    except TypeError:
        raise VelesError(
            "snapshot: quant record for %s.%s restores to %s, which a "
            "snapshot's numpy arrays cannot hold here"
            % (uname, pname, dtype)) from None


def dequantize_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """Expand quantized records back to float arrays — the pass
    ``load_snapshot`` applies on every read, so no consumer sees a
    marker. A tree without markers is returned as it is (the same
    object). A marked record this build cannot read raises
    :class:`VelesError`."""
    units = state.get("__units__")
    if not isinstance(units, dict):
        return state
    changed = False
    new_units = {}
    for uname, sd in units.items():
        if not isinstance(sd, dict):
            new_units[uname] = sd
            continue
        nsd = {}
        for pname, val in sd.items():
            if isinstance(val, dict) and STATE_MARKER in val:
                nsd[pname] = _state_array(uname, pname, val)
                changed = True
            else:
                nsd[pname] = val
        new_units[uname] = nsd
    if not changed:
        return state
    out = dict(state)
    out["__units__"] = new_units
    return out

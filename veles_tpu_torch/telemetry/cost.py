"""Cost accounting: FLOPs, bytes and peaks (counterpart of
``veles_tpu/telemetry/cost.py``).

Roofline accounting is how utilization is reported; this module makes
the framework the source of those numbers. The reference reads XLA's
``cost_analysis`` of a compiled program; the port counts a call while it
runs (:func:`cost_of_fn`): FLOPs with ``torch.utils.flop_counter.
FlopCounterMode`` (the products: mm, bmm, addmm, convolutions, SDPA) and
bytes with a dispatch mode that sums each operator's input and output
bytes (XLA's per-op ``bytes_accessed``), stamped
``source="flop_counter"``. A hand-written kernel is opaque to both, as a
Pallas custom call is to XLA, so the ops that own kernels publish an
analytic cost at each launch (:func:`note_kernel_cost`;
ops/flash_attention.py, ops/fused_fc.py) and :class:`CostModel` merges
both sources into one ledger.

The peak tables are the ONE copy of the card's published rates (NVIDIA
H100 SXM data sheet, dense, at the 700 W limit): the ops' bounds read
them from here. MFU is model FLOPs per second over the peak of the
computation's dtype.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

#: dense peak FLOP/s by device kind, substring-matched (lower case)
#: against ``torch.cuda.get_device_name()``, first hit wins: bf16 (and
#: fp16) on the tensor cores
PEAK_BF16 = [("h100", 989e12)]
DEFAULT_PEAK = 989e12
#: TF32 on the tensor cores
PEAK_TF32 = [("h100", 495e12)]
DEFAULT_PEAK_TF32 = 495e12
#: float32 FMA on the CUDA cores (torch's float32 products with TF32
#: off, the port's policy)
PEAK_F32 = [("h100", 67e12)]
DEFAULT_PEAK_F32 = 67e12
#: HBM bytes/s
HBM_BW_BYTES = [("h100", 3.35e12)]
DEFAULT_HBM_BW = 3.35e12
#: NVLink 4 bytes/s per direction, per card (the reference's ICI row):
#: the STATED link input of the scaling models
#: (resilience/elastic.predict_step_time, linalg.predict_summa_time)
LINK_BW_BYTES = [("h100", 450e9)]
DEFAULT_LINK_BW = 450e9

_DEFAULTS = {"PEAK_BF16": "DEFAULT_PEAK", "PEAK_TF32": "DEFAULT_PEAK_TF32",
             "PEAK_F32": "DEFAULT_PEAK_F32",
             "HBM_BW_BYTES": "DEFAULT_HBM_BW",
             "LINK_BW_BYTES": "DEFAULT_LINK_BW"}

#: the card these defaults describe: a kind no table matches (the CPU,
#: another card) is priced as it, and the entry's label says so
DEFAULT_KIND = "NVIDIA H100 (data sheet default)"


def device_kind() -> str:
    """The first card's name, or "unknown" without one."""
    try:
        import torch
        if torch.cuda.is_available():
            return torch.cuda.get_device_name(0)
    except Exception:            # noqa: BLE001 — no usable CUDA runtime
        pass
    return "unknown"


def _lookup(table: str, kind: Optional[str]) -> Tuple[str, float]:
    """(label, value) of the first row of table ``PEAK_BF16`` (etc.)
    whose key ``kind`` holds, else of its DEFAULT_* constant."""
    kind = str(device_kind() if kind is None else kind).lower()
    for key, value in globals()[table]:
        if key in kind:
            return "telemetry.cost.%s[%s]" % (table, key), value
    default = _DEFAULTS[table]
    return ("telemetry.cost.%s (%s)" % (default, DEFAULT_KIND),
            globals()[default])


def hbm_bandwidth(kind: Optional[str] = None) -> float:
    """HBM bytes/s of ``kind`` (default: the first card)."""
    return _lookup("HBM_BW_BYTES", kind)[1]


def ici_bandwidth_entry(device_kind: Optional[str] = None
                        ) -> Tuple[str, float]:
    """(source label, assumed per-card link bytes/s) for
    ``device_kind`` (default: the first card): NVLink 4's rate a
    direction, the reference's ICI row. The label names the table row
    used, so a scaling prediction states its own input."""
    return _lookup("LINK_BW_BYTES", device_kind)


def ici_bandwidth(device_kind: Optional[str] = None) -> float:
    """Assumed per-card link bytes/s of ``device_kind`` — the scaling
    models' communication denominator."""
    return ici_bandwidth_entry(device_kind)[1]


def peak_bf16_flops(kind: Optional[str] = None) -> float:
    """Dense bf16 peak FLOP/s of ``kind`` (default: the first card)."""
    return _lookup("PEAK_BF16", kind)[1]


def peak_flops_entry(dtype=None, device_kind: Optional[str] = None):
    """(source label, dense peak FLOP/s) keyed on the COMPUTATION dtype:
    float32 (and float64, priced at it as the optimistic bound) through
    PEAK_F32, "tf32" through PEAK_TF32, everything else (bf16, fp16)
    through PEAK_BF16. The label names the table entry used."""
    if dtype is None:
        name = "bfloat16"
    else:
        name = str(getattr(dtype, "name", None) or dtype)
        try:                     # numpy dtypes, "float32", numpy.float32
            import numpy
            name = numpy.dtype(dtype).name
        except TypeError:        # torch dtypes, "bf16"/"tf32" shorthands
            pass
    name = name.lower().replace("torch.", "")
    if name in ("float32", "f32", "float64", "f64", "float", "double"):
        return _lookup("PEAK_F32", device_kind)
    if name in ("tf32", "tensorfloat32"):
        return _lookup("PEAK_TF32", device_kind)
    return _lookup("PEAK_BF16", device_kind)


def peak_flops(dtype=None, device_kind: Optional[str] = None) -> float:
    """Dense peak FLOP/s for ``dtype`` on ``device_kind`` (default: the
    first card) — the dtype-aware MFU denominator."""
    return peak_flops_entry(dtype, device_kind)[1]


class Cost:
    """One computation's cost: model FLOPs, bytes accessed, peak live
    memory."""

    __slots__ = ("flops", "bytes_accessed", "peak_memory", "source")

    def __init__(self, flops: float = 0.0, bytes_accessed: float = 0.0,
                 peak_memory: float = 0.0, source: str = "analytic"):
        self.flops = float(flops)
        self.bytes_accessed = float(bytes_accessed)
        self.peak_memory = float(peak_memory)
        #: "flop_counter" (counted while it ran) | "analytic" (a
        #: kernel's published model) | "mixed"
        self.source = source

    def __add__(self, other: "Cost") -> "Cost":
        return Cost(self.flops + other.flops,
                    self.bytes_accessed + other.bytes_accessed,
                    max(self.peak_memory, other.peak_memory),
                    self.source if self.source == other.source
                    else "mixed")

    def scaled(self, n: float) -> "Cost":
        """Cost of running this computation ``n`` times (peak memory is
        per-execution and does not scale)."""
        return Cost(self.flops * n, self.bytes_accessed * n,
                    self.peak_memory, self.source)

    @property
    def arithmetic_intensity(self) -> float:
        """FLOPs per byte accessed — the roofline x-axis."""
        return self.flops / self.bytes_accessed if self.bytes_accessed \
            else 0.0

    def mfu(self, seconds: float, peak_flops: Optional[float] = None,
            n_chips: int = 1) -> float:
        """Model FLOP utilization of executing this cost in ``seconds``
        on ``n_chips`` cards of ``peak_flops`` each."""
        if seconds <= 0:
            return 0.0
        peak = peak_flops if peak_flops is not None else peak_bf16_flops()
        return self.flops / seconds / (peak * n_chips)

    def as_dict(self) -> Dict[str, float]:
        return {"flops": self.flops, "bytes": self.bytes_accessed,
                "peak_memory": self.peak_memory, "source": self.source}

    def __repr__(self) -> str:
        return ("Cost(flops=%.3e, bytes=%.3e, peak=%.3e, %s)"
                % (self.flops, self.bytes_accessed, self.peak_memory,
                   self.source))


#: the active kernel-cost collectors
_collectors: List[List[Cost]] = []
_collectors_lock = threading.Lock()


class collecting_kernel_costs:
    """``with collecting_kernel_costs() as notes:`` — kernels launched
    while the block runs, by any thread, that call
    :func:`note_kernel_cost` append their analytic costs to ``notes``.
    Any thread, unlike the reference's trace-time collector: the serving
    engines, and autograd's backward on the card, launch kernels on
    threads of their own. The reference notes a kernel once per trace;
    the port has no trace, so a kernel notes once per launch."""

    def __enter__(self) -> List[Cost]:
        self._acc: List[Cost] = []
        with _collectors_lock:
            _collectors.append(self._acc)
        return self._acc

    def __exit__(self, *exc: Any) -> None:
        with _collectors_lock:
            _collectors.remove(self._acc)


def note_kernel_cost(cost: Cost) -> None:
    """Called by a kernel's wrapper where it launches the kernel:
    registers its analytic cost with every active collector (a no-op
    outside any — a launch pays one truth test)."""
    if _collectors:
        with _collectors_lock:
            for acc in _collectors:
                acc.append(cost)


def _bytes_mode():
    """A dispatch mode summing, per operator, the bytes of its tensor
    inputs and outputs (views move nothing and are skipped)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class BytesMode(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not getattr(func, "is_view", False):
                flat = tree_flatten((args, kwargs or {}, out))[0]
                self.total += sum(t.numel() * t.element_size()
                                  for t in flat
                                  if isinstance(t, torch.Tensor))
            return out

    return BytesMode()


def cost_of_fn(fn: Callable, *args: Any, **kwargs: Any) -> Cost:
    """Run ``fn(*args, **kwargs)`` once and count its cost: FLOPs with
    ``FlopCounterMode``, bytes with a dispatch mode that sums each
    operator's input and output bytes. The call executes (on the
    arguments' device) and its result is dropped: use it on demand, off
    the hot path. Peak memory is not counted here (0)."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    nbytes = _bytes_mode()
    with counter, nbytes:
        fn(*args, **kwargs)
    return Cost(counter.get_total_flops(), nbytes.total, 0.0,
                source="flop_counter")


class CostModel:
    """Per-name cost ledger: the framework's own measured-MFU source.
    Thread-safe (serving and training record concurrently)."""

    def __init__(self, peak_flops: Optional[float] = None) -> None:
        self._lock = threading.Lock()
        self._ledger: Dict[str, Cost] = {}
        self._execs: Dict[str, int] = {}
        self._peak = peak_flops

    @property
    def peak_flops(self) -> float:
        if self._peak is None:
            self._peak = peak_bf16_flops()
        return self._peak

    def record(self, name: str, cost: Cost, executions: float = 1) -> None:
        """Accumulate ``cost`` × ``executions`` under ``name``."""
        with self._lock:
            add = cost.scaled(executions)
            cur = self._ledger.get(name)
            self._ledger[name] = add if cur is None else cur + add
            self._execs[name] = self._execs.get(name, 0) + int(executions)

    def get(self, name: str) -> Optional[Cost]:
        with self._lock:
            return self._ledger.get(name)

    def total(self) -> Cost:
        with self._lock:
            total = Cost()
            for c in self._ledger.values():
                total = total + c
            return total

    def mfu(self, name: str, seconds: float, n_chips: int = 1) -> float:
        cost = self.get(name)
        if cost is None:
            return 0.0
        return cost.mfu(seconds, self.peak_flops, n_chips)

    def report(self, seconds_by_name: Optional[Dict[str, float]] = None,
               n_chips: int = 1) -> Dict[str, Dict[str, float]]:
        """Structured per-name summary; entries with measured seconds
        carry ``tflops_per_sec`` and ``mfu``."""
        out: Dict[str, Dict[str, float]] = {}
        with self._lock:
            items = list(self._ledger.items())
            execs = dict(self._execs)
        for name, cost in items:
            row = cost.as_dict()
            row["executions"] = execs.get(name, 0)
            row["arithmetic_intensity"] = cost.arithmetic_intensity
            secs = (seconds_by_name or {}).get(name)
            if secs:
                row["seconds"] = secs
                row["tflops_per_sec"] = cost.flops / secs / 1e12
                row["mfu"] = cost.mfu(secs, self.peak_flops, n_chips)
            out[name] = row
        return out

    def clear(self) -> None:
        with self._lock:
            self._ledger.clear()
            self._execs.clear()



#: process-global ledger instrumented code records into (mirrors
#: counters.counters / spans.recorder): the linalg family's analytic
#: entries land here
model = CostModel()

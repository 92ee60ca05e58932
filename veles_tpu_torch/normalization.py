"""Dataset normalization strategy registry (a copy of
``veles_tpu/normalization.py``, which is numpy code: the same names,
arithmetic and state, so a state dict of either package loads into the
other's normalizer).

A normalizer may accumulate state over data chunks (``analyze``), then
transform (``normalize``) and invert (``denormalize``). State is
numpy-only so it snapshots cleanly.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy

#: name → class (reference: NormalizerRegistry metaclass)
NORMALIZERS: Dict[str, type] = {}


def normalizer(name: str):
    def deco(cls):
        cls.NAME = name
        NORMALIZERS[name] = cls
        return cls
    return deco


def get_normalizer(name: str, **kwargs) -> "NormalizerBase":
    try:
        return NORMALIZERS[name](**kwargs)
    except KeyError:
        raise KeyError("unknown normalizer %r (have: %s)" %
                       (name, sorted(NORMALIZERS)))


class NormalizerBase:
    NAME = "?"

    def analyze(self, data: numpy.ndarray) -> None:
        """Accumulate statistics over a data chunk."""

    def normalize(self, data: numpy.ndarray) -> numpy.ndarray:
        raise NotImplementedError

    def denormalize(self, data: numpy.ndarray) -> numpy.ndarray:
        raise NotImplementedError

    def state_dict(self):
        return dict(self.__dict__)

    def load_state_dict(self, sd):
        self.__dict__.update(sd)


@normalizer("none")
class NoneNormalizer(NormalizerBase):
    def normalize(self, data):
        return data

    def denormalize(self, data):
        return data


@normalizer("linear")
class LinearNormalizer(NormalizerBase):
    """Scale each sample into [interval] by its own min/max
    (reference: stateless 'linear')."""

    def __init__(self, interval=(-1.0, 1.0)):
        self.interval = tuple(interval)

    def normalize(self, data):
        lo, hi = self.interval
        flat = data.reshape(len(data), -1)
        dmin = flat.min(axis=1, keepdims=True)
        dmax = flat.max(axis=1, keepdims=True)
        span = numpy.where(dmax - dmin == 0, 1, dmax - dmin)
        out = (flat - dmin) / span * (hi - lo) + lo
        return out.reshape(data.shape).astype(numpy.float32)

    def denormalize(self, data):
        raise NotImplementedError("per-sample linear is not invertible")


@normalizer("range")
class RangeNormalizer(NormalizerBase):
    """Stateful global min/max → [interval] (reference: 'range')."""

    def __init__(self, interval=(-1.0, 1.0)):
        self.interval = tuple(interval)
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None

    def analyze(self, data):
        dmin, dmax = float(data.min()), float(data.max())
        self.vmin = dmin if self.vmin is None else min(self.vmin, dmin)
        self.vmax = dmax if self.vmax is None else max(self.vmax, dmax)

    def _span(self):
        if self.vmin is None:
            raise RuntimeError("range normalizer: analyze() never called")
        return self.vmax - self.vmin or 1.0

    def normalize(self, data):
        lo, hi = self.interval
        return ((data - self.vmin) / self._span() * (hi - lo)
                + lo).astype(numpy.float32)

    def denormalize(self, data):
        lo, hi = self.interval
        return ((data - lo) / (hi - lo) * self._span()
                + self.vmin).astype(numpy.float32)


@normalizer("mean_disp")
class MeanDispNormalizerHost(NormalizerBase):
    """Stateful per-element mean/dispersion (reference: 'mean_disp'; the
    accelerated unit MeanDispNormalizer applies the same transform on
    device)."""

    def __init__(self):
        self._sum = None
        self._amax = None
        self._amin = None
        self._count = 0
        self.mean = None
        self.rdisp = None

    def analyze(self, data):
        d = data.astype(numpy.float64)
        if self._sum is None:
            self._sum = d.sum(axis=0)
            self._amax = d.max(axis=0)
            self._amin = d.min(axis=0)
        else:
            self._sum += d.sum(axis=0)
            self._amax = numpy.maximum(self._amax, d.max(axis=0))
            self._amin = numpy.minimum(self._amin, d.min(axis=0))
        self._count += len(d)

    def _finish(self):
        if self.mean is None:
            self.mean = (self._sum / max(self._count, 1)).astype(
                numpy.float32)
            disp = numpy.maximum(self._amax - self.mean,
                                 self.mean - self._amin)
            disp[disp == 0] = 1.0
            self.rdisp = (1.0 / disp).astype(numpy.float32)

    def normalize(self, data):
        self._finish()
        return ((data - self.mean) * self.rdisp).astype(numpy.float32)

    def denormalize(self, data):
        self._finish()
        return (data / self.rdisp + self.mean).astype(numpy.float32)


@normalizer("external_mean")
class ExternalMeanNormalizer(NormalizerBase):
    """Subtract a provided mean image (reference: 'external_mean')."""

    def __init__(self, mean_source=None):
        self.mean = numpy.asarray(mean_source, dtype=numpy.float32)

    def normalize(self, data):
        return (data - self.mean).astype(numpy.float32)

    def denormalize(self, data):
        return (data + self.mean).astype(numpy.float32)


@normalizer("pointwise")
class PointwiseNormalizer(NormalizerBase):
    """Stateful per-element linear map into [-1, 1]
    (reference: 'pointwise')."""

    def __init__(self):
        self._amin = None
        self._amax = None

    def analyze(self, data):
        d = data.astype(numpy.float64)
        amin, amax = d.min(axis=0), d.max(axis=0)
        self._amin = amin if self._amin is None else numpy.minimum(
            self._amin, amin)
        self._amax = amax if self._amax is None else numpy.maximum(
            self._amax, amax)

    def normalize(self, data):
        span = self._amax - self._amin
        span = numpy.where(span == 0, 1, span)
        return ((data - self._amin) / span * 2 - 1).astype(numpy.float32)

    def denormalize(self, data):
        span = self._amax - self._amin
        span = numpy.where(span == 0, 1, span)
        return ((data + 1) / 2 * span + self._amin).astype(numpy.float32)


@normalizer("exp")
class ExpNormalizer(NormalizerBase):
    """sigmoid-ish squash (reference: 'exp')."""

    def normalize(self, data):
        return (2.0 / (1.0 + numpy.exp(-data)) - 1).astype(numpy.float32)

    def denormalize(self, data):
        c = numpy.clip(data, -1 + 1e-7, 1 - 1e-7)
        return (-numpy.log(2.0 / (c + 1) - 1)).astype(numpy.float32)

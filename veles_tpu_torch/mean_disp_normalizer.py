"""MeanDispNormalizer: ``y = (x - mean) * rdisp`` elementwise over the
samples (counterpart of ``veles_tpu/mean_disp_normalizer.py``; BASELINE
config #2 with the full-batch loader).

The reference computes it as one jitted elementwise expression (no
Pallas kernel), so here it is two torch ops on the workflow's device.
``mean`` and ``rdisp`` come from the host normalizer registry
(:meth:`compute_mean_rdisp`, ``normalization.py``'s ``mean_disp``), and
:meth:`numpy_run` is the oracle.
"""

from __future__ import annotations

from typing import Optional

import numpy
import torch

from .accelerated import AcceleratedUnit
from .config import root
from .memory import Array


class MeanDispNormalizer(AcceleratedUnit):
    """input (B, ...), mean (...), rdisp (...) → output (B, ...) float."""

    MAPPING = "mean_disp_normalizer"
    hide_from_registry = False

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.view_group = "WORKER"
        self.input: Optional[Array] = None
        self.mean: Optional[Array] = None
        self.rdisp: Optional[Array] = None
        self.output = Array(name=self.name + ".output")
        self.demand("input", "mean", "rdisp")

    def initialize(self, device=None, **kwargs):
        res = super().initialize(device=device, **kwargs)
        if res:
            return res
        dtype = root.common.engine.precision_type
        if (self.output.mem is None
                or self.output.shape != self.input.shape):
            self.output.reset(numpy.zeros(self.input.shape, dtype=dtype))
        return None

    @staticmethod
    def compute_mean_rdisp(data: numpy.ndarray):
        """(mean, rdisp) of a dataset, through the registry's
        ``mean_disp`` normalizer (float64 sums on the host)."""
        from .normalization import MeanDispNormalizerHost
        host = MeanDispNormalizerHost()
        host.analyze(data)
        host._finish()
        return host.mean, host.rdisp

    @staticmethod
    def apply(x: torch.Tensor, mean: torch.Tensor,
              rdisp: torch.Tensor) -> torch.Tensor:
        return (x - mean) * rdisp

    def torch_run(self) -> None:
        self.output.assign_devmem(self.apply(
            self.input.device_view(self.device),
            self.mean.device_view(self.device),
            self.rdisp.device_view(self.device)))

    def numpy_run(self) -> None:
        x = self.input.map_read().astype(numpy.float32)
        self.output.reset(
            (x - self.mean.map_read()) * self.rdisp.map_read())

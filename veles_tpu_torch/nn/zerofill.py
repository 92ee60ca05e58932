"""ZeroFiller: a fixed sparsity mask on a forward unit's weights
(counterpart of ``veles_tpu/nn/zerofill.py``; layer type "zero_filler").

After every update the masked weights are forced back to zero. Once a
``TrainStep`` holds the target's parameters, the mask is registered with
the step (:meth:`TrainStep.register_param_mask`), which applies it after
every optimiser update inside a plan, not only between plans; until
then it multiplies the unit's own weight Array.
"""

from __future__ import annotations

from typing import Optional

import numpy

from ..error import VelesError
from ..memory import Array
from ..units import Unit


class ZeroFiller(Unit):
    MAPPING = "zero_filler"
    hide_from_registry = False

    def __init__(self, workflow, target=None,
                 mask: Optional[numpy.ndarray] = None,
                 grouping: int = 0, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.view_group = "WORKER"
        self.target = target
        self.mask = None if mask is None else Array(
            numpy.asarray(mask, dtype=numpy.float32),
            name=self.name + ".mask")
        self.grouping = int(grouping)
        self.demand("target")

    @staticmethod
    def grouping_mask(shape, groups: int) -> numpy.ndarray:
        """Block-diagonal mask: weights (in, out) partitioned into
        ``groups`` input/output blocks."""
        mask = numpy.zeros(shape, dtype=numpy.float32)
        gi, go = shape[0] // groups, shape[1] // groups
        if gi * groups != shape[0] or go * groups != shape[1]:
            raise VelesError("shape %s not divisible into %d groups"
                             % (shape, groups))
        for g in range(groups):
            mask[g * gi:(g + 1) * gi, g * go:(g + 1) * go] = 1.0
        return mask

    def initialize(self, **kwargs):
        res = super().initialize(**kwargs)
        if res:
            return res
        weights = getattr(self.target, "weights", None)
        if not isinstance(weights, Array) or not weights:
            return True     # the target has no weights yet: re-queue
        if self.mask is None:
            if not self.grouping:
                raise VelesError("%s: pass mask= or grouping=" % self.name)
            self.mask = Array(self.grouping_mask(weights.shape,
                                                 self.grouping),
                              name=self.name + ".mask")
        if tuple(self.mask.shape) != tuple(weights.shape):
            raise VelesError("%s: mask %s != weights %s" %
                             (self.name, self.mask.shape, weights.shape))
        self.run()          # enforced at once, as the reference's attach
        return None

    def run(self) -> None:
        step = getattr(self.workflow, "train_step", None)
        if step is not None and getattr(step, "params", None) and \
                self.target.name in step.params:
            step.register_param_mask(self.target.name, "weights",
                                     self.mask.map_read())
            return
        weights = self.target.weights
        if weights.devmem is not None:
            dev = weights.devmem.device
            weights.assign_devmem(weights.device_view(dev)
                                  * self.mask.device_view(dev))
        else:
            weights.reset(weights.map_read() * self.mask.map_read())

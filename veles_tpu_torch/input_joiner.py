"""InputJoiner: flatten each input past its batch axis and concatenate
them along the columns (counterpart of ``veles_tpu/input_joiner.py``;
one ``torch.cat`` on the workflow's device, no kernel of its own)."""

from __future__ import annotations

from typing import List

import numpy
import torch

from .accelerated import AcceleratedUnit
from .error import Bug
from .memory import Array


class InputJoiner(AcceleratedUnit):
    MAPPING = "input_joiner"
    hide_from_registry = False

    def __init__(self, workflow, inputs: List[Array] = (), **kwargs):
        super().__init__(workflow, **kwargs)
        self.view_group = "WORKER"
        self.inputs = list(inputs)
        self.output = Array(name=self.name + ".output")

    def initialize(self, device=None, **kwargs):
        res = super().initialize(device=device, **kwargs)
        if res:
            return res
        if not self.inputs:
            raise Bug("%s: no inputs to join" % self.name)
        b = self.inputs[0].shape[0]
        width = sum(int(numpy.prod(a.shape[1:])) for a in self.inputs)
        self.output.reset(numpy.zeros((b, width), dtype=numpy.float32))
        return None

    @staticmethod
    def apply(*xs: torch.Tensor) -> torch.Tensor:
        return torch.cat([x.reshape(x.shape[0], -1) for x in xs], dim=1)

    def param_arrays(self):
        return {}

    def torch_run(self) -> None:
        self.output.assign_devmem(
            self.apply(*[a.device_view(self.device) for a in self.inputs]))

    def numpy_run(self) -> None:
        self.output.reset(numpy.concatenate(
            [a.map_read().reshape(len(a.mem), -1) for a in self.inputs],
            axis=1))

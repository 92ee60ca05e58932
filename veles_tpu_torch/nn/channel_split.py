"""Channel splitting and merging of NHWC minibatches (counterpart of
``veles_tpu/nn/channel_split.py``; layer types "channel_splitter" and
"channel_merger").

:class:`ChannelSplitter` carves the channel axis into ``groups`` equal
parts or explicit ``sizes``, exposing ``outputs[i]`` (and ``output``,
the first group, so that it chains like any forward unit);
:class:`ChannelMerger` concatenates several producers' outputs back
along the channel axis. Both run as torch ops on the unit's device.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy
import torch

from ..config import root
from ..error import VelesError
from ..memory import Array
from .nn_units import ForwardBase


class ChannelSplitter(ForwardBase):
    """Split the trailing (channel) axis into ``groups`` equal parts or
    explicit ``sizes``."""

    MAPPING = "channel_splitter"
    hide_from_registry = False

    def __init__(self, workflow, groups: int = 0,
                 sizes: Sequence[int] = (), **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        if bool(groups) == bool(sizes):
            raise VelesError("%s: pass exactly one of groups / sizes"
                             % self.name)
        self.groups = int(groups)
        self.sizes: Tuple[int, ...] = tuple(int(s) for s in sizes)
        self.outputs: List[Array] = []

    def _resolve_sizes(self, channels: int) -> Tuple[int, ...]:
        if self.sizes:
            if sum(self.sizes) != channels:
                raise VelesError("%s: sizes %s != %d channels"
                                 % (self.name, self.sizes, channels))
            return self.sizes
        if channels % self.groups:
            raise VelesError("%s: %d channels not divisible into %d groups"
                             % (self.name, channels, self.groups))
        return (channels // self.groups,) * self.groups

    def output_shape_for(self, input_shape):
        sizes = self._resolve_sizes(input_shape[-1])
        return tuple(input_shape[:-1]) + (sizes[0],)

    def bounds(self, channels: int) -> List[Tuple[int, int]]:
        """[start, end) of each group."""
        sizes = self._resolve_sizes(channels)
        starts = numpy.cumsum((0,) + sizes[:-1])
        return [(int(s), int(s + n)) for s, n in zip(starts, sizes)]

    def apply(self, params, x):
        a, b = self.bounds(x.shape[-1])[0]
        return x[..., a:b]

    def initialize(self, device=None, **kwargs):
        res = super().initialize(device=device, **kwargs)
        if res:
            return res
        if self.input is not None and self.input:
            dtype = root.common.engine.precision_type
            self.outputs = [
                Array(numpy.zeros(self.input.shape[:-1] + (b - a,),
                                  dtype=dtype),
                      name="%s.out%d" % (self.name, i))
                for i, (a, b) in enumerate(
                    self.bounds(self.input.shape[-1]))]
            self.output = self.outputs[0]
        return None

    def torch_run(self) -> None:
        x = self.input.device_view(self.device)
        for arr, (a, b) in zip(self.outputs, self.bounds(x.shape[-1])):
            arr.assign_devmem(x[..., a:b].contiguous())


class ChannelMerger(ForwardBase):
    """Concatenate several producers' outputs along the channel axis."""

    MAPPING = "channel_merger"
    hide_from_registry = False

    def __init__(self, workflow, inputs: Sequence[Array] = (),
                 **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.inputs: List[Array] = list(inputs)
        self._demanded.discard("input")

    def verify_demands(self):
        missing = super().verify_demands()
        if not self.inputs:
            missing.append("inputs")
        return missing

    def output_shape_for(self, input_shape=None):
        first = self.inputs[0].shape
        ch = sum(a.shape[-1] for a in self.inputs)
        return tuple(first[:-1]) + (ch,)

    def apply(self, params, xs):
        return torch.cat(list(xs), dim=-1)

    def initialize(self, device=None, **kwargs):
        if not self.inputs or any(not a for a in self.inputs):
            return True
        self.input = self.inputs[0]     # satisfies the base demand
        res = super().initialize(device=device, **kwargs)
        if res:
            return res
        self.output.reset(numpy.zeros(
            self.output_shape_for(), dtype=root.common.engine.precision_type))
        return None

    def torch_run(self) -> None:
        self.output.assign_devmem(self.apply(
            {}, [a.device_view(self.device) for a in self.inputs]))

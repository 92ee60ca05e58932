"""Cutter: a static spatial crop of NHWC minibatches (counterpart of
``veles_tpu/nn/cutter.py``; layer type "cutter"). ``padding = (left,
top, right, bottom)`` pixels come off; the gradient (the crop's zero
padding) comes from autograd.
"""

from __future__ import annotations

from typing import Tuple

from .nn_units import ForwardBase


class Cutter(ForwardBase):
    """Crops ``padding = (left, top, right, bottom)`` pixels off NHWC."""

    MAPPING = "cutter"
    hide_from_registry = False

    def __init__(self, workflow, padding: Tuple[int, int, int, int] =
                 (0, 0, 0, 0), **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        if len(padding) != 4 or any(p < 0 for p in padding):
            raise ValueError("padding must be 4 non-negative ints "
                             "(left, top, right, bottom), got %r"
                             % (padding,))
        self.padding = tuple(int(p) for p in padding)

    def output_shape_for(self, input_shape):
        n, h, w = input_shape[0], input_shape[1], input_shape[2]
        left, top, right, bottom = self.padding
        oh, ow = h - top - bottom, w - left - right
        if oh <= 0 or ow <= 0:
            raise ValueError("%s: padding %s consumes the whole %dx%d "
                             "input" % (self.name, self.padding, h, w))
        return (n, oh, ow) + tuple(input_shape[3:])

    def apply(self, params, x):
        left, top, right, bottom = self.padding
        return x[:, top:x.shape[1] - bottom, left:x.shape[2] - right]

"""Depooling unit (counterpart of ``veles_tpu/nn/depooling.py``; layer
type "depooling", the autoencoder decoder's): nearest-neighbour
upsampling by (ky, kx), the inverse of a whole-window AvgPooling."""

from __future__ import annotations

from .nn_units import ForwardBase


class Depooling(ForwardBase):
    MAPPING = "depooling"
    hide_from_registry = False

    def __init__(self, workflow, kx=2, ky=2, **kwargs):
        super().__init__(workflow, **kwargs)
        self.kx, self.ky = kx, ky

    def output_shape_for(self, input_shape):
        b, h, w, c = input_shape
        return (b, h * self.ky, w * self.kx, c)

    def apply(self, params, x):
        return x.repeat_interleave(self.ky, dim=1).repeat_interleave(
            self.kx, dim=2)

"""Deconvolution (transposed convolution) unit and its GD unit
(counterpart of ``veles_tpu/nn/deconv.py``; layer type "deconv", the
ImagenetAE decoder's).

The reference stamps the kernel: it flips the HWIO kernel and calls
``conv_transpose``, whose net effect is its numpy oracle's scatter-add,
each input pixel adding ``x · W[ky, kx]`` at ``(i·sy + ky, j·sx + kx)``.
``F.conv_transpose2d`` stamps as well, so the HWIO weight goes in as its
(C_in, C_out, kH, kW) view with no flip. ``padding`` ``(left, top, right,
bottom)`` crops the stamped output; ``F.conv_transpose2d`` crops
symmetrically, so an asymmetric crop is a slice. Output H' = (H - 1)·sy +
ky - top - bottom. Bias is off by default; the dtypes follow
``nn/conv.py``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from ..memory import Array
from .. import prng
from ..ops.precision import promote_operands
from .conv import init_hwio
from .nn_units import ForwardBase, GradientDescentBase, matches


def conv_transpose2d_nhwc(x: torch.Tensor, w: torch.Tensor,
                          sliding: Sequence[int], padding: Sequence[int]
                          ) -> torch.Tensor:
    """(B, H, W, C_in) stamped with HWIO weights (C_in → C_out) at strides
    ``sliding = (sx, sy)``, cropped by ``padding = (left, top, right,
    bottom)`` → (B, H', W', C_out)."""
    left, top, right, bottom = padding
    sx, sy = sliding
    sym = left == right and top == bottom
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w.permute(2, 3, 0, 1),
                           stride=(sy, sx),
                           padding=(top, left) if sym else (0, 0))
    if not sym:
        y = y[:, :, top:y.shape[2] - bottom, left:y.shape[3] - right]
    return y.permute(0, 2, 3, 1)


class Deconv(ForwardBase):
    """Mirror of Conv: input (B, H, W, C_in) → (B, H', W', n_channels)."""

    MAPPING = "deconv"
    PARAMETERIZED = True
    hide_from_registry = False

    def __init__(self, workflow, n_channels=3, kx=3, ky=3,
                 sliding=(1, 1), padding=(0, 0, 0, 0), **kwargs) -> None:
        self.weights_stddev = kwargs.pop("weights_stddev", None)
        self.include_bias = kwargs.pop("include_bias", False)
        super().__init__(workflow, **kwargs)
        self.n_channels = n_channels
        self.kx, self.ky = kx, ky
        self.sliding = tuple(sliding)
        self.padding = tuple(padding)

    def output_shape_for(self, input_shape):
        b, h, w, _ = input_shape
        left, top, right, bottom = self.padding
        sx, sy = self.sliding
        return (b, (h - 1) * sy + self.ky - top - bottom,
                (w - 1) * sx + self.kx - left - right, self.n_channels)

    def create_params(self, rng: prng.RandomGenerator) -> Dict[str, Array]:
        return init_hwio(self.name, self.ky, self.kx, self.input.shape[-1],
                         self.n_channels, self.weights_stddev,
                         self.include_bias)

    def apply(self, params, x):
        xx, ww, ct = promote_operands(x, params["weights"])
        y = conv_transpose2d_nhwc(xx, ww, self.sliding, self.padding)
        if "bias" in params:
            y = y + params["bias"]
        return y.to(ct)


@matches(Deconv)
class GDDeconv(GradientDescentBase):
    MAPPING = "gd_deconv"

"""Convolution forward units and their GD units (counterpart of
``veles_tpu/nn/conv.py``; layer types "conv", "conv_tanh", "conv_relu",
"conv_sigmoid").

The parameters keep the reference's layout, so that carrying weights
across is a copy: NHWC activations, HWIO weights drawn from the unit's
keyed stream (normal, stddev ``weights_stddev`` or 1/sqrt(kx·ky·C)), a
zero bias unless ``include_bias=False``. ``forward`` permutes them to the
NCHW/OIHW views ``F.conv2d`` takes; an NHWC tensor viewed as NCHW is a
channels_last tensor, which cuDNN takes as it is. ``padding`` is the
reference's ``(left, top, right, bottom)``; an asymmetric one is padded
explicitly. As in the reference, the operands are promoted to their
common dtype and the result stays in it: a float32 conv is a full float32
conv (TF32 off, ``ops/precision.py``), a bf16 one accumulates in float32
and rounds once; the bias is added after that rounding, then the
activation. ``engine.conv_lane_pad`` pads the reference's channels to its
TPU's lane width with zeros, which changes no number; the port takes the
knob and does nothing with it.

On the card a float32 conv's weight gradient does not come from cuDNN:
for some shapes (AlexNet's 5×5 conv of 48 → 128 channels over 109×109,
whatever cuDNN's deterministic and benchmark flags say) its float32
weight gradient lies ~1e-2 of its largest element from the float64 one.
:class:`_CardConv2d` takes it as one batched product of the output
gradient with the input's im2col columns (``F.unfold``, cuBLAS in
float32), which is float32-grade (``chip_smoke.py`` ``train_alexnet``
measures both). The forward and the input gradient stay cuDNN's.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy
import torch
import torch.nn.functional as F

from ..config import root
from ..memory import Array
from .. import prng
from ..ops.precision import promote_operands
from .activation import scaled_tanh, strict_relu
from .nn_units import ForwardBase, GradientDescentBase, matches


def conv2d_weight_gemm(x: torch.Tensor, w_shape, gy: torch.Tensor,
                       stride, padding) -> torch.Tensor:
    """The weight gradient of ``F.conv2d(x, w, stride, padding)`` for
    the output gradient ``gy``: Σ_b gy_b · cols_bᵀ over the im2col
    columns of each sample, one batched product."""
    o, c, kh, kw = w_shape
    cols = F.unfold(x, (kh, kw), padding=padding, stride=stride)
    g = gy.reshape(gy.shape[0], o, -1)
    return torch.bmm(g, cols.transpose(1, 2)).sum(0).reshape(w_shape)


class _CardConv2d(torch.autograd.Function):
    """``F.conv2d`` whose weight gradient is :func:`conv2d_weight_gemm`;
    its forward and input gradient are cuDNN's."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding)
        return F.conv2d(x, w, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride, padding = ctx.conf
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.nn.grad.conv2d_input(x.shape, w, gy, stride, padding)
        if ctx.needs_input_grad[1]:
            gw = conv2d_weight_gemm(x, w.shape, gy, stride, padding)
        return gx, gw, None, None


def conv2d(x: torch.Tensor, w: torch.Tensor, stride, padding
           ) -> torch.Tensor:
    """``F.conv2d`` (NCHW, OIHW), through :class:`_CardConv2d` for a
    float32 conv on the card."""
    if x.is_cuda and x.dtype == torch.float32:
        return _CardConv2d.apply(x, w, stride, padding)
    return F.conv2d(x, w, stride=stride, padding=padding)


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, sliding: Sequence[int],
                padding: Sequence[int]) -> torch.Tensor:
    """(B, H, W, C) ⋆ HWIO weights → (B, H', W', O): the reference's
    ``conv_general_dilated`` with ``window_strides=(sy, sx)`` and
    ``padding=((top, bottom), (left, right))``."""
    left, top, right, bottom = padding
    sx, sy = sliding
    xc = x.permute(0, 3, 1, 2)
    if left == right and top == bottom:
        pad = (top, left)
    else:
        xc = F.pad(xc, (left, right, top, bottom))
        pad = (0, 0)
    y = conv2d(xc, w.permute(3, 2, 0, 1), (sy, sx), pad)
    return y.permute(0, 2, 3, 1)


def init_hwio(name: str, ky: int, kx: int, c_in: int, c_out: int,
              stddev, include_bias: bool) -> Dict[str, Array]:
    """A conv-family unit's parameters as the reference draws them: HWIO
    weights, normal at ``stddev`` or 1/sqrt(fan_in), from the unit's
    keyed stream; a zero bias when ``include_bias``."""
    stddev = stddev or (1.0 / numpy.sqrt(kx * ky * c_in))
    dtype = root.common.engine.precision_type
    w = numpy.zeros((ky, kx, c_in, c_out), dtype=dtype)
    prng.get(name).fill_normal(w, stddev)
    params = {"weights": Array(w, name=name + ".weights")}
    if include_bias:
        params["bias"] = Array(numpy.zeros((c_out,), dtype=dtype),
                               name=name + ".bias")
    return params


class Conv(ForwardBase):
    """Input (B, H, W, C) → output (B, H', W', n_kernels)."""

    MAPPING = "conv"
    PARAMETERIZED = True
    hide_from_registry = False

    def __init__(self, workflow, n_kernels=16, kx=3, ky=3,
                 sliding=(1, 1), padding=(0, 0, 0, 0), **kwargs) -> None:
        self.weights_stddev = kwargs.pop("weights_stddev", None)
        self.include_bias = kwargs.pop("include_bias", True)
        super().__init__(workflow, **kwargs)
        self.n_kernels = n_kernels
        self.kx, self.ky = kx, ky
        self.sliding = tuple(sliding)
        self.padding = tuple(padding)

    def output_shape_for(self, input_shape):
        b, h, w, _ = input_shape
        left, top, right, bottom = self.padding
        sx, sy = self.sliding
        return (b, (h + top + bottom - self.ky) // sy + 1,
                (w + left + right - self.kx) // sx + 1, self.n_kernels)

    def create_params(self, rng: prng.RandomGenerator) -> Dict[str, Array]:
        return init_hwio(self.name, self.ky, self.kx, self.input.shape[-1],
                         self.n_kernels, self.weights_stddev,
                         self.include_bias)

    def _conv(self, params, x):
        xx, ww, ct = promote_operands(x, params["weights"])
        y = conv2d_nhwc(xx, ww, self.sliding, self.padding)
        if "bias" in params:
            y = y + params["bias"]
        return y.to(ct)

    def activation(self, a):
        return a

    def apply(self, params, x):
        return self.activation(self._conv(self.merged_params(params), x))


class ConvTanh(Conv):
    """y = 1.7159·tanh(0.6666·a)."""

    MAPPING = "conv_tanh"
    A, B = 1.7159, 0.6666

    def activation(self, a):
        return scaled_tanh(a, self.A, self.B)


class ConvRelu(Conv):
    MAPPING = "conv_relu"

    def activation(self, a):
        return strict_relu(a)


class ConvSigmoid(Conv):
    MAPPING = "conv_sigmoid"

    def activation(self, a):
        return torch.sigmoid(a)


@matches(Conv)
class GDConv(GradientDescentBase):
    MAPPING = "gd_conv"
    hide_from_registry = False


@matches(ConvTanh)
class GDConvTanh(GradientDescentBase):
    MAPPING = "gd_conv_tanh"


@matches(ConvRelu)
class GDConvRelu(GradientDescentBase):
    MAPPING = "gd_conv_relu"


@matches(ConvSigmoid)
class GDConvSigmoid(GradientDescentBase):
    MAPPING = "gd_conv_sigmoid"

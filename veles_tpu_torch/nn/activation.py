"""Standalone activation units (counterpart of
``veles_tpu/nn/activation.py``; layer types "activation_tanh",
"activation_relu", "activation_str", "activation_sigmoid",
"activation_log", "activation_mul").

Parameterless forward units, each the reference's function in torch ops
with the reference's gradient: ``activation_relu`` is the softplus
log(1 + exp(x)), as in the reference; the hard max(x, 0) is
``activation_str``, whose gradient at a tie x = 0 is 1/2 as ``jnp.maximum``
gives it (``torch.maximum``'s). A Python constant beside a bf16 tensor is
rounded to bf16 first, as ``jnp`` takes it (``ops/precision.weak_scalar``).
"""

from __future__ import annotations

import torch

from ..ops.precision import weak_scalar
from .nn_units import ForwardBase


def strict_relu(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) with ``jnp.maximum``'s gradient (1/2 at x = 0)."""
    return torch.maximum(x, x.new_zeros(()))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as ``jax.nn.softplus`` (``logaddexp(x, 0)``)."""
    return torch.logaddexp(x, x.new_zeros(()))


def scaled_tanh(x: torch.Tensor, a: float, b: float) -> torch.Tensor:
    """a·tanh(b·x), the constants rounded to ``x``'s dtype."""
    return weak_scalar(a, x.dtype) * torch.tanh(weak_scalar(b, x.dtype) * x)


class ActivationForward(ForwardBase):
    hide_from_registry = True

    def output_shape_for(self, input_shape):
        return input_shape


class ForwardTanh(ActivationForward):
    MAPPING = "activation_tanh"
    hide_from_registry = False

    def apply(self, params, x):
        return torch.tanh(x)


class ForwardRelu(ActivationForward):
    """The reference's RELU unit: the softplus y = log(1 + exp(x)); the
    hard max(x, 0) is :class:`ForwardStrictRelu`."""

    MAPPING = "activation_relu"
    hide_from_registry = False

    def apply(self, params, x):
        return softplus(x)


class ForwardStrictRelu(ActivationForward):
    MAPPING = "activation_str"
    hide_from_registry = False

    def apply(self, params, x):
        return strict_relu(x)


class ForwardSigmoid(ActivationForward):
    MAPPING = "activation_sigmoid"
    hide_from_registry = False

    def apply(self, params, x):
        return torch.sigmoid(x)


class ForwardLog(ActivationForward):
    """y = log(x + sqrt(x² + 1)) (asinh)."""

    MAPPING = "activation_log"
    hide_from_registry = False

    def apply(self, params, x):
        return torch.asinh(x)


class ForwardMul(ActivationForward):
    """y = factor · x."""

    MAPPING = "activation_mul"
    hide_from_registry = False

    def __init__(self, workflow, factor=1.0, **kwargs):
        super().__init__(workflow, **kwargs)
        self.factor = factor

    def apply(self, params, x):
        return x * weak_scalar(self.factor, x.dtype)

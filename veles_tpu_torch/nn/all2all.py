"""Fully-connected (All2All) forward units and their GD units
(counterpart of ``veles_tpu/nn/all2all.py``).

Weights are stored (in_features, out_features) as in the reference and
initialised from the unit's keyed stream: normal with stddev
``weights_stddev`` or 1/sqrt(fan_in), bias zero unless ``bias_stddev``.
Products are full float32 (``ops/precision.py``: no TF32). As in the
reference, the operands are promoted to their common dtype, the product
is summed into a float32 result (``preferred_element_type``) to which the
bias is added, and only then is the sum cast to the operands' dtype: under
mixed precision a bf16 chain rounds once a layer, after the bias.
"""

from __future__ import annotations

from typing import Dict

import numpy
import torch

from ..config import root
from ..memory import Array
from .. import prng
from ..ops.precision import dot_f32, promote_operands
from .activation import scaled_tanh
from .nn_units import ForwardBase, GradientDescentBase, matches


class All2All(ForwardBase):
    """y = act(x @ W + b)."""

    MAPPING = "all2all"
    PARAMETERIZED = True
    hide_from_registry = False

    def __init__(self, workflow, output_sample_shape=(), **kwargs) -> None:
        self.weights_stddev = kwargs.pop("weights_stddev", None)
        self.bias_stddev = kwargs.pop("bias_stddev", None)
        self.include_bias = kwargs.pop("include_bias", True)
        super().__init__(workflow, **kwargs)
        if isinstance(output_sample_shape, int):
            output_sample_shape = (output_sample_shape,)
        self.output_sample_shape = tuple(output_sample_shape)

    @property
    def neurons_number(self) -> int:
        return int(numpy.prod(self.output_sample_shape))

    def output_shape_for(self, input_shape):
        return (input_shape[0],) + self.output_sample_shape

    def create_params(self, rng: prng.RandomGenerator) -> Dict[str, Array]:
        n_in = int(numpy.prod(self.input.shape[1:]))
        n_out = self.neurons_number
        stddev = self.weights_stddev or (1.0 / numpy.sqrt(n_in))
        dtype = root.common.engine.precision_type
        w = numpy.zeros((n_in, n_out), dtype=dtype)
        prng.get(self.name).fill_normal(w, stddev)
        params = {"weights": Array(w, name=self.name + ".weights")}
        if self.include_bias:
            b = numpy.zeros((n_out,), dtype=dtype)
            if self.bias_stddev:
                prng.get(self.name + ".bias").fill_normal(b, self.bias_stddev)
            params["bias"] = Array(b, name=self.name + ".bias")
        return params

    def _linear(self, params, x):
        xx, ww, ct = promote_operands(x.reshape(x.shape[0], -1),
                                      params["weights"])
        y = dot_f32(xx, ww)
        if "bias" in params:
            y = y + params["bias"]
        return y.to(ct).reshape((x.shape[0],) + self.output_sample_shape)

    def activation(self, a):
        return a

    def apply(self, params, x):
        return self.activation(self._linear(params, x))


class All2AllTanh(All2All):
    """Znicz all2all_tanh: y = 1.7159 * tanh(0.6666 * a) (LeCun scaled)."""

    MAPPING = "all2all_tanh"
    A, B = 1.7159, 0.6666

    def activation(self, a):
        return scaled_tanh(a, self.A, self.B)


class All2AllSoftmax(All2All):
    """Softmax output layer (layer type "softmax"); :meth:`logits` feeds
    the evaluator's fused log-softmax cross-entropy."""

    MAPPING = "softmax"

    def activation(self, a):
        return torch.softmax(a, dim=-1)

    def logits(self, params, x):
        return self._linear(params, x)


@matches(All2All)
class GradientDescent(GradientDescentBase):
    MAPPING = "gd"
    hide_from_registry = False


@matches(All2AllTanh)
class GDTanh(GradientDescentBase):
    MAPPING = "gd_tanh"


@matches(All2AllSoftmax)
class GDSoftmax(GradientDescentBase):
    MAPPING = "gd_softmax"

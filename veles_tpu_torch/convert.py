"""Parameter trees in the reference's layout → the port's modules.

The reference's parameter tree is ``{unit_name: {param: array}}`` —
exactly what ``veles_tpu.nn.sampling.params_of(wf)`` yields, converted
with ``numpy.asarray``. :func:`params_from_jax` loads such a tree into a
:class:`~veles_tpu_torch.nn.standard_workflow.Forwards` stack, checking
every name and shape. :func:`random_params` makes a tree of that layout
from a numpy seed, for runs that need weights but no trained model.
"""

from __future__ import annotations

from typing import Dict

import numpy
import torch

from .error import VelesError

ParamTree = Dict[str, Dict[str, numpy.ndarray]]


def _parameterised(forwards):
    return {layer.name: layer for layer in forwards
            if layer.param_shapes()}


def params_from_jax(forwards, params: ParamTree):
    """Copy ``params`` into ``forwards`` (in place) and return it. The
    unit names, each unit's parameter names and every shape must match
    the stack exactly; anything else raises :class:`VelesError` before
    a single tensor is written."""
    layers = _parameterised(forwards)
    missing = sorted(set(layers) - set(params))
    extra = sorted(set(params) - set(layers))
    if missing or extra:
        raise VelesError("parameter tree units do not match the stack: "
                         "missing %s, unexpected %s" % (missing, extra))
    staged = []
    for name, layer in layers.items():
        shapes = layer.param_shapes()
        got = params[name]
        if set(got) != set(shapes):
            raise VelesError(
                "unit %r: parameters %s, expected %s"
                % (name, sorted(got), sorted(shapes)))
        for pname, shape in shapes.items():
            arr = numpy.asarray(got[pname])
            if tuple(arr.shape) != tuple(shape):
                raise VelesError("unit %r param %r: shape %s, expected %s"
                                 % (name, pname, arr.shape, shape))
            staged.append((getattr(layer, pname), arr))
    with torch.no_grad():
        for tensor, arr in staged:
            # a writable host copy: the tree may hold read-only views
            tensor.copy_(torch.from_numpy(numpy.array(
                arr, dtype=numpy.float32)))
    return forwards


def random_params(forwards, seed: int = 0) -> ParamTree:
    """A parameter tree for ``forwards`` in the reference's layout, drawn
    from ``numpy.random.RandomState(seed)`` with the reference's
    initialisers: normal tables at stddev 0.02, weight matrices at
    1/sqrt(fan_in), norm gains 1 and biases 0."""
    rng = numpy.random.RandomState(seed)
    tree: ParamTree = {}
    for name, layer in _parameterised(forwards).items():
        out = {}
        for pname, shape in layer.param_shapes().items():
            if pname == "table":
                w = rng.normal(0.0, 0.02, shape)
            elif pname.endswith("_g"):
                w = numpy.ones(shape)
            elif len(shape) == 1:
                w = numpy.zeros(shape)
            else:
                w = rng.normal(0.0, 1.0 / numpy.sqrt(shape[0]), shape)
            out[pname] = w.astype(numpy.float32)
        tree[name] = out
    return tree

"""Parameter trees in the reference's layout → the port's modules.

The reference's parameter tree is ``{unit_name: {param: array}}`` —
what ``veles_tpu.nn.sampling.params_of(wf)`` or, for a training
workflow, ``jax.device_get(wf.train_step.params)`` yields.
:func:`params_from_jax` loads such a tree into a
:class:`~veles_tpu_torch.nn.standard_workflow.Forwards` stack or into
an initialised :class:`~veles_tpu_torch.nn.standard_workflow.
StandardWorkflow` (with its optimiser state — SGD's delta recurrence or
Adam's ``{"m", "v", "t"}`` — so a run resumes on the identical
trajectory), checking every name and shape first.
:func:`random_params` makes a tree of that layout from a numpy seed, for
runs that need weights but no trained model.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy
import torch

from .error import VelesError

ParamTree = Dict[str, Dict[str, numpy.ndarray]]
Shapes = Dict[str, Dict[str, Tuple[int, ...]]]


def _parameterised(forwards):
    return {layer.name: layer for layer in forwards
            if layer.param_shapes()}


def _stage(shapes: Shapes, tree: ParamTree, what: str
           ) -> List[Tuple[str, str, numpy.ndarray]]:
    """(unit, param, float32 host copy) for every entry of ``shapes``;
    raises :class:`VelesError` on any unit, parameter or shape that does
    not match, before anything is written."""
    missing = sorted(set(shapes) - set(tree))
    extra = sorted(set(tree) - set(shapes))
    if missing or extra:
        raise VelesError("%s units do not match: missing %s, unexpected %s"
                         % (what, missing, extra))
    staged = []
    for name, params in shapes.items():
        got = tree[name]
        if set(got) != set(params):
            raise VelesError("%s unit %r: parameters %s, expected %s"
                             % (what, name, sorted(got), sorted(params)))
        for pname, shape in params.items():
            arr = numpy.asarray(got[pname])
            if tuple(arr.shape) != tuple(shape):
                raise VelesError("%s unit %r param %r: shape %s, expected "
                                 "%s" % (what, name, pname, arr.shape,
                                         shape))
            # a writable host copy: the tree may hold read-only views
            staged.append((name, pname,
                           numpy.array(arr, dtype=numpy.float32)))
    return staged


def _stage_state(want, got, what: str, path: Tuple[str, ...] = ()):
    """(path, host copy) for every leaf of ``want`` — one unit's
    optimiser state in the port, a dict of tensors, nested for Adam —
    checked entry by entry and shape by shape against ``got``; the copy
    takes the port's dtype (float32 moments, an int32 step count)."""
    where = "%s %s" % (what, "/".join(path) or "")
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise VelesError("%s: entries %s, expected %s"
                             % (where, sorted(got) if isinstance(got, dict)
                                else type(got).__name__, sorted(want)))
        return [leaf for k in want
                for leaf in _stage_state(want[k], got[k], what, path + (k,))]
    arr = numpy.asarray(got)
    if tuple(arr.shape) != tuple(want.shape):
        raise VelesError("%s: shape %s, expected %s"
                         % (where, arr.shape, tuple(want.shape)))
    return [(path, numpy.array(arr, dtype=str(want.dtype).split(".")[-1]))]


def params_from_jax(target, params: ParamTree,
                    opt_state: Optional[Dict[str, object]] = None):
    """Copy ``params`` (and, for a workflow, its ``opt_state`` in the
    reference's layout: per unit SGD's tree of the params' layout, or
    Adam's ``{"m": tree, "v": tree, "t": step}``) into ``target`` in
    place and return it. ``target`` is a ``Forwards`` stack or an
    initialised ``StandardWorkflow``."""
    step = getattr(target, "train_step", None)
    if step is None:
        if opt_state is not None:
            raise VelesError("opt_state loads into a StandardWorkflow, "
                             "not a forward stack")
        layers = _parameterised(target)
        staged = _stage({n: l.param_shapes() for n, l in layers.items()},
                        params, "parameter tree")
        with torch.no_grad():
            for name, pname, arr in staged:
                getattr(layers[name], pname).copy_(torch.from_numpy(arr))
        return target
    if not step.params:
        raise VelesError("initialize() the workflow before loading "
                         "parameters into it")
    shapes = {n: {k: tuple(t.shape) for k, t in p.items()}
              for n, p in step.params.items()}
    staged = _stage(shapes, params, "parameter tree")
    staged_opt = []
    if opt_state is not None:
        if set(opt_state) != set(step.opt_state):
            raise VelesError("opt_state units do not match: %s, expected %s"
                             % (sorted(opt_state), sorted(step.opt_state)))
        staged_opt = [((name,) + path, arr)
                      for name, state in step.opt_state.items()
                      for path, arr in _stage_state(
                          state, opt_state[name], "opt_state %s" % name)]
    for name, pname, arr in staged:
        step.params[name][pname] = torch.from_numpy(arr).to(step.device)
    for path, arr in staged_opt:
        node = step.opt_state
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = torch.from_numpy(arr).to(step.device)
    step.sync_params_to_arrays()
    return target


def random_params(forwards, seed: int = 0) -> ParamTree:
    """A parameter tree for ``forwards`` in the reference's layout, drawn
    from ``numpy.random.RandomState(seed)`` with the reference's
    initialisers: normal tables at stddev 0.02, weight matrices at
    1/sqrt(fan_in), norm gains 1, biases 0, and a layer's
    ``deterministic_params()`` (the SSM block's decay logits ``a_log``)
    as the layer gives them, drawing nothing."""
    rng = numpy.random.RandomState(seed)
    tree: ParamTree = {}
    for name, layer in _parameterised(forwards).items():
        out = {}
        fixed = getattr(layer, "deterministic_params", dict)()
        for pname, shape in layer.param_shapes().items():
            if pname in fixed:
                w = numpy.asarray(fixed[pname])
            elif pname == "table":
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

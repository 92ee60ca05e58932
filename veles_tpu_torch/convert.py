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

The trees are checked against the layout each unit gives, so the
units of every slice carry as they are: the MoE layer's expert-leading
3-D ``w1`` (E, D, F) and ``w2`` (E, F, D), the multi-head attention
unit's ``wk``/``wv`` at ``kv_d`` = D / n_heads · n_kv_heads columns, and
GDRProp's optimiser state ``{"step": tree, "prev_grad": tree}``.

A LoRA'd unit's tree carries its adapters beside the base weights
(``<k>_lora_a``, ``<k>_lora_b``), as the reference's train step holds
them; they load into the port's workflow like any parameter (and its
optimiser state with them). :func:`vocab_from_jax` pins a port
``TextFileLoader`` to the reference loader's vocabulary, so both encode
a corpus to the same ids.

A tree of the reference's int8 serving twin (``veles_tpu.quant.
quantize_params``: ``{"q", "scale"}`` records) or a snapshot's
``__quant__`` records load as the dequantized weights, ``q · s`` in
float32, bit for bit the port's ``quant.dequantize_params``.

Both also take the units that train outside a ``TrainStep`` — the
Kohonen map (``weights``) and the RBM (``weights``, ``vbias``,
``hbias``) — as an iterable of units or as the workflow holding them
(DemoKohonen's); such a unit's parameters are its host Arrays, rebound
to the loaded values. :func:`params_from_jax` takes the initialised
forward units of any other workflow the same way (the classic serving
workflow, ``Repeater → RestfulLoader → forwards → RESTfulAPI``), their
shapes read from their parameter Arrays.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy
import torch

from .error import VelesError
from .memory import Array

ParamTree = Dict[str, Dict[str, numpy.ndarray]]
Shapes = Dict[str, Dict[str, Tuple[int, ...]]]


def _param_shapes(layer) -> Dict[str, Tuple[int, ...]]:
    """A layer's or unit's parameter shapes: its ``param_shapes()``, else
    the shapes of its initialised parameter Arrays (a forward unit of a
    workflow, as the classic serving workflow's), else none."""
    if callable(getattr(layer, "param_shapes", None)):
        return layer.param_shapes()
    if callable(getattr(layer, "param_arrays", None)):
        return {k: tuple(v.shape) for k, v in layer.param_arrays().items()}
    return {}


def _parameterised(forwards):
    """{name: layer} of the layers or units with parameters; a unit
    without any (a loader, a decision, the REST unit) is passed over."""
    return {layer.name: layer for layer in forwards if _param_shapes(layer)}


def _host_array(val) -> numpy.ndarray:
    """A tree leaf as a host array; an int8 record (``{"q", "scale"}``,
    with or without the snapshot marker) as its float32 ``q · s``."""
    if isinstance(val, dict) and "q" in val and "scale" in val:
        from .ops.precision import dequantize_int8
        return dequantize_int8(numpy.asarray(val["q"]),
                               numpy.asarray(val["scale"])).numpy()
    return numpy.asarray(val)


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
            arr = _host_array(got[pname])
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
    reference's layout: per unit SGD's tree of the params' layout,
    Adam's ``{"m": tree, "v": tree, "t": step}`` or GDRProp's ``{"step":
    tree, "prev_grad": tree}``) into ``target`` in
    place and return it. ``target`` is a ``Forwards`` stack or an
    initialised ``StandardWorkflow``."""
    step = getattr(target, "train_step", None)
    if step is None:
        if opt_state is not None:
            raise VelesError("opt_state loads into a StandardWorkflow, "
                             "not a forward stack")
        layers = _parameterised(target)
        staged = _stage({n: _param_shapes(l) for n, l in layers.items()},
                        params, "parameter tree")
        with torch.no_grad():
            for name, pname, arr in staged:
                have = getattr(layers[name], pname, None)
                if isinstance(have, torch.Tensor):
                    have.copy_(torch.from_numpy(arr))
                elif isinstance(have, Array) and have:
                    have.reset(arr)
                else:
                    setattr(layers[name], pname, Array(
                        arr, name="%s.%s" % (name, pname)))
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


def vocab_from_jax(loader, vocab) -> object:
    """Give the port's text loader ``loader`` the vocabulary ``vocab``
    (a string, or the reference's ``TextFileLoader`` holding one), its
    character ids and the reserved unknown id one past it, before
    ``load_data`` encodes the corpus; a loader that already encoded with
    another vocabulary raises."""
    vocab = getattr(vocab, "vocab", vocab)
    if not isinstance(vocab, str) or not vocab:
        raise VelesError("vocab_from_jax needs a vocabulary string, got %r"
                         % (vocab,))
    if loader.char_to_id and loader.vocab != vocab:
        raise VelesError("%s already encoded its corpus with another "
                         "vocabulary" % loader.name)
    loader.vocab = vocab
    loader.char_to_id = {c: i for i, c in enumerate(vocab)}
    return loader


def random_params(forwards, seed: int = 0) -> ParamTree:
    """A parameter tree for ``forwards`` in the reference's layout, drawn
    from ``numpy.random.RandomState(seed)`` with the reference's
    initialisers: normal tables at stddev 0.02, weight matrices at the
    unit's ``weights_stddev`` where it has one (the Kohonen map's 0.05,
    the RBM's 0.01), else 1/sqrt(fan_in), norm gains 1, biases 0, and a
    layer's ``deterministic_params()`` (the SSM block's decay logits
    ``a_log``) as the layer gives them, drawing nothing."""
    rng = numpy.random.RandomState(seed)
    tree: ParamTree = {}
    for name, layer in _parameterised(forwards).items():
        out = {}
        fixed = getattr(layer, "deterministic_params", dict)()
        for pname, shape in _param_shapes(layer).items():
            if pname in fixed:
                w = numpy.asarray(fixed[pname])
            elif pname == "table":
                w = rng.normal(0.0, 0.02, shape)
            elif pname.endswith("_g"):
                w = numpy.ones(shape)
            elif len(shape) == 1:
                w = numpy.zeros(shape)
            else:
                stddev = (getattr(layer, "weights_stddev", None)
                          if pname == "weights" else None)
                w = rng.normal(0.0, stddev or 1.0 / numpy.sqrt(shape[0]),
                               shape)
            out[pname] = w.astype(numpy.float32)
        tree[name] = out
    return tree

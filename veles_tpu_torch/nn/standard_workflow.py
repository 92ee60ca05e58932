"""Layer configs → a module stack or a whole training graph
(counterpart of ``veles_tpu/nn/standard_workflow.py``).

:class:`StandardWorkflow` builds the training loop from a ``layers``
list and a loader, as the reference does::

    StartPoint → Repeater → Loader → TrainStep → [LRAdjust] → Decision ┐
                    ↑                                                  │
                    └────────────── (not complete) ────────────────────┘
                      (improved or complete) → [Snapshotter] →
                                    (complete) → EndPoint

Its forward units are the All2All units (``nn/all2all.py``), the conv
family (``nn/conv.py``, ``deconv.py``, ``pooling.py``, ``depooling.py``,
``activation.py``, ``normalization.py``, ``dropout.py``, ``cutter.py``,
``channel_split.py``), the transformer LM units (``nn/transformer.py``)
and the recurrent units (``nn/rnn.py``'s LSTM and RNN, ``nn/ssm.py``'s
SSM block), named as the reference names them; the per-minibatch compute
is the TrainStep. A net may be given as the reference's
``mcdnnic_topology`` string instead of ``layers`` (:func:`parse_mcdnnic`),
with ``mcdnnic_parameters`` merged into every layer. Losses: ``"softmax"`` (labels, ``EvaluatorSoftmax``),
``"softmax_seq"`` (per-token targets, ``EvaluatorSoftmaxSeq``, the
language models) and ``"mse"`` (``EvaluatorMSE`` and ``DecisionMSE``,
the autoencoders; ``target_mode`` "input", "targets" or, by default,
"auto"). ``evaluator_config`` passes the softmax evaluator's knobs
(``label_smoothing``, ``compute_confusion``).

:func:`build_forwards` takes the same ``layers`` list of dicts that the
reference's ``StandardWorkflow`` takes (``models/char_lm.py``
``build_workflow``/``build_bench_workflow`` pass it) and returns the
port's module stack, each layer named as the reference names its unit:
the dict's ``"name"``, else ``"<type><index>"``. The serving modules
take no training, so there the keys that configure it (solver, learning
rates, decay, initialisers) are accepted and ignored.
:func:`forwards_of` builds that stack from a training workflow and its
trained parameters.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn

from ..accelerated import AcceleratedWorkflow
from ..backends import device_for
from ..config import root
from ..error import VelesError
from ..plumbing import Repeater
from ..units import UnitRegistry
# the imports register the layer types
from . import activation, all2all, conv, deconv, depooling, pooling  # noqa
from . import channel_split, cutter, dropout, normalization  # noqa
from . import kohonen, rbm, rnn, ssm, zerofill  # noqa
from .decision import DecisionGD, DecisionMSE
from .evaluator import EvaluatorMSE, EvaluatorSoftmax, EvaluatorSoftmaxSeq
from .lr_adjust import LearningRateAdjust
from .nn_units import ForwardBase
from .train_step import TrainStep
from .transformer import (Embedding, LMHead, PositionalEmbedding,
                          TransformerBlock)

#: ported loss functions: "softmax" on labels, "softmax_seq" per token,
#: "mse" on targets or the input
LOSSES = ("softmax", "softmax_seq", "mse")

#: layer-dict keys that configure training only
TRAINING_KEYS = frozenset((
    "solver", "learning_rate", "learning_rate_bias", "weights_decay",
    "weights_decay_bias", "gradient_moment", "gradient_moment_bias",
    "l1_vs_l2", "weights_stddev", "bias_stddev", "stddev"))


def parse_mcdnnic(topology: str,
                  common: Optional[Dict[str, Any]] = None
                  ) -> List[Dict[str, Any]]:
    """The reference's ``mcdnnic_topology`` shorthand → a ``layers``
    list (e.g. ``"3x32x32-16C5-MP2-64N-10N"``): the first dash-token is
    the input geometry (informational), ``<n>C<k>`` a conv_tanh layer of
    n k×k kernels, ``MP<k>`` k×k max pooling, ``<n>N`` an all2all_tanh
    layer of n; the last N becomes the softmax head. ``common`` (e.g.
    the learning rate and the solver) is merged into every layer."""
    common = dict(common or {})
    tokens = topology.split("-")
    if len(tokens) < 2:
        raise VelesError("mcdnnic topology needs input+layers: %r"
                         % topology)
    layers: List[Dict[str, Any]] = []
    for tok in tokens[1:]:
        m = re.fullmatch(r"(\d+)C(\d+)", tok)
        if m:
            layers.append(dict(common, type="conv_tanh",
                               n_kernels=int(m.group(1)),
                               kx=int(m.group(2)), ky=int(m.group(2))))
            continue
        m = re.fullmatch(r"MP(\d+)", tok)
        if m:
            layers.append(dict(common, type="max_pooling",
                               kx=int(m.group(1)), ky=int(m.group(1))))
            continue
        m = re.fullmatch(r"(\d+)N", tok)
        if m:
            layers.append(dict(common, type="all2all_tanh",
                               output_sample_shape=int(m.group(1))))
            continue
        raise VelesError("bad mcdnnic token %r in %r" % (tok, topology))
    if layers and layers[-1]["type"] == "all2all_tanh":
        layers[-1]["type"] = "softmax"
    return layers


class Forwards(nn.Module):
    """The ordered forward stack; ``layers[name]`` is the layer the
    reference calls ``name``."""

    def __init__(self, layers: Dict[str, nn.Module]) -> None:
        super().__init__()
        self.layers = nn.ModuleDict(layers)

    def __iter__(self):
        return iter(self.layers.values())

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward(self, ids):
        """Full-window forward: (B, T) ids → (B, T, V) logits."""
        x = ids
        for layer in self.layers.values():
            x = layer(x)
        return x


def build_forwards(layers: List[dict], seq_len: Optional[int] = None,
                   device=None) -> Forwards:
    """Turn a reference ``layers`` config into a :class:`Forwards` stack
    with zero parameters on ``device`` (default: the card), in
    ``root.common.engine.precision_type``. Widths flow from the
    embedding's ``dim``; a ``pos_embedding`` layer needs the table
    length ``seq_len`` (the reference sizes it from its loader's
    sequence length)."""
    device = device_for(device)
    dtype = getattr(torch, str(root.common.engine.precision_type))
    out: Dict[str, nn.Module] = {}
    dim = None
    for i, cfg in enumerate(layers):
        cfg = {k: v for k, v in cfg.items() if k not in TRAINING_KEYS}
        kind = cfg.pop("type")
        name = cfg.pop("name", "%s%d" % (kind, i))
        kw = dict(cfg, name=name, device=device, dtype=dtype)
        if kind == "embedding":
            layer = Embedding(**kw)
            dim = layer.dim
        elif dim is None:
            raise VelesError("layer %r: the stack must start with an "
                             "embedding" % name)
        elif kind == "pos_embedding":
            if seq_len is None:
                raise VelesError("layer %r: pos_embedding needs seq_len"
                                 % name)
            layer = PositionalEmbedding(seq_len, dim, **kw)
        elif kind == "transformer_block":
            layer = TransformerBlock(dim, **kw)
        elif kind == "lm_head":
            layer = LMHead(dim, **kw)
        elif kind in ("lstm", "rnn"):
            cls = rnn.LSTMLayer if kind == "lstm" else rnn.RNNLayer
            layer = cls(dim, **kw)
            dim = layer.hidden_size
        elif kind == "ssm_block":
            layer = ssm.SSMBlockLayer(dim, **kw)
        else:
            raise VelesError("layer type %r is not ported yet" % (kind,))
        if name in out:
            raise VelesError("duplicate layer name %r" % name)
        out[name] = layer
    return Forwards(out)


def _unit_class(type_name: str) -> type:
    cls = UnitRegistry.mapping.get(type_name)
    if cls is None or not issubclass(cls, ForwardBase):
        raise VelesError("layer type %r is not ported yet (have: %s)"
                         % (type_name, sorted(
                             k for k, c in UnitRegistry.mapping.items()
                             if issubclass(c, ForwardBase))))
    return cls


class StandardWorkflow(AcceleratedWorkflow):
    """Declarative training-graph builder: the reference's constructor,
    for ``loss_function`` "softmax", "softmax_seq" and "mse" (whose
    ``target_mode`` defaults to "auto"; the other losses ignore it, as
    the reference's do), from ``layers`` or from ``mcdnnic_topology``
    (not both). ``initialize(device=None)`` runs on the card; pass
    ``device="cpu"`` to run on the host."""

    hide_from_registry = True

    def __init__(self, workflow=None, layers: Sequence[Dict[str, Any]] = (),
                 loader_unit=None, loss_function: str = "softmax",
                 decision_config: Optional[Dict[str, Any]] = None,
                 lr_schedule=None, snapshotter_unit=None,
                 steps_per_dispatch: int = 16,
                 epochs_per_dispatch: int = 1, target_mode: str = None,
                 remat: bool = False, grad_accumulation: int = 1,
                 evaluator_config: Optional[Dict[str, Any]] = None,
                 mcdnnic_topology: str = None,
                 mcdnnic_parameters: Optional[Dict[str, Any]] = None,
                 **kwargs):
        if kwargs.pop("pipeline_microbatches", None) not in (None, False,
                                                             1):
            raise VelesError("StandardWorkflow(pipeline_microbatches=...) "
                             "is not ported yet (ROADMAP Queue 1 item 10: "
                             "distribution)")
        #: extra EvaluatorSoftmax knobs (label_smoothing,
        #: compute_confusion), as the reference routes them
        self._evaluator_config = dict(evaluator_config or {})
        if loss_function not in LOSSES:
            raise VelesError("loss_function %r is not ported yet (%s)"
                             % (loss_function, ", ".join(LOSSES)))
        self._target_mode = target_mode
        self._steps_per_dispatch = steps_per_dispatch
        self._epochs_per_dispatch = epochs_per_dispatch
        self._remat = remat
        self._grad_accumulation = grad_accumulation
        super().__init__(workflow, **kwargs)
        if mcdnnic_topology:
            if layers:
                raise VelesError("pass layers OR mcdnnic_topology, "
                                 "not both")
            layers = parse_mcdnnic(mcdnnic_topology, mcdnnic_parameters)
        self.layers_config = list(layers)
        self.loss_function = loss_function
        self.loader = loader_unit
        if self.loader is not None:
            self.loader.workflow = self
            self.add_ref(self.loader)
        self.forwards: List[ForwardBase] = []
        self.repeater = Repeater(self)
        self._build_forwards()
        self._build_trainer(decision_config or {}, lr_schedule)
        if snapshotter_unit is not None:
            self._attach_snapshotter(snapshotter_unit)
        self._wire_loop()

    def _build_forwards(self) -> None:
        prev = None
        for i, cfg in enumerate(self.layers_config):
            cfg = dict(cfg)
            type_name = cfg.pop("type")
            cls = _unit_class(type_name)
            name = cfg.pop("name", "%s%d" % (type_name, i))
            unit = cls(self, name=name, **cfg)
            if prev is None:
                unit.link_attrs(self.loader, ("input", "minibatch_data"))
            else:
                unit.link_attrs(prev, ("input", "output"))
            self.forwards.append(unit)
            prev = unit

    def _build_trainer(self, decision_config, lr_schedule) -> None:
        n_classes = None
        if self.forwards and hasattr(self.forwards[-1], "neurons_number"):
            n_classes = self.forwards[-1].neurons_number
        if self.loss_function == "softmax":
            self.evaluator = EvaluatorSoftmax(self, n_classes=n_classes,
                                              **self._evaluator_config)
            self.decision = DecisionGD(self, **decision_config)
            target_mode = "labels"
        elif self.loss_function == "softmax_seq":
            # language modelling: per-token CE on (B, T) int targets
            self.evaluator = EvaluatorSoftmaxSeq(self)
            self.decision = DecisionGD(self, **decision_config)
            target_mode = "targets"
        else:
            self.evaluator = EvaluatorMSE(self)
            self.decision = DecisionMSE(self, **decision_config)
            # the loader has not loaded yet: TrainStep resolves "auto"
            target_mode = self._target_mode or "auto"
        self.train_step = TrainStep(
            self, forwards=self.forwards, evaluator=self.evaluator,
            loader=self.loader, target_mode=target_mode,
            steps_per_dispatch=self._steps_per_dispatch,
            epochs_per_dispatch=self._epochs_per_dispatch,
            remat=self._remat, grad_accumulation=self._grad_accumulation)
        self.decision.loader = self.loader
        self.decision.step_unit = self.train_step
        if self._epochs_per_dispatch > 1 and self.loader is not None:
            # the final block clamps to the epochs left under max_epochs
            self.loader.block_epochs_cap = self.decision.max_epochs
        if lr_schedule is not None:
            self.lr_adjust = LearningRateAdjust(self, schedule=lr_schedule)
            self.lr_adjust.decision = self.decision
            self.train_step.link_attrs(self.lr_adjust, "lr_scale")
        else:
            self.lr_adjust = None

    def _attach_snapshotter(self, snap) -> None:
        snap.workflow = self
        self.add_ref(snap)
        self.snapshotter = snap

    def _wire_loop(self) -> None:
        self.repeater.link_from(self.start_point)
        self.loader.link_from(self.repeater)
        self.train_step.link_from(self.loader)
        tail = self.train_step
        if self.lr_adjust is not None:
            self.lr_adjust.link_from(self.train_step)
            tail = self.lr_adjust
        self.decision.link_from(tail)
        self.repeater.link_from(self.decision)
        self.repeater.gate_block = self.decision.complete
        after = self.decision
        snap = getattr(self, "snapshotter", None)
        if snap is not None:
            # a snapshot when the decision improved or completed
            snap.link_from(self.decision)
            snap.gate_skip = ~self.decision.complete & ~self.decision.improved
            after = snap
        self.end_point.link_from(after)
        self.end_point.gate_block = ~self.decision.complete

    def get_metric_values(self) -> Dict[str, Any]:
        return self.decision.get_metric_values()


def forwards_of(wf: StandardWorkflow) -> Forwards:
    """The serving stack of a trained LM workflow: :func:`build_forwards`
    from its ``layers`` config on its device, holding a copy of its
    train step's current parameters (what the sampler runs)."""
    step = wf.train_step
    if not step.params:
        raise VelesError("initialize() the workflow before serving it")
    seq_len = wf.loader.original_data.shape[1] \
        if wf.loader.original_data else None
    stack = build_forwards(wf.layers_config, seq_len=seq_len,
                           device=step.device)
    with torch.no_grad():
        for layer in stack:
            for pname, t in layer.params().items():
                t.copy_(step.params[layer.name][pname])
    return stack

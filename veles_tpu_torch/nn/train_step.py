"""TrainStep: the training step of the workflow (counterpart of
``veles_tpu/nn/train_step.py``, single device).

It owns the canonical device-side parameter tree ``params``
(``{unit: {param: tensor}}``) and the optimiser state ``opt_state`` (per
unit, its GD rule's state: the SGD delta recurrence of the parameters'
layout, or Adam's ``{"m", "v", "t"}``) and runs what the loader serves.
The targets are the rows' labels (``target_mode="labels"``), the
loader's row-aligned targets (``"targets"``: a language model's next
tokens) or the minibatch itself (``"input"``: an autoencoder's, in the
dataset's dtype, before any mixed-precision cast); ``"auto"`` resolves
at initialize to ``"targets"`` if the loader has them, else ``"input"``:

- the general path: per minibatch, an autograd forward and the loss,
  then ``_apply_updates`` — each unit's GD rule, gated so that an
  all-padded plan row changes nothing. A plan of K minibatches is a
  Python loop of eager torch ops (a CUDA graph of it is later work)
  over the plan's served rows only;
- the classic mode (one plan of one sample class per run) and the epoch
  block (``epochs_per_dispatch`` = H > 1: H whole epochs per run, each
  the test and validation evaluation plans, then the train plan);
- the fused path: with ``root.common.engine.fused_fc_scan`` on and the
  chain eligible (``_setup_fused_fc``, every rejection logged), the
  train segment of each epoch of a block is ONE call of
  ``ops.fused_fc.fused_fc_sgd_epoch`` — one launch of the hand-written
  kernel on the card. A block with a partial train batch falls back to
  the general path, as in the reference.

Metrics accumulate on the device and reach the host once per drain
(``drain_epoch_blocks``). An epoch block runs inside a
``train_step.epoch_block`` span; :meth:`TrainStep.cost_report` is the
FLOPs and bytes of what the step dispatched (telemetry/cost.py).

The reference's memory and precision knobs:

- ``root.common.engine.mixed_precision``: the train and eval steps run
  the forward (and autograd its backward) on a bf16 view of the params
  and of a float batch (``ops/precision.amp_cast``); the masters, the
  optimiser state, the gradients that reach it, the loss and the metric
  sums stay float32;
- ``root.common.engine.bf16_activations`` (under mixed precision only;
  ignored with the reference's warning otherwise): an interlayer
  activation that leaves a unit float32 is stored bf16; the head's
  output is not;
- ``remat=True``: the forward runs under one ``torch.utils.checkpoint``
  (non-reentrant, RNG state kept), its activations recomputed in the
  backward — the same numbers, less memory;
- ``grad_accumulation=G``: each minibatch runs as G chunks, one backward
  each, and ONE update from the float32 chunk gradients weighted by the
  chunks' valid rows.

None of them reaches the fused-FC kernel, which refuses each with the
reference's reason.

Random units (``NEEDS_RNG``: dropout, stochastic pooling) draw from a
``torch.Generator`` of their own on the step's device, seeded from the
step's stream (``prng.get(self.name)``), the train step's number, the
accumulation chunk and the layer's index; the generator is made anew
each time the forward runs, so a recomputation under ``remat`` redraws
the same mask (``torch.utils.checkpoint`` restores the global RNG, not
an explicit generator). The reference folds its threefry key with the
same numbers, whose bits the port cannot reproduce. In evaluation they
draw nothing.

The training library's knobs, as the reference's:

- tensormon (``root.common.telemetry.tensormon``,
  ``telemetry/tensormon.py``): each train step's model-health statistics
  are summed on the device into the train accumulators beside the
  metrics, leave the card with the same per-epoch drain, and are
  stripped and observed there (the NaN sentinel may raise in the drain).
  With it off the step is unchanged;
- ``root.common.engine.fused_epilogue``: runs of standalone activation
  units apply right after their producer (``ops/fused_fc.
  plan_epilogues``), the same ops in the same order;
- LoRA: a unit's adapters are parameters like any other; its GD rule
  holds the frozen base (``freeze_base``), and a base snapshot resumed
  into a LoRA config keeps zero optimiser state for the adapters;
- an evaluator's array metric (the confusion matrix) accumulates on the
  device like the scalars and drains as a numpy array.

The fused-FC kernel refuses tensormon, label smoothing, the confusion
matrix, LoRA and ``freeze_base``, each with the reference's reason.

A loader's on-device augmentation (``loader/image.py``
``device_augmentation``): its ``device_augment_fn(batch, generator)``
runs right after each train step's gather, before the mixed-precision
cast (on the whole minibatch, before an accumulation split), and its
``device_eval_fn(batch)`` after each evaluation step's; under
``target_mode="input"`` the augmented batch is the target. The
generator is seeded like a random layer's, from the step's key and the
fixed index ``AUGMENT_INDEX`` (the reference folds the same number into
its key), so a step redraws its augmentation when it is recomputed or
resumed. The fused-FC kernel refuses such a loader with the reference's
reason. A loader whose ``targets_by_label`` is set (``ImageLoaderMSE``)
serves a per-label target table: the steps gather a row's target
through its label.

``param_masks`` (:meth:`TrainStep.register_param_mask`, ZeroFiller's
sparsity contract): each mask multiplies its parameter after every
optimiser update, inside a plan as between plans; a registered mask
takes the chain off the fused-FC kernel, which has no mask.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy
import torch
import torch.utils.checkpoint

from ..accelerated import AcceleratedUnit
from ..config import root
from ..error import Bug, VelesError
from ..loader.base import TEST, TRAIN, VALID
from ..ops.precision import amp_cast
from .. import prng
from ..telemetry import cost as _cost
from ..telemetry.spans import span
from .all2all import All2AllSoftmax, All2AllTanh
from .evaluator import EvaluatorSoftmax
from .nn_units import MATCHING, ForwardBase, GradientDescentBase

Tree = Dict[str, Dict[str, Any]]

#: ported target modes: gather the labels or the loader's targets,
#: reconstruct the input, or pick targets/input by what the loader has
TARGET_MODES = ("labels", "targets", "input", "auto")

#: the generator index of a loader's on-device augmentation (the number
#: the reference folds into the step's key for it)
AUGMENT_INDEX = 0x417


def _f32(x) -> float:
    return float(numpy.float32(x))


def _host_tree(tree):
    """A tensor tree as numpy arrays (what a snapshot holds)."""
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def _restored_like(saved, fresh, path: str):
    """``saved`` (numpy leaves) as tensors laid out as ``fresh`` (the
    solver's zero state on the device): each leaf in ``fresh``'s dtype
    and device. A key ``fresh`` has and ``saved`` lacks keeps its zero
    state; a key or a shape ``fresh`` has not raises."""
    if isinstance(fresh, dict):
        if not isinstance(saved, dict) or set(saved) - set(fresh):
            raise ValueError("opt_state %s: keys %s, the solver's are %s"
                             % (path, sorted(saved) if isinstance(
                                 saved, dict) else type(saved).__name__,
                                sorted(fresh)))
        return {k: (_restored_like(saved[k], v, "%s/%s" % (path, k))
                    if k in saved else v) for k, v in fresh.items()}
    arr = numpy.asarray(saved)
    if arr.shape != tuple(fresh.shape):
        raise ValueError("opt_state %s: shape %s, the parameter's is %s"
                         % (path, arr.shape, tuple(fresh.shape)))
    return torch.from_numpy(numpy.array(arr)).to(device=fresh.device,
                                                 dtype=fresh.dtype)


def _tree_where(valid, new, old):
    """``new`` where ``valid``, else ``old``, leaf by leaf over nested
    dicts (an optimiser state may nest: Adam's m, v and t)."""
    if isinstance(new, dict):
        return {k: _tree_where(valid, new[k], old[k]) for k in new}
    return torch.where(valid, new, old)


class TrainStep(AcceleratedUnit):
    """Owns the device parameter tree and runs the train/eval steps."""

    MAPPING = "train_step"
    hide_from_registry = False

    def __init__(self, workflow, forwards: List[ForwardBase] = (),
                 evaluator=None, loader=None, gds=None,
                 target_mode: str = "labels", steps_per_dispatch: int = 16,
                 epochs_per_dispatch: int = 1,
                 pipeline_microbatches: Optional[int] = None,
                 remat: bool = False, grad_accumulation: int = 1,
                 **kwargs):
        if pipeline_microbatches:
            raise VelesError("pipeline microbatches are not ported yet "
                             "(ROADMAP Queue 1 item 10: distribution)")
        if target_mode not in TARGET_MODES:
            raise VelesError("target_mode %r is not ported yet (%s)"
                             % (target_mode, ", ".join(TARGET_MODES)))
        super().__init__(workflow, **kwargs)
        self.view_group = "TRAINER"
        self.forwards = list(forwards)
        self.evaluator = evaluator
        self.loader = loader
        self.epochs_per_dispatch = max(1, int(epochs_per_dispatch))
        if loader is not None:
            # fused consumption: no host minibatch fill; K minibatches
            # (or H epochs) per run — set before loader.initialize
            loader.fused = True
            loader.plan_steps = max(1, int(steps_per_dispatch))
            if self.epochs_per_dispatch > 1:
                loader.block_epochs = self.epochs_per_dispatch
        self.target_mode = target_mode
        #: recompute the forward's activations in the backward
        #: (torch.utils.checkpoint)
        self.remat = bool(remat)
        #: chunks a minibatch runs as, one update from their gradients
        self.grad_accumulation = max(1, int(grad_accumulation))
        #: engine.mixed_precision and engine.bf16_activations, resolved
        #: at initialize
        self.mixed_precision = False
        self._bf16_acts = False
        self.gds: List[GradientDescentBase] = list(gds) if gds else []
        #: ``--test``: every class runs the evaluation step, no updates
        self._evaluation_mode = False
        self.lr_scale = 1.0        # linked from LearningRateAdjust
        self.params: Tree = {}
        self.opt_state: Tree = {}
        #: fused-FC plan (_setup_fused_fc); None = general path
        self._fused_fc: Optional[Dict[str, Any]] = None
        #: the model-health taps' settings (telemetry/tensormon.py),
        #: resolved at initialize; None = off, the step unchanged
        self._tensormon: Optional[Dict[str, Any]] = None
        #: the fused epilogue plan (engine.fused_epilogue,
        #: _setup_epilogue); None = the unfused chain
        self._epilogue = None
        #: whether the last epoch block ran the fused kernel
        self._fused_fc_active = False
        #: per-epoch device accums of the last block, drained lazily
        self._block_metrics: Optional[List[Dict[int, Dict]]] = None
        self._accum: Dict[int, Dict[str, torch.Tensor]] = {}
        #: {(class, h): (idx, mask)} device eval plans (epoch-invariant)
        self._eval_plan_dev: Dict[Any, Any] = {}
        self._gd_for: Dict[str, GradientDescentBase] = {}
        self.last_loss = None
        #: what the last dispatch under each cost key ran: [(class,
        #: steps)] per epoch, and the epochs (cost_report)
        self._dispatched: Dict[str, Dict[str, Any]] = {}
        #: {(class, minibatch size): Cost of one step} (cost_report)
        self._step_costs: Dict[Any, Any] = {}
        #: {unit name: {param key: mask tensor}}, applied after every
        #: optimiser update (register_param_mask)
        self.param_masks: Dict[str, Dict[str, torch.Tensor]] = {}
        self._param_masks_np: Dict[Tuple[str, str], numpy.ndarray] = {}
        #: the keyed stream the random units' generators seed from, and
        #: the number of the next train step
        self._rng = prng.get(self.name)
        self.rng_step = 0
        self.demand("evaluator", "loader")

    @property
    def evaluation_mode(self) -> bool:
        return self._evaluation_mode

    @evaluation_mode.setter
    def evaluation_mode(self, value) -> None:
        """Entering evaluation mode drops epoch blocks to one epoch a
        dispatch, as the reference does: evaluation needs no
        amortisation, and an H-epoch block would evaluate the same sets
        H times."""
        self._evaluation_mode = bool(value)
        loader = self.loader
        if self._evaluation_mode and loader is not None \
                and getattr(loader, "block_epochs", 1) > 1:
            loader.block_epochs = 1

    def _ensure_gds(self) -> None:
        """A matched GD unit for every parameterised forward lacking one."""
        have = {gd.forward for gd in self.gds}
        for f in self.forwards:
            if f.PARAMETERIZED and f not in have:
                gd_cls = next((MATCHING[k] for k in type(f).__mro__
                               if k in MATCHING), None)
                if gd_cls is None:
                    raise Bug("no GD unit matched for %s" % type(f).__name__)
                gd = gd_cls(self.workflow, name="gd_" + f.name,
                            **getattr(f, "gd_config", {}))
                gd.forward = f
                self.gds.append(gd)

    def initialize(self, device=None, **kwargs):
        res = super().initialize(device=device, **kwargs)
        if res:
            return res
        # the forwards create their params first (re-queue until then)
        for f in self.forwards:
            if f.PARAMETERIZED and not f.param_arrays():
                return True
        from ..telemetry import tensormon
        self._tensormon = (tensormon.settings() if tensormon.enabled()
                           else None)
        self.mixed_precision = bool(
            root.common.engine.get("mixed_precision", False))
        self._bf16_acts = bool(
            root.common.engine.get("bf16_activations", False))
        if self.target_mode == "auto":
            # resolvable only now: the loader's load_data has run
            has_t = getattr(self.loader, "original_targets", None)
            self.target_mode = ("targets" if has_t is not None and has_t
                                else "input")
        if self._bf16_acts and not self.mixed_precision:
            # as the reference: bf16 activation storage only makes sense
            # under AMP, where the params and the batch are bf16 already
            self.warning("bf16_activations needs "
                         "engine.mixed_precision — ignored")
            self._bf16_acts = False
        if self.grad_accumulation > 1:
            mb = self.loader.max_minibatch_size
            if mb % self.grad_accumulation:
                raise Bug("minibatch size %d not divisible into %d "
                          "gradient-accumulation chunks"
                          % (mb, self.grad_accumulation))
        self._ensure_gds()
        gd_by_fwd = {gd.forward: gd for gd in self.gds}
        self._gd_for = {f.name: gd_by_fwd[f]
                        for f in self.forwards if f.PARAMETERIZED}
        self.params = {
            f.name: {k: v.device_view(self.device)
                     for k, v in f.param_arrays().items()}
            for f in self.forwards if f.PARAMETERIZED}
        self._setup_fused_fc()
        self._setup_epilogue()
        self.opt_state = {name: self._gd_for[name].init_state(p)
                          for name, p in self.params.items()}
        # the step owns the device tensors from here on; the forwards'
        # Arrays keep their host mirror (sync_params_to_arrays)
        for f in self.forwards:
            for arr in f.param_arrays().values():
                arr.detach_devmem()
        return None

    def _setup_epilogue(self) -> None:
        """The fused scale-bias-activation epilogue plan
        (``root.common.engine.fused_epilogue``, ``ops/fused_fc.py``):
        runs of standalone activation units fold into their producer in
        the forward, the same ops in the same order, so on gives the
        bits of off. It composes with the tensormon taps, which read
        the head's output after the epilogue."""
        from ..ops import fused_fc as ff
        self._epilogue = None
        if not root.common.engine.get("fused_epilogue", False):
            return
        plan = ff.plan_epilogues(self.forwards)
        if not plan:
            return
        self._epilogue = plan
        self.info("fused epilogue engaged%s: %s",
                  " (composes with tensormon taps)"
                  if self._tensormon is not None else "",
                  "; ".join("%s ← %s" % (p.name,
                                         "+".join(t.name for t in ts))
                            for p, ts in plan))

    def _setup_fused_fc(self) -> None:
        """Opt-in whole-epoch kernel (``root.common.engine.fused_fc_scan``,
        ops/fused_fc.py). Strict eligibility: anything outside it keeps
        the general path, and the reason is logged."""
        from ..ops import fused_fc as ff
        self._fused_fc = None
        flag = root.common.engine.get("fused_fc_scan", False)
        if not flag:
            return

        def reject(why):
            self.info("fused_fc_scan requested but ineligible: %s", why)

        # the kernel computes in full f32; a TF32 general path would not
        # follow the same trajectory ("force" opts out of that claim)
        if flag != "force" and self.device.type == "cuda" \
                and torch.backends.cuda.matmul.allow_tf32:
            return reject("TF32 matmuls are on — the f32 kernel would not "
                          "be trajectory-exact vs the TF32 general path")
        fs = [f for f in self.forwards if f.PARAMETERIZED]
        if (len(self.forwards) != len(fs) or len(fs) < 2
                or any(type(f) is not All2AllTanh for f in fs[:-1])
                or type(fs[-1]) is not All2AllSoftmax):
            return reject("needs an [all2all_tanh ... all2all_tanh, "
                          "softmax] chain")
        if not isinstance(self.evaluator, EvaluatorSoftmax) \
                or getattr(self.evaluator, "label_smoothing", 0.0) \
                or getattr(self.evaluator, "compute_confusion", False):
            return reject("needs plain softmax-CE evaluator")
        if self.mixed_precision or self.remat \
                or self.grad_accumulation > 1:
            return reject("amp/remat/grad-accumulation not fused")
        if self._tensormon is not None:
            return reject("tensormon taps are not computed by the "
                          "fused kernel — the general scan path keeps "
                          "the fused scale-bias-activation epilogue "
                          "(engine.fused_epilogue), so the elementwise "
                          "tail stays fused there; disable "
                          "telemetry.tensormon or fused_fc_scan")
        if self.param_masks:
            return reject("sparsity masks not fused")
        knobs = set()
        for f in fs:
            if set(self.params[f.name]) != {"weights", "bias"}:
                return reject("%s params beyond weights+bias (LoRA?)"
                              % f.name)
            if getattr(f, "freeze_base", False):
                return reject("%s is frozen (freeze_base) — the "
                              "kernel updates unconditionally" % f.name)
            gd = self._gd_for[f.name]
            if gd.solver != "sgd" or gd.gradient_clip \
                    or gd.gradient_clip_norm:
                return reject("%s: fused path is Znicz SGD only "
                              "(momentum/decay ok; no clipping)" % f.name)
            knobs.add((float(gd.learning_rate),
                       float(gd.learning_rate_bias),
                       float(gd.weight_decay),
                       float(gd.weight_decay_bias),
                       float(gd.momentum)))
        if len(knobs) != 1:
            return reject("per-layer SGD knobs differ (uniform "
                          "lr/decay/momentum required)")
        if len({(float(f.A), float(f.B)) for f in fs[:-1]}) > 1:
            return reject("per-layer tanh (A, B) scales differ "
                          "(uniform activation required)")
        lr, lr_bias, wd, wd_bias, momentum = knobs.pop()
        if lr <= 0:
            return reject("non-positive learning rate")
        if getattr(self.loader, "device_augment_fn", None) is not None:
            return reject("device-side augmentation not fused")
        # shared-memory budget: one cluster holds the weights, both
        # delta recurrences and a minibatch's activations
        mb = self.loader.max_minibatch_size
        shapes = [tuple(self.params[f.name]["weights"].shape) for f in fs]
        geometry = ff.choose_geometry(shapes, mb)
        if geometry is None:
            return reject("shared-memory budget: %d bytes per CTA in the "
                          "columns layout at cluster 16 exceed the %d a "
                          "CTA has" % (ff.smem_bytes(shapes, mb, 16,
                                                     "columns"),
                                       ff.SMEM_BUDGET))
        ds = self.loader.original_data
        if ds is None or not ds or ds.mem.ndim != 2:
            return reject("flat (N, features) dataset only")
        self._fused_fc = {
            "lr": lr, "lr_bias_ratio": lr_bias / lr,
            "wd": wd, "wd_bias": wd_bias, "momentum": momentum,
            "act_a": float(fs[0].A), "act_b": float(fs[0].B),
            "names": tuple(f.name for f in fs),
        }
        self.info("fused_fc_scan engaged: whole-epoch fused-FC SGD kernel "
                  "(%s), %s layout, cluster %d",
                  " → ".join(f.name for f in fs), *geometry)
        if self.epochs_per_dispatch == 1:
            self.info("fused_fc_scan: epochs_per_dispatch is 1, and the "
                      "kernel runs only inside an epoch block — the "
                      "general path trains every epoch")

    def register_param_mask(self, unit_name: str, key: str, mask) -> None:
        """Install (or refresh) a mask that multiplies ``params[unit_name]
        [key]`` after every optimiser update, enforced on the current
        parameter at once; re-registering an equal mask is a no-op
        (checked on the host). The chain leaves the fused-FC kernel,
        which has no mask, with the reference's reason."""
        m_np = numpy.asarray(mask)
        cur = self._param_masks_np.get((unit_name, key))
        if cur is not None and numpy.array_equal(cur, m_np):
            return
        self._param_masks_np[(unit_name, key)] = m_np
        m = torch.from_numpy(numpy.array(m_np)).to(self.device)
        self.param_masks.setdefault(unit_name, {})[key] = m
        if self._fused_fc is not None:
            self._fused_fc = None
            self.info("fused_fc_scan disengaged: sparsity masks not fused")
        if self.params.get(unit_name) and key in self.params[unit_name]:
            p = dict(self.params[unit_name])
            p[key] = p[key] * m.to(p[key].dtype)
            self.params[unit_name] = p

    def _layer_generator(self, key: Tuple[int, ...], index: int
                         ) -> torch.Generator:
        """The generator of the layer at ``index`` for the draw ``key``
        (the stream's seed, the step's number, the chunk), on the step's
        device; the same key and index give the same draws."""
        digest = hashlib.sha256(struct.pack("<4q", *key, index)).digest()
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
        return gen

    def _rng_key(self, step: int, chunk: int = 0) -> Tuple[int, ...]:
        return (self._rng.initial_seed, step, chunk)

    def _augmented(self, batch: torch.Tensor, step: int) -> torch.Tensor:
        """The loader's on-device augmentation of train step ``step``'s
        gathered batch (the batch itself without one)."""
        aug = getattr(self.loader, "device_augment_fn", None)
        if aug is None:
            return batch
        return aug(batch, self._layer_generator(self._rng_key(step),
                                                AUGMENT_INDEX))

    @staticmethod
    def _target_for(batch, targets, idx):
        """The targets of the rows ``idx``: the batch itself (``targets``
        None: the input is the target), a per-label table gathered
        through the rows' labels (``targets`` a (table, labels) pair,
        :meth:`_dataset`), or the rows of ``targets``."""
        if targets is None:
            return batch
        if isinstance(targets, tuple):
            table, labels = targets
            return table[labels[idx].long()]
        return targets[idx]

    # -- pure functions -------------------------------------------------------
    def _forward(self, params: Tree, x: torch.Tensor, train: bool = False,
                 rng: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
        """The forward chain; a softmax head yields logits for the fused
        log-softmax cross-entropy. A ``NEEDS_RNG`` unit gets ``train``
        and, in training, its layer's generator for the draw ``rng``.
        ``bf16_activations``: an interlayer activation that left a unit
        float32 is stored bf16 (the head's output feeds the evaluator as
        it is). Under the epilogue plan each producer's activation tails
        apply right after it and are skipped at their own positions (the
        layer indices, hence the random units' generators, unchanged)."""
        from ..ops.fused_fc import apply_epilogue
        last = self.forwards[-1]
        use_logits = (isinstance(last, All2AllSoftmax)
                      and isinstance(self.evaluator, EvaluatorSoftmax))
        folded, prod_tails = set(), {}
        for prod, tails in self._epilogue or ():
            prod_tails[id(prod)] = tails
            folded.update(id(t) for t in tails)
        for i, f in enumerate(self.forwards):
            if id(f) in folded:
                continue        # applied by its producer's epilogue
            p = params.get(f.name, {})
            if f is last and use_logits:
                return f.logits(p, x)
            if getattr(f, "NEEDS_RNG", False):
                gen = (self._layer_generator(rng, i)
                       if train and rng is not None else None)
                x = f.apply(p, x, train=train, generator=gen)
            else:
                x = f.apply(p, x)
            tails = prod_tails.get(id(f))
            if tails:
                x = apply_epilogue(x, tails)
            head = f is last or (tails and tails[-1] is last)
            if self._bf16_acts and not head \
                    and x.dtype == torch.float32:
                x = x.to(torch.bfloat16)
        return x

    def _zero_accum(self, mon: bool = False) -> Dict[str, torch.Tensor]:
        """The evaluator's accumulators; ``mon`` (a train context with
        tensormon on) adds the monitor's."""
        out = {k: torch.zeros(self.evaluator.metric_shape(k),
                              dtype=torch.float32, device=self.device)
               for k in self.evaluator.metric_keys}
        if mon and self._tensormon is not None:
            from ..telemetry import tensormon
            out.update(tensormon.zero_stats(self.params, self.device))
        return out

    def _metrics(self, out, tgt, mask, loss, accum):
        metrics = self.evaluator.metrics_fn(out, tgt, mask)
        metrics["sum_loss"] = loss * self.evaluator.sum_loss_weight(out,
                                                                    mask)
        return {k: accum[k] + metrics[k] if k in metrics else accum[k]
                for k in accum}

    def _grads(self, params, batch, tgt, mask, rng=None):
        """Autograd forward + loss over ``batch`` (a minibatch, or one
        accumulation chunk of it) in training, the random units drawing
        for ``rng``: (loss, out, grads), the grads in the params' tree.
        Under mixed precision the forward runs on the bf16 view of the
        params (the batch is cast by the caller) and the grads reach the
        float32 masters through the cast; under remat the forward runs
        in one non-reentrant checkpoint."""
        leaves = {n: {k: v.detach().requires_grad_(True)
                      for k, v in p.items()} for n, p in params.items()}
        with torch.enable_grad():
            p = amp_cast(leaves) if self.mixed_precision else leaves
            if self.remat:
                out = torch.utils.checkpoint.checkpoint(
                    self._forward, p, batch, True, rng, use_reentrant=False,
                    preserve_rng_state=True)
            else:
                out = self._forward(p, batch, True, rng)
            loss = self.evaluator.loss(out, tgt, mask)
            flat = [t for p in leaves.values() for t in p.values()]
            grads_flat = torch.autograd.grad(loss, flat)
        it = iter(grads_flat)
        grads = {n: {k: next(it) for k in p} for n, p in leaves.items()}
        return loss.detach(), out.detach(), grads

    def _train_step(self, params, opt_state, accum, dataset, targets,
                    indices, mask, lr_scale, step=None):
        """One minibatch: autograd forward + loss, the GD updates, the
        metrics. ``targets`` is the array the rows' targets are gathered
        from (``_dataset``; None: the minibatch is its own target). With
        ``grad_accumulation`` G > 1 the minibatch runs as G chunks in
        order, and the update takes the
        sum of their float32 gradients weighted by each chunk's valid
        rows over the minibatch's valid rows — the whole minibatch's
        gradient up to the order of the sums (each chunk's loss is its
        valid rows' mean); the metrics accumulate chunk by chunk and
        the loss returned is the weighted mean of the chunks'. The random
        units draw for train step number ``step`` (default: the next,
        ``rng_step``, which then advances). Returns (params, opt_state,
        accum, loss)."""
        if step is None:
            step = self.rng_step
            self.rng_step += 1
        idx = indices.long()
        batch = self._augmented(dataset[idx], step)
        tgt = self._target_for(batch, targets, idx)
        if self.mixed_precision:
            batch = amp_cast(batch)
        ga = self.grad_accumulation
        if ga == 1:
            loss, out, grads = self._grads(params, batch, tgt, mask,
                                           self._rng_key(step))
            with torch.no_grad():
                accum = self._metrics(out, tgt, mask, loss, accum)
        else:
            out = None
            rows = mask.shape[0] // ga
            total = torch.clamp(mask.sum().float(), min=1.0)
            g_sum = l_sum = None
            for c in range(ga):
                part = slice(c * rows, (c + 1) * rows)
                loss_c, out, g = self._grads(params, batch[part], tgt[part],
                                             mask[part],
                                             self._rng_key(step, c))
                with torch.no_grad():
                    w = mask[part].sum().float()
                    g = {n: {k: v.float() * w for k, v in t.items()}
                         for n, t in g.items()}
                    g_sum = g if g_sum is None else {
                        n: {k: g_sum[n][k] + v for k, v in t.items()}
                        for n, t in g.items()}
                    l_sum = (loss_c * w if l_sum is None
                             else l_sum + loss_c * w)
                    accum = self._metrics(out, tgt[part], mask[part],
                                          loss_c, accum)
            grads = {n: {k: (v / total).to(params[n][k].dtype)
                         for k, v in t.items()} for n, t in g_sum.items()}
            loss = l_sum / total
        with torch.no_grad():
            # an all-padded plan row must not decay the params
            valid = mask.sum() > 0
            new_params, opt_state = self._apply_updates(params, grads,
                                                        opt_state, lr_scale,
                                                        valid)
            if self._tensormon is not None and "mon_steps" in accum:
                # the taps: scalars over this step's values, summed into
                # the accumulators beside the metrics (no sync); the
                # accumulation path's from the one applied update
                from ..telemetry import tensormon
                stats = tensormon.step_stats(
                    params, new_params, grads, loss, out,
                    self._tensormon["sat_threshold"])
                accum = {k: accum[k] + stats[k] if k in stats else accum[k]
                         for k in accum}
        return new_params, opt_state, accum, loss

    def _apply_updates(self, params, grads, opt_state, lr_scale, valid):
        """Each unit's GD rule, kept only where ``valid``: an all-padded
        row leaves the params and every leaf of the state (Adam's step
        count included) unchanged; then the registered masks."""
        new_params, new_opt = {}, {}
        for name, p in params.items():
            up_p, up_s = self._gd_for[name].update(p, grads[name],
                                                   opt_state[name], lr_scale)
            new_params[name] = _tree_where(valid, up_p, p)
            new_opt[name] = _tree_where(valid, up_s, opt_state[name])
        for name, masks in self.param_masks.items():
            if name in new_params:
                for k, m in masks.items():
                    new_params[name][k] = (new_params[name][k]
                                           * m.to(new_params[name][k].dtype))
        return new_params, new_opt

    def _train_plan(self, params, opt_state, accum, dataset, targets,
                    idx_plan, mask_plan, lr_scale):
        """K optimizer steps over a (K, mb) plan, in order."""
        loss = None
        for k in range(idx_plan.shape[0]):
            params, opt_state, accum, loss = self._train_step(
                params, opt_state, accum, dataset, targets, idx_plan[k],
                mask_plan[k], lr_scale)
        return params, opt_state, accum, loss

    @torch.no_grad()
    def _eval_step(self, params, accum, dataset, targets, indices, mask):
        idx = indices.long()
        batch = dataset[idx]
        ev = getattr(self.loader, "device_eval_fn", None)
        if ev is not None:
            batch = ev(batch)
        tgt = self._target_for(batch, targets, idx)
        if self.mixed_precision:
            batch, params = amp_cast(batch), amp_cast(params)
        out = self._forward(params, batch)
        return self._metrics(out, tgt, mask,
                             self.evaluator.loss(out, tgt, mask), accum)

    def _eval_plan(self, params, accum, dataset, targets, idx_plan,
                   mask_plan):
        for k in range(idx_plan.shape[0]):
            accum = self._eval_step(params, accum, dataset, targets,
                                    idx_plan[k], mask_plan[k])
        return accum

    # -- execution -----------------------------------------------------------
    def _dataset(self):
        """The device dataset and the device array the targets are
        gathered from: the labels, or under ``target_mode="targets"`` the
        loader's row-aligned targets (a dataset may have no labels), or
        its per-label table paired with the labels (``targets_by_label``);
        under ``"input"`` None, the minibatch being its own target."""
        loader = self.loader
        dataset = loader.original_data.device_view(self.device)
        if self.target_mode == "input":
            return dataset, None
        if self.target_mode == "targets":
            src = getattr(loader, "original_targets", None)
        else:
            src = loader.original_labels
        if src is None or not src:
            raise VelesError("target_mode %r: the loader has no %s"
                             % (self.target_mode, self.target_mode))
        if self.target_mode == "targets" \
                and getattr(loader, "targets_by_label", False):
            return dataset, (src.device_view(self.device),
                             loader.original_labels.device_view(
                                 self.device))
        return dataset, src.device_view(self.device)

    def _block_inputs(self, h: int):
        """Per-class (idx, mask) device plans of the served block; eval
        plans never change between blocks and are uploaded once."""
        plans = {}
        for cls, (idx, mask) in sorted(self.loader.block_plans.items()):
            cached = self._eval_plan_dev.get((cls, h))
            if cached is None:
                cached = (torch.from_numpy(idx.map_read()[:h].copy()).to(
                    self.device), torch.from_numpy(
                        mask.map_read()[:h].copy()).to(self.device))
                if cls != TRAIN:
                    self._eval_plan_dev[(cls, h)] = cached
            plans[cls] = cached
        return plans

    def _epoch_scales(self, h: int) -> List[float]:
        """Per-epoch LR scales, host-evaluated as the classic loop would
        (epoch k trains at schedule(k))."""
        lr_adjust = getattr(self.workflow, "lr_adjust", None)
        decision = getattr(self.workflow, "decision", None)
        e0 = decision.epoch_number if decision is not None else 0
        if lr_adjust is not None:
            return [_f32(lr_adjust.schedule(e0 + i)) for i in range(h)]
        return [_f32(self.lr_scale)] * h

    def _run_epoch_block(self) -> None:
        loader = self.loader
        dataset, targets = self._dataset()
        h = loader.block_length or loader.block_epochs
        plans = self._block_inputs(h)
        scales = self._epoch_scales(h)
        # the kernel takes whole minibatches only: a padded train row
        # (partial tail batch) keeps the masked general path
        self._fused_fc_active = (
            self._fused_fc is not None
            and all(float(m.map_read()[:h].min()) >= 1.0
                    for cls, (_, m) in loader.block_plans.items()
                    if cls == TRAIN))
        key = "epoch_block_fused" if self._fused_fc_active else "epoch_block"
        self._dispatched = {key: {"epochs": h, "plans": [
            (cls, int(idx.shape[1])) for cls, (idx, _m) in plans.items()]}}
        with span("train_step.epoch_block", unit=self.name, epochs=h,
                  fused_fc=bool(self._fused_fc_active)):
            self.params, self.opt_state, self._block_metrics = \
                self._epoch_block(dataset, targets, plans, scales, h)

    def _epoch_block(self, dataset, targets, plans, scales, h):
        """The epochs of one block: each epoch's evaluation plans, then
        its train plan (the fused kernel when active); returns the new
        params, optimiser state and per-epoch device metrics."""
        from ..ops.fused_fc import fused_fc_sgd_epoch
        p, o = self.params, self.opt_state
        stacked = []
        for e in range(h):
            outs = {}
            for cls in (TEST, VALID):
                if cls in plans:
                    idx, mask = plans[cls]
                    outs[cls] = self._eval_plan(p, self._zero_accum(),
                                                dataset, targets, idx[e],
                                                mask[e])
            if TRAIN in plans:
                idx, mask = plans[TRAIN]
                if self._fused_fc_active:
                    ff = self._fused_fc
                    names = ff["names"]
                    ws, bs, vws, vbs, loss_sum, err = fused_fc_sgd_epoch(
                        [p[n]["weights"] for n in names],
                        [p[n]["bias"] for n in names],
                        [o[n]["weights"] for n in names],
                        [o[n]["bias"] for n in names],
                        # a bf16 dataset (engine.dataset_dtype) widened, as
                        # the reference's fused path casts it
                        dataset.float(), targets, idx[e],
                        _f32(numpy.float32(scales[e])
                             * numpy.float32(ff["lr"])),
                        act_a=ff["act_a"], act_b=ff["act_b"],
                        lr_bias_ratio=ff["lr_bias_ratio"], wd=ff["wd"],
                        wd_bias=ff["wd_bias"], momentum=ff["momentum"])
                    p, o = dict(p), dict(o)
                    for i, n in enumerate(names):
                        p[n] = {"weights": ws[i], "bias": bs[i]}
                        o[n] = {"weights": vws[i], "bias": vbs[i]}
                    n_rows = torch.tensor(float(idx.shape[1] * idx.shape[2]),
                                          device=self.device)
                    outs[TRAIN] = {"n_samples": n_rows,
                                   "sum_loss": loss_sum, "n_err": err}
                    # the epoch's mean loss (logging only)
                    self.last_loss = loss_sum / n_rows
                else:
                    p, o, outs[TRAIN], self.last_loss = self._train_plan(
                        p, o, self._zero_accum(mon=True), dataset, targets,
                        idx[e], mask[e], scales[e])
            stacked.append(outs)
        return p, o, stacked

    def torch_run(self) -> None:
        loader = self.loader
        if loader.block_epochs > 1:
            if self.evaluation_mode:
                raise Bug("epochs_per_dispatch>1 requires training mode")
            return self._run_epoch_block()
        cls = loader.minibatch_class
        train = cls == TRAIN and not self.evaluation_mode
        accum = self._accum.get(cls)
        if accum is None:
            accum = self._zero_accum(mon=train)
        dataset, targets = self._dataset()
        indices = loader.minibatch_indices.device_view(self.device)
        mask = loader.minibatch_mask.device_view(self.device)
        if loader.plan_steps <= 1:
            indices, mask = indices[None], mask[None]
        else:
            # the rows past plan_length are all-padded (a class shorter
            # than the plan): they change nothing, so they do not run —
            # the reference's scan computes them and discards the result
            indices = indices[:loader.plan_length]
            mask = mask[:loader.plan_length]
        self._dispatched["train" if train else "eval"] = {
            "epochs": 1, "plans": [(cls, int(indices.shape[0]))]}
        if train:
            self.params, self.opt_state, self._accum[cls], self.last_loss \
                = self._train_plan(self.params, self.opt_state, accum,
                                   dataset, targets, indices, mask,
                                   _f32(self.lr_scale))
        else:
            self._accum[cls] = self._eval_plan(self.params, accum, dataset,
                                               targets, indices, mask)

    # -- cost (telemetry/cost.py) -------------------------------------------
    def _step_cost(self, cls: int):
        """The cost of ONE minibatch step of class ``cls`` (a train step
        for TRAIN, else an evaluation step) at the loader's minibatch
        size, counted once per (class, size) and cached: the step runs
        once on the unit's device, on the first rows of the dataset,
        under ``telemetry.cost.cost_of_fn`` (the products' FLOPs and
        the operators' bytes), plus the analytic costs the hand-written
        kernels note at their launches. The params and optimiser state
        are not changed."""
        mb = int(self.loader.max_minibatch_size)
        key = (cls, mb)
        if key not in self._step_costs:
            dataset, targets = self._dataset()
            idx = torch.arange(mb, device=self.device) % dataset.shape[0]
            mask = torch.ones(mb, dtype=torch.float32, device=self.device)
            if cls == TRAIN:
                fn = lambda: self._train_step(  # noqa: E731
                    self.params, self.opt_state, self._zero_accum(),
                    dataset, targets, idx, mask, _f32(self.lr_scale),
                    step=self.rng_step)
            else:
                fn = lambda: self._eval_step(  # noqa: E731
                    self.params, self._zero_accum(), dataset, targets,
                    idx, mask)
            with _cost.collecting_kernel_costs() as notes:
                cost = _cost.cost_of_fn(fn)
            for note in notes:
                cost = cost + note
            self._step_costs[key] = cost
        return self._step_costs[key]

    def cost_report(self):
        """The cost of the last dispatch under each key ("epoch_block_
        fused", "epoch_block", "train", "eval", as the reference keys
        its programs): every plan step at its class's :meth:`_step_cost`,
        and on the fused path each epoch's train plan at the fused-FC
        kernel's analytic cost (``ops.fused_fc.analytic_cost``) instead.
        Returns ``{"key", "cost", "costs"}`` (the primary key and its
        cost, and every key's) or None before the first dispatch. On
        demand only: the first call per plan shape runs one step."""
        from ..ops import fused_fc as ff
        costs = {}
        for key in ("epoch_block_fused", "epoch_block", "train", "eval"):
            info = self._dispatched.get(key)
            if info is None:
                continue
            cost = _cost.Cost(source="flop_counter")
            for cls, steps in info["plans"]:
                if cls == TRAIN and key == "epoch_block_fused":
                    names = self._fused_fc["names"]
                    shapes = [tuple(self.params[n]["weights"].shape)
                              for n in names]
                    epoch = _cost.Cost(*ff.analytic_cost(
                        shapes, self.loader.max_minibatch_size, steps))
                else:
                    epoch = self._step_cost(cls).scaled(steps)
                cost = cost + epoch.scaled(info["epochs"])
            costs[key] = cost
        if not costs:
            return None
        primary = next(iter(costs))
        return {"key": primary, "cost": costs[primary], "costs": costs}

    # -- epoch drain (the Decision pulls these) ------------------------------
    @staticmethod
    def _to_host(entries) -> List[Dict[int, Dict[str, float]]]:
        """One device → host copy for every accumulator of ``entries``:
        scalars as floats, an array metric (the confusion matrix) as a
        numpy array."""
        keys = [(e, cls, k) for e, per in enumerate(entries)
                for cls, acc in sorted(per.items()) for k in sorted(acc)]
        if not keys:
            return [{} for _ in entries]
        leaves = [entries[e][cls][k] for e, cls, k in keys]
        host = torch.cat([t.float().reshape(-1) for t in leaves]).cpu()
        out = [{} for _ in entries]
        at = 0
        for (e, cls, k), t in zip(keys, leaves):
            n = t.numel()
            v = (float(host[at]) if t.dim() == 0
                 else host[at:at + n].numpy().reshape(t.shape).copy())
            at += n
            out[e].setdefault(cls, {})[k] = v
        return out

    def drain_epoch_blocks(self) -> List[Dict[int, Dict[str, float]]]:
        """Per-epoch metric dicts since the last drain: H entries after a
        block, one in the classic mode. With tensormon on, the monitor's
        accumulators ride this same copy, are stripped before the
        Decision sees the dicts, and the NaN sentinel may raise
        ``ModelHealthError`` here."""
        if self._block_metrics is not None:
            entries, self._block_metrics = self._block_metrics, None
            entries = self._to_host(entries)
        else:
            entries = [self.drain_epoch_metrics()]
        if self._tensormon is not None:
            from ..telemetry import tensormon
            for mon in tensormon.extract_mon(entries, TRAIN):
                tensormon.monitor.observe(self, mon)
        return entries

    def drain_epoch_metrics(self) -> Dict[int, Dict[str, float]]:
        out = self._to_host([self._accum])[0]
        self._accum.clear()
        return out

    def sync_params_to_arrays(self) -> None:
        """Copy the device params into the forwards' host Arrays."""
        for f in self.forwards:
            if not f.PARAMETERIZED:
                continue
            arrays = f.param_arrays()
            for k, v in self.params.get(f.name, {}).items():
                arrays[k].reset(v.detach().cpu().numpy().copy())

    def stop(self) -> None:
        if self.params:
            self.sync_params_to_arrays()

    # -- snapshots (the reference's schema) ---------------------------------
    def on_snapshot(self) -> None:
        """Before a snapshot: the device params to the forwards' host
        Arrays, which carry them into the file."""
        if self.params:
            self.sync_params_to_arrays()

    def state_dict(self):
        """The reference's keys and, where a forward draws random
        numbers, ``rng_step`` (the port's: the number of the next train
        step, whose draws a resumed run continues from; the reference
        reads no such key)."""
        sd = {"opt_state": _host_tree(self.opt_state),
              "lr_scale": float(self.lr_scale)}
        if any(getattr(f, "NEEDS_RNG", False) for f in self.forwards):
            sd["rng_step"] = int(self.rng_step)
        return sd

    def load_state_dict(self, sd) -> None:
        """After the forwards restored their Arrays (``apply_state`` runs
        in unit order): rebuild the device params from them, and the
        optimiser state from ``sd`` on this step's device, so that the
        next step — general or fused — starts from the restored tensors,
        not from those it held before."""
        self.params = {
            f.name: {k: v.device_view(self.device)
                     for k, v in f.param_arrays().items()}
            for f in self.forwards if f.PARAMETERIZED}
        saved = sd["opt_state"]
        self.opt_state = {}
        for name, p in self.params.items():
            # a state restored into more parameters than it covers (a
            # base snapshot resumed into a lora_rank config) grows: the
            # adapters' keys keep their fresh zero state
            fresh = self._gd_for[name].init_state(p)
            self.opt_state[name] = (fresh if name not in saved else
                                    _restored_like(saved[name], fresh, name))
        for f in self.forwards:
            for arr in f.param_arrays().values():
                arr.detach_devmem()
        if "lr_scale" in sd:
            # the first resumed step trains at the snapshot's rate; a
            # linked LearningRateAdjust takes the write
            self.lr_scale = float(sd["lr_scale"])
        self.rng_step = int(sd.get("rng_step", 0))
        self._accum.clear()
        self._block_metrics = None

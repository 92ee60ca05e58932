"""NN unit bases: ForwardBase, GradientDescentBase and the matching
registry (counterpart of ``veles_tpu/nn/nn_units.py``).

A forward unit is a parameterised pure function, ``apply(params, x)``
in torch ops; its parameters are created from the unit's keyed stream
(``prng.get(self.name)``), so the port starts from the reference's
initial weights bit for bit. The paired GD unit carries the optimiser's
hyper-parameters and its pure ``update`` rule; the gradients come from
autograd over the composed step (``nn/train_step.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy
import torch

from ..accelerated import AcceleratedUnit
from ..config import root
from ..error import Bug, VelesError
from ..memory import Array
from .. import prng

#: forward class → gd class
MATCHING: Dict[type, type] = {}

#: every solver name the reference accepts
SOLVERS = ("sgd", "adam", "adamw", "adagrad", "rmsprop", "adadelta")


def _f32(a, b) -> float:
    """The f32 product of two scalars."""
    return float(numpy.float32(a) * numpy.float32(b))


def matches(forward_cls: type) -> Callable[[type], type]:
    """Class decorator registering a GD unit as the backward pair of a
    forward unit."""
    def deco(gd_cls: type) -> type:
        MATCHING[forward_cls] = gd_cls
        return gd_cls
    return deco


class ForwardBase(AcceleratedUnit):
    """Base of all forward (inference) units. ``input``/``output`` are
    Arrays; parameters live in ``self.weights``/``self.bias`` Arrays."""

    hide_from_registry = True
    #: subclasses with trainable parameters set this
    PARAMETERIZED = False
    #: parameter attribute names
    PARAM_NAMES = ("weights", "bias")
    #: whether the unit follows the reference's bf16 promotions under
    #: ``engine.mixed_precision`` (TrainStep refuses the ones that do not)
    MIXED_PRECISION = True
    #: units that draw random numbers in training (dropout, stochastic
    #: pooling): TrainStep calls their ``apply(params, x, train=...,
    #: generator=...)`` with the layer's own ``torch.Generator``
    NEEDS_RNG = False

    #: layer-config keys routed to the paired GD unit
    GD_KEYS = ("learning_rate", "learning_rate_bias", "weights_decay",
               "weight_decay", "weights_decay_bias", "gradient_moment",
               "momentum", "gradient_clip", "gradient_clip_norm",
               "solver", "beta1", "beta2", "epsilon", "rho")

    #: weight keys LoRA adapts (units whose apply calls merged_params)
    LORA_TARGETS = ("weights",)

    def __init__(self, workflow, **kwargs) -> None:
        self.gd_config = {k: kwargs.pop(k) for k in list(kwargs)
                          if k in self.GD_KEYS}
        #: LoRA fine-tuning: rank r adds W_eff = W + A·B·(alpha/r) to
        #: every LORA_TARGET weight; the base freezes by default
        #: (freeze_base=False trains both)
        self.lora_rank = int(kwargs.pop("lora_rank", 0) or 0)
        self.lora_alpha = float(kwargs.pop("lora_alpha",
                                           self.lora_rank or 1))
        self.freeze_base = bool(kwargs.pop("freeze_base",
                                           self.lora_rank > 0))
        self._lora_names: Tuple[str, ...] = ()
        super().__init__(workflow, **kwargs)
        self.view_group = "WORKER"
        self.input: Optional[Array] = None
        self.output = Array(name=self.name + ".output")
        self.demand("input")

    def create_params(self, rng: prng.RandomGenerator) -> Dict[str, Array]:
        """Allocate and initialise parameter Arrays; default: none."""
        return {}

    def param_arrays(self) -> Dict[str, Array]:
        out = {}
        for k in self.PARAM_NAMES + getattr(self, "_lora_names", ()):
            arr = getattr(self, k, None)
            if isinstance(arr, Array) and arr:
                out[k] = arr
        return out

    def _create_lora_params(self) -> None:
        """Per LORA_TARGET, A (fan_in, r) ~ N(0, 1/sqrt(fan_in)) from the
        keyed stream ``<unit>.<key>_lora_a`` and B (r, fan_out) = 0, as
        the reference draws them: the adapted model equals the base at
        step 0. A unit with no target weight refuses the knob (it would
        freeze the layer and train nothing)."""
        if not self.lora_rank or self._lora_names:
            return
        names = []
        for k in self.LORA_TARGETS:
            arr = getattr(self, k, None)
            if not (isinstance(arr, Array) and arr) or arr.mem.ndim < 2:
                continue
            w = arr.mem
            fin = int(numpy.prod(w.shape[:-1]))
            fout = int(w.shape[-1])
            a = numpy.zeros((fin, self.lora_rank), w.dtype)
            prng.get("%s.%s_lora_a" % (self.name, k)).fill_normal(
                a, 1.0 / numpy.sqrt(fin))
            b = numpy.zeros((self.lora_rank, fout), w.dtype)
            setattr(self, k + "_lora_a",
                    Array(a, name="%s.%s_lora_a" % (self.name, k)))
            setattr(self, k + "_lora_b",
                    Array(b, name="%s.%s_lora_b" % (self.name, k)))
            names += [k + "_lora_a", k + "_lora_b"]
        if not names:
            raise VelesError(
                "lora_rank=%d on %s (%s): no LORA_TARGET weights to "
                "adapt — LoRA supports the All2All/Conv/Deconv "
                "families; drop the knob from this layer"
                % (self.lora_rank, self.name, type(self).__name__))
        self._lora_names = tuple(names)

    def merged_params(self, params):
        """W_eff = W + A·B·(alpha/r) for every adapted weight (identity
        without LoRA); the applies of the All2All and conv families call
        it first, inside autograd."""
        if not self.lora_rank:
            return params
        out = dict(params)
        scale = self.lora_alpha / self.lora_rank
        for k in self.LORA_TARGETS:
            if k + "_lora_a" not in params or k not in params:
                continue
            w = params[k]
            delta = (params[k + "_lora_a"] @ params[k + "_lora_b"]) * scale
            out[k] = w + delta.reshape(w.shape).to(w.dtype)
        return out

    def export_param_arrays(self) -> Dict[str, Array]:
        """param_arrays with the LoRA deltas merged into the base
        weights (in numpy, as the reference merges them): an export or
        a server sees a plain dense model."""
        arrays = self.param_arrays()
        if not self.lora_rank or not self._lora_names:
            return arrays
        scale = self.lora_alpha / self.lora_rank
        out = {}
        for k, v in arrays.items():
            if k.endswith(("_lora_a", "_lora_b")):
                continue
            if k + "_lora_a" in arrays:
                w = numpy.array(v.map_read())
                a = numpy.asarray(arrays[k + "_lora_a"].map_read())
                b = numpy.asarray(arrays[k + "_lora_b"].map_read())
                w = w + ((a @ b) * scale).reshape(w.shape).astype(w.dtype)
                out[k] = Array(w, name="%s.%s(merged)" % (self.name, k))
            else:
                out[k] = v
        return out

    def apply(self, params: Dict[str, torch.Tensor], x: torch.Tensor
              ) -> torch.Tensor:
        """Pure torch forward."""
        raise NotImplementedError

    def output_shape_for(self, input_shape: Tuple[int, ...]
                         ) -> Tuple[int, ...]:
        raise NotImplementedError

    def initialize(self, device=None, **kwargs):
        res = super().initialize(device=device, **kwargs)
        if res:
            return res
        if self.PARAMETERIZED and not self.param_arrays():
            rng = prng.get(self.name)
            for k, v in self.create_params(rng).items():
                setattr(self, k, v)
        if self.PARAMETERIZED:
            self._create_lora_params()
        if self.input is not None and self.input:
            shape = self.output_shape_for(self.input.shape)
            if self.output.mem is None or self.output.shape != shape:
                self.output.reset(numpy.zeros(
                    shape, dtype=root.common.engine.precision_type))
        return None

    # -- snapshots (the reference's schema: {param: ndarray}) --------------
    def state_dict(self) -> Dict[str, numpy.ndarray]:
        return {k: numpy.array(v.map_read())
                for k, v in self.param_arrays().items()}

    def load_state_dict(self, sd: Dict[str, numpy.ndarray]) -> None:
        """Rebind the host Arrays; a parameter whose shape differs from
        this unit's raises before any is written."""
        have = self.param_arrays()
        for k, v in sd.items():
            if k in have and tuple(numpy.shape(v)) != have[k].shape:
                raise ValueError("%s.%s: shape %s, the unit's is %s" % (
                    self.name, k, tuple(numpy.shape(v)), have[k].shape))
        for k, v in sd.items():
            arr = getattr(self, k, None)
            if isinstance(arr, Array):
                arr.reset(numpy.array(v))
            else:
                setattr(self, k, Array(numpy.array(v),
                                       name="%s.%s" % (self.name, k)))

    def torch_run(self) -> None:
        """Standalone forward of ``input`` (inference graphs). Under an
        installed epilogue plan (``ops/fused_fc.install_epilogues``) a
        producer computes its tails too and writes each stage's output,
        and a folded tail does nothing."""
        if getattr(self, "_epilogue_folded", False):
            return
        params = {k: v.device_view(self.device)
                  for k, v in self.param_arrays().items()}
        with torch.no_grad():
            y = self.apply(params, self.input.device_view(self.device))
            self.output.assign_devmem(y)
            for t in getattr(self, "_epilogue_tails", None) or ():
                y = t.apply({}, y)
                t.output.assign_devmem(y)


class GradientDescentBase(AcceleratedUnit):
    """Base of gradient-descent units: the reference's six solvers, each
    op for op in f32 with the bias on its own learning rate and decay —
    Znicz SGD ``delta = lr·(g + wd·p) + mu·delta_prev; p -= delta``; Adam
    (``"adam"``: coupled decay, ``g + wd·p`` through the moments;
    ``"adamw"``: decoupled, ``p -= lr·wd·p`` beside the step); AdaGrad,
    RMSProp and AdaDelta (Zeiler 2012, ``learning_rate`` scaling the
    step) on ``g + wd·p`` with their accumulators ``{"a"}`` or ``{"a",
    "d"}``. ``gradient_clip_norm`` scales the layer's gradients by
    min(1, clip / their joint float32 L2 norm) first; ``gradient_clip``
    then clips each element to ±clip. The standalone backward is not
    ported."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.view_group = "TRAINER"
        self.forward: Optional[ForwardBase] = None
        self.learning_rate = kwargs.get("learning_rate", 0.01)
        self.learning_rate_bias = kwargs.get("learning_rate_bias",
                                             self.learning_rate)
        self.momentum = kwargs.get("gradient_moment",
                                   kwargs.get("momentum", 0.0))
        self.weight_decay = kwargs.get("weights_decay",
                                       kwargs.get("weight_decay", 0.0))
        self.weight_decay_bias = kwargs.get("weights_decay_bias", 0.0)
        self.gradient_clip = kwargs.get("gradient_clip", 0.0)
        self.gradient_clip_norm = kwargs.get("gradient_clip_norm", 0.0)
        self.solver = kwargs.get("solver", "sgd")
        self.beta1 = kwargs.get("beta1", 0.9)
        self.beta2 = kwargs.get("beta2", 0.999)
        self.epsilon = kwargs.get("epsilon", 1e-8)
        #: rmsprop/adadelta accumulator decay
        self.rho = kwargs.get("rho", 0.95)
        if self.solver not in SOLVERS:
            raise Bug("unknown solver %r (%s)"
                      % (self.solver, " | ".join(SOLVERS)))

    def init_state(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """Zeros like the parameters, under the reference's keys: the
        SGD delta recurrence (the params' own tree), Adam's moments
        ``{"m", "v"}`` and int32 step count ``"t"``, AdaGrad's and
        RMSProp's ``{"a"}``, AdaDelta's ``{"a", "d"}``."""
        def zeros():
            return {k: torch.zeros_like(p) for k, p in params.items()}
        if self.solver in ("adam", "adamw"):
            device = next(iter(params.values())).device
            return {"m": zeros(), "v": zeros(),
                    "t": torch.zeros((), dtype=torch.int32, device=device)}
        if self.solver in ("adagrad", "rmsprop"):
            return {"a": zeros()}
        if self.solver == "adadelta":
            return {"a": zeros(), "d": zeros()}
        return zeros()

    def _frozen(self, k: str) -> bool:
        """freeze_base (LoRA fine-tuning): every key but the adapter
        pairs is held: no step and no decay."""
        fwd = getattr(self, "forward", None)
        return (fwd is not None and getattr(fwd, "freeze_base", False)
                and not k.endswith(("_lora_a", "_lora_b")))

    def knobs(self, k: str, lr_scale: Any) -> Tuple[float, float]:
        """(lr, wd) of parameter ``k``: the bias on its own learning rate
        and decay, (0, 0) for a frozen key. The learning rate is rounded
        to f32 with the schedule's factor, as the reference's traced
        product is."""
        if self._frozen(k):
            return 0.0, 0.0
        base = (self.learning_rate_bias if k == "bias"
                else self.learning_rate)
        wd = float(self.weight_decay_bias if k == "bias"
                   else self.weight_decay)
        return _f32(base, lr_scale), wd

    def clipped(self, grads: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """The gradients after the clipping knobs, in the reference's
        order: the joint-norm scale over the layer (its squares summed
        in float32, leaf by leaf in sorted key order), then the
        elementwise clip."""
        if self.gradient_clip_norm:
            sq = sum(torch.sum(torch.square(grads[k].float()))
                     for k in sorted(grads))
            factor = torch.clamp(self.gradient_clip_norm / torch.clamp(
                torch.sqrt(sq), min=1e-12), max=1.0)
            grads = {k: (g * factor).to(g.dtype) for k, g in grads.items()}
        if self.gradient_clip:
            c = float(self.gradient_clip)
            grads = {k: torch.clamp(g, -c, c) for k, g in grads.items()}
        return grads

    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], state: Any,
               lr_scale: Any = 1.0) -> Tuple[Dict[str, torch.Tensor], Any]:
        """One step of the unit's solver; ``lr_scale`` is the schedule's
        factor (an f32 scalar). Returns (new params, new state). A frozen
        key's gradient is zeroed after the clipping, as the reference's
        ``knobs`` does."""
        grads = self.clipped(grads)
        grads = {k: (g * 0 if self._frozen(k) else g)
                 for k, g in grads.items()}
        if self.solver in ("adam", "adamw"):
            return self._adam(params, grads, state, lr_scale)
        if self.solver in ("adagrad", "rmsprop", "adadelta"):
            return self._accumulating(params, grads, state, lr_scale)
        new_params, new_state = {}, {}
        for k, p in params.items():
            lr, wd = self.knobs(k, lr_scale)
            delta = lr * (grads[k] + wd * p) + float(self.momentum) * state[k]
            new_params[k] = p - delta
            new_state[k] = delta
        return new_params, new_state

    def _adam(self, params, grads, state, lr_scale):
        """The reference's Adam, op for op in f32: the bias corrections
        ``1 - beta ** t`` are f32 powers of the f32 step count on the
        device, as the reference computes them, not float64 on the
        host."""
        decoupled = self.solver == "adamw"
        t = state["t"] + 1
        tf = t.to(torch.float32)
        c1 = 1 - self.beta1 ** tf
        c2 = 1 - self.beta2 ** tf
        new_m, new_v, new_params = {}, {}, {}
        for k, p in params.items():
            lr, wd = self.knobs(k, lr_scale)
            g = grads[k]
            if not decoupled:
                g = g + wd * p
            m = self.beta1 * state["m"][k] + (1 - self.beta1) * g
            v = self.beta2 * state["v"][k] + (1 - self.beta2) * g * g
            step = lr * (m / c1) / (torch.sqrt(v / c2) + self.epsilon)
            if decoupled:
                # the reference's f32 product lr·wd
                step = step + _f32(lr, wd) * p
            new_params[k] = p - step
            new_m[k], new_v[k] = m, v
        return new_params, {"m": new_m, "v": new_v, "t": t}

    def _accumulating(self, params, grads, state, lr_scale):
        """AdaGrad, RMSProp and AdaDelta as the reference computes them,
        each on ``g + wd·p``."""
        rho, eps = self.rho, self.epsilon
        new_a, new_d, new_params = {}, {}, {}
        for k, p in params.items():
            lr, wd = self.knobs(k, lr_scale)
            g = grads[k] + wd * p
            if self.solver == "adagrad":
                a = state["a"][k] + g * g
            else:
                a = rho * state["a"][k] + (1 - rho) * g * g
            if self.solver == "adadelta":
                d = state["d"][k]
                delta = (torch.sqrt(d + eps) / torch.sqrt(a + eps)) * g
                new_params[k] = p - lr * delta
                new_d[k] = rho * d + (1 - rho) * delta * delta
            else:
                new_params[k] = p - lr * g / (torch.sqrt(a) + eps)
            new_a[k] = a
        if self.solver == "adadelta":
            return new_params, {"a": new_a, "d": new_d}
        return new_params, {"a": new_a}

    def initialize(self, device=None, **kwargs):
        if self.forward is None:
            raise Bug("%s: no forward unit attached" % self.name)
        return super().initialize(device=device, **kwargs)

    def torch_run(self) -> None:
        """The step unit applies this rule; the standalone per-layer
        backward is not ported."""

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

#: every solver name the reference accepts, and those ported
SOLVERS = ("sgd", "adam", "adamw", "adagrad", "rmsprop", "adadelta")
PORTED_SOLVERS = ("sgd", "adam", "adamw")


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

    #: layer-config keys routed to the paired GD unit
    GD_KEYS = ("learning_rate", "learning_rate_bias", "weights_decay",
               "weight_decay", "weights_decay_bias", "gradient_moment",
               "momentum", "gradient_clip", "gradient_clip_norm",
               "solver", "beta1", "beta2", "epsilon", "rho")

    def __init__(self, workflow, **kwargs) -> None:
        self.gd_config = {k: kwargs.pop(k) for k in list(kwargs)
                          if k in self.GD_KEYS}
        for key in ("lora_rank", "lora_alpha", "freeze_base"):
            if kwargs.pop(key, None):
                raise VelesError("%s (LoRA fine-tuning) is not ported yet"
                                 % key)
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
        for k in self.PARAM_NAMES:
            arr = getattr(self, k, None)
            if isinstance(arr, Array) and arr:
                out[k] = arr
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
        """Standalone forward of ``input`` (inference graphs)."""
        params = {k: v.device_view(self.device)
                  for k, v in self.param_arrays().items()}
        with torch.no_grad():
            y = self.apply(params, self.input.device_view(self.device))
        self.output.assign_devmem(y)


class GradientDescentBase(AcceleratedUnit):
    """Base of gradient-descent units: the Znicz SGD rule
    ``delta = lr·(g + wd·p) + mu·delta_prev; p -= delta``, and Adam
    (``solver="adam"``: coupled decay, ``g + wd·p`` through the moments;
    ``"adamw"``: decoupled, ``p -= lr·wd·p`` beside the step), with the
    bias on its own learning rate and decay. The other solvers, gradient
    clipping and the standalone backward are not ported yet."""

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
        if self.solver not in SOLVERS:
            raise Bug("unknown solver %r (%s)"
                      % (self.solver, " | ".join(SOLVERS)))

    def _check_ported(self) -> None:
        if self.solver not in PORTED_SOLVERS:
            raise VelesError("solver %r is not ported yet (%s only)"
                             % (self.solver, ", ".join(PORTED_SOLVERS)))
        if self.gradient_clip or self.gradient_clip_norm:
            raise VelesError("gradient clipping is not ported yet")

    def init_state(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """Zeros like the parameters: the SGD delta recurrence, or the
        Adam moments ``{"m", "v"}`` and the int32 step count ``"t"``."""
        self._check_ported()
        if self.solver in ("adam", "adamw"):
            device = next(iter(params.values())).device
            return {"m": {k: torch.zeros_like(p) for k, p in params.items()},
                    "v": {k: torch.zeros_like(p) for k, p in params.items()},
                    "t": torch.zeros((), dtype=torch.int32, device=device)}
        return {k: torch.zeros_like(p) for k, p in params.items()}

    def knobs(self, k: str, lr_scale: Any) -> Tuple[float, float]:
        """(lr, wd) of parameter ``k``: the bias on its own learning rate
        and decay. The learning rate is rounded to f32 with the
        schedule's factor, as the reference's traced product is."""
        base = (self.learning_rate_bias if k == "bias"
                else self.learning_rate)
        wd = float(self.weight_decay_bias if k == "bias"
                   else self.weight_decay)
        return _f32(base, lr_scale), wd

    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], state: Any,
               lr_scale: Any = 1.0) -> Tuple[Dict[str, torch.Tensor], Any]:
        """One step of the unit's solver; ``lr_scale`` is the schedule's
        factor (an f32 scalar). Returns (new params, new state)."""
        self._check_ported()
        if self.solver in ("adam", "adamw"):
            return self._adam(params, grads, state, lr_scale)
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

    def initialize(self, device=None, **kwargs):
        if self.forward is None:
            raise Bug("%s: no forward unit attached" % self.name)
        return super().initialize(device=device, **kwargs)

    def torch_run(self) -> None:
        """The step unit applies this rule; the standalone per-layer
        backward is not ported."""

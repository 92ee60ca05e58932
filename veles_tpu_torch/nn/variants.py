"""All2All variants: RProp training and a resizable output width
(counterpart of ``veles_tpu/nn/variants.py``, Znicz's ``rprop_all`` and
``resizable_all``).

- ``All2AllRProp`` ("rprop_all2all") / ``GDRProp`` ("gd_rprop"): a
  fully-connected layer trained by resilient backpropagation — per
  weight an adaptive step driven by the sign agreement of successive
  gradients, not their size (Riedmiller & Braun '93): the step grows
  ×1.2 on the same sign and shrinks ×0.5 on a flip, clipped to [1e-6,
  50]; on a flip the weight does not move and the gradient is
  forgotten. Its state is ``{"step", "prev_grad"}``, each a tree of the
  parameters' layout, as the reference's.
- ``ResizableAll2All`` ("resizable_all2all"): an All2All whose output
  width can change after initialisation; the kept columns keep their
  values, new ones are drawn afresh.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy
import torch

from .. import prng
from .all2all import All2All
from .nn_units import GradientDescentBase, matches


class All2AllRProp(All2All):
    """The All2All forward, paired with :class:`GDRProp` (Znicz
    ``rprop_all``)."""

    MAPPING = "rprop_all2all"
    hide_from_registry = False


@matches(All2AllRProp)
class GDRProp(GradientDescentBase):
    """The resilient backpropagation update rule."""

    MAPPING = "gd_rprop"
    hide_from_registry = False

    ETA_PLUS = 1.2
    ETA_MINUS = 0.5
    STEP_MIN = 1e-6
    STEP_MAX = 50.0

    def __init__(self, workflow, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.initial_step = kwargs.get("initial_step", 0.01)

    def init_state(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        return {"step": {k: torch.full_like(p, self.initial_step)
                         for k, p in params.items()},
                "prev_grad": {k: p * 0 for k, p in params.items()}}

    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], state: Dict[str, Any],
               lr_scale: Any = 1.0) -> Tuple[Dict[str, torch.Tensor],
                                             Dict[str, Any]]:
        """One RProp step, op for op as the reference's: weight decay
        joins the gradient, the schedule's ``lr_scale`` scales the
        move."""
        new_params, new_step, new_prev = {}, {}, {}
        for k, p in params.items():
            g = grads[k]
            if self.weight_decay:
                g = g + self.weight_decay * p
            sign = g * state["prev_grad"][k]
            step = state["step"][k]
            step = torch.where(sign > 0, step * self.ETA_PLUS,
                               torch.where(sign < 0, step * self.ETA_MINUS,
                                           step))
            step = torch.clamp(step, self.STEP_MIN, self.STEP_MAX)
            # on a sign flip: no move this round, the gradient forgotten
            move = torch.where(sign < 0, torch.zeros_like(step),
                               torch.sign(g) * step)
            new_params[k] = p - move * lr_scale
            new_step[k] = step
            new_prev[k] = torch.where(sign < 0, torch.zeros_like(g), g)
        return new_params, {"step": new_step, "prev_grad": new_prev}


class ResizableAll2All(All2All):
    """All2All whose output width can change after initialisation
    (Znicz ``resizable_all``)."""

    MAPPING = "resizable_all2all"
    hide_from_registry = False

    def resize(self, new_neurons: int) -> None:
        """Grow or shrink the output width in place: the kept columns
        keep their values bit for bit, new ones come from a fresh
        :meth:`create_params` — as in the reference, which opens the
        stream ``<unit>.resize`` and draws from the unit's own stream
        ``prng.get(<unit>)`` as every All2All init does, so the port's
        fresh columns are the reference's."""
        old = self.neurons_number
        if new_neurons == old:
            return
        self.output_sample_shape = (int(new_neurons),)
        if not self.param_arrays():
            return                      # not initialised yet
        w_old = numpy.asarray(self.weights.map_read())
        b_old = (numpy.asarray(self.bias.map_read())
                 if getattr(self, "bias", None) else None)
        fresh = self.create_params(prng.get(self.name + ".resize"))
        w_new = numpy.array(fresh["weights"].map_read())
        keep = min(old, new_neurons)
        w_new[:, :keep] = w_old[:, :keep]
        self.weights.reset(w_new)
        if b_old is not None and "bias" in fresh:
            b_new = numpy.array(fresh["bias"].map_read())
            b_new[:keep] = b_old[:keep]
            self.bias.reset(b_new)
        if self.input is not None and self.input:
            self.output.reset(numpy.zeros(
                self.output_shape_for(self.input.shape),
                dtype=numpy.float32))
        self.info("%s: resized %d → %d neurons", self.name, old,
                  new_neurons)

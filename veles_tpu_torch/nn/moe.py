"""Mixture-of-Experts feed-forward layer (counterpart of
``veles_tpu/nn/moe.py``).

Two gating modes on one layer (layer type "moe_ffn", paired with
:class:`GDMoEFFN`):

- **dense** (``top_k=0``): every expert computes, the router's softmax
  weights combine them;
- **sparse** (``top_k=k``): capacity-slotted dispatch — top-k routing
  with renormalised gates, each token's position inside its expert by a
  cumulative sum over the token axis, tokens beyond
  ``ceil(k·N/E · capacity_factor)`` dropped (their combine weight is
  zero, so their rows come out exactly zero).

Both are einsums over the expert-leading parameters (``router`` (D, E),
``w1`` (E, D, F), ``b1`` (E, F), ``w2`` (E, F, D), ``b2`` (E, D)), as
the reference writes them, and so are torch ops here: full float32
products (``ops/precision.py``), operands promoted as ``jnp.einsum``
promotes them under mixed precision. The top-k threshold is the
reference's ``sort(gates)[:, -k]`` with ``>=``; the numpy oracle's
strict tie loop is not part of the jnp path and is not ported. The
reference shards these parameters over an ``expert`` mesh axis; here
the layer runs on one device (the mesh is ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy
import torch

from ..error import Bug
from ..memory import Array
from .. import prng
from ..ops.precision import promote_operands
from .nn_units import ForwardBase, GradientDescentBase, matches


def _ein(expr: str, a, b):
    """``einsum`` of two operands promoted to their common dtype."""
    a, b, _ = promote_operands(a, b)
    return torch.einsum(expr, a, b)


def _softmax_gates(params, x):
    """The router's softmax over experts, as the reference writes it:
    (N, D) → (N, E)."""
    logits = _ein("nd,de->ne", x, params["router"])
    z = logits - logits.amax(dim=-1, keepdim=True)
    gates = torch.exp(z)
    return gates / gates.sum(dim=-1, keepdim=True)


class MoEFFN(ForwardBase):
    """y = Σ_e gate_e(x) · FFN_e(x), FFN_e(x) = tanh(x·w1_e + b1_e)·w2_e
    + b2_e; input (B, D) or (B, T, D), tokens flattened."""

    MAPPING = "moe_ffn"
    PARAMETERIZED = True
    hide_from_registry = False
    PARAM_NAMES = ("router", "w1", "b1", "w2", "b2")

    def __init__(self, workflow, n_experts: int = 4, hidden: int = 0,
                 top_k: int = 0, capacity_factor: float = 1.25,
                 **kwargs) -> None:
        self.weights_stddev = kwargs.pop("weights_stddev", None)
        super().__init__(workflow, **kwargs)
        self.n_experts = int(n_experts)
        self.hidden = int(hidden)
        self.top_k = int(top_k)
        if not 0 <= self.top_k <= self.n_experts:
            raise Bug("top_k=%d out of range for %d experts (0 = dense)"
                      % (self.top_k, self.n_experts))
        self.capacity_factor = float(capacity_factor)

    def output_shape_for(self, input_shape):
        return tuple(input_shape)

    def create_params(self, rng) -> Dict[str, Array]:
        d = self.input.shape[-1]
        f = self.hidden or 4 * d
        e = self.n_experts
        stddev = self.weights_stddev or (1.0 / numpy.sqrt(d))

        def mk(name, shape, scale):
            w = numpy.zeros(shape, dtype="float32")
            prng.get("%s.%s" % (self.name, name)).fill_normal(w, scale)
            return Array(w, name="%s.%s" % (self.name, name))

        return {
            "router": mk("router", (d, e), stddev),
            "w1": mk("w1", (e, d, f), stddev),
            "b1": Array(numpy.zeros((e, f), "float32"),
                        name=self.name + ".b1"),
            "w2": mk("w2", (e, f, d), 1.0 / numpy.sqrt(f)),
            "b2": Array(numpy.zeros((e, d), "float32"),
                        name=self.name + ".b2"),
        }

    @staticmethod
    def _mix(params, x):
        """Dense mode; x: (N, D) → (N, D)."""
        gates = _softmax_gates(params, x)
        h = torch.tanh(_ein("nd,edf->nef", x, params["w1"])
                       + params["b1"][None])
        y = _ein("nef,efd->ned", h, params["w2"]) + params["b2"][None]
        return _ein("ne,ned->nd", gates, y)

    def capacity(self, n_tokens: int) -> int:
        """Slots per expert for ``n_tokens`` tokens."""
        per = self.top_k * n_tokens / self.n_experts
        return max(1, int(numpy.ceil(per * self.capacity_factor)))

    def route(self, params, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """(gates (N, E), routing mask (N, E)) of the sparse mode: a
        token goes to every expert whose gate reaches its k-th largest
        (``>=``, as the reference's threshold)."""
        gates = _softmax_gates(params, x)
        thresh = torch.sort(gates, dim=-1).values[:, -self.top_k][:, None]
        return gates, (gates >= thresh).to(gates.dtype)

    def _mix_sparse(self, params, x):
        """Capacity dispatch; x: (N, D) → (N, D)."""
        c = self.capacity(x.shape[0])
        gates, m = self.route(params, x)
        w = gates * m
        w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
        # each token's position within its expert's capacity slots
        pos = torch.cumsum(m, dim=0) * m - 1
        keep = (pos >= 0) & (pos < c)
        pos_c = torch.clamp(pos, 0, c - 1).to(torch.int32)
        onehot_c = pos_c[..., None] == torch.arange(
            c, dtype=torch.int32, device=x.device)[None, None, :]
        disp = (keep[..., None] & onehot_c).to(x.dtype)     # (N, E, C)
        xe = _ein("nec,nd->ecd", disp, x)                   # (E, C, D)
        h = torch.tanh(_ein("ecd,edf->ecf", xe, params["w1"])
                       + params["b1"][:, None, :])
        ye = _ein("ecf,efd->ecd", h, params["w2"]) \
            + params["b2"][:, None, :]
        comb = disp * w[..., None]
        return _ein("nec,ecd->nd", comb, ye)

    def apply(self, params, x):
        shape = x.shape
        flat = x.reshape(-1, shape[-1])
        y = (self._mix_sparse(params, flat) if self.top_k
             else self._mix(params, flat))
        return y.reshape(shape)


@matches(MoEFFN)
class GDMoEFFN(GradientDescentBase):
    """The standard GD rules over the expert parameter tree."""

    MAPPING = "gd_moe_ffn"
    hide_from_registry = False

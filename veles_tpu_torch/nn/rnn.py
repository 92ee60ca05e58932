"""Recurrent units: LSTM and the vanilla tanh RNN (counterpart of
``veles_tpu/nn/rnn.py``).

Weights keep the reference's layout: one ``(D + H, G·H)`` matrix (the
LSTM's gates in the order i, f, g, o, G = 4; the RNN's G = 1) and one
bias of ``G·H``; the LSTM adds ``forget_bias`` to f. The gate product is
written SPLIT, ``x_t @ W[:D] + h @ W[D:] + b`` in that order of
additions, as the reference writes it, and the gates go through
``nn/ssm.stable_sigmoid``: the decode step is then the very body the
scan loops over (``nn/ssm.recurrent_scan``), bit for bit. Neither
``nn.LSTM`` nor cuDNN's RNN is used: they fold the two biases, sum in
another order and use another sigmoid. Hoisting ``x @ W[:D]`` out of the
time loop is faster and breaks that identity, so it is not done.

Under ``engine.mixed_precision`` the train step hands the units bf16
parameters and a bf16 batch; the state starts in the input's dtype (as
the reference's ``init_state(batch, x.dtype)``), every product of bf16
operands comes out bf16, and so the carry stays bf16 through the scan,
as in the reference's ``lax.scan``. The scan is still the step loop, bit
for bit.

Each unit has a training form (``LSTM``, ``RNN`` under the mappings
"lstm" and "rnn", paired with ``GDLSTM`` and ``GDRNN``; weights from the
unit's keyed stream ``prng.get(<name>)``, bias zero) and a serving form
(``LSTMLayer``, ``RNNLayer``). Input (B, T, D) → output (B, H), the
final hidden state, or (B, T, H) with ``return_sequences=True``.
Backward is autograd through the time loop.
"""

from __future__ import annotations

from typing import Dict

import numpy
import torch

from ..config import root
from ..memory import Array
from .. import prng
from ..ops.precision import dot, weak_scalar
from .nn_units import ForwardBase, GradientDescentBase, matches
from .ssm import RecurrentCell, stable_sigmoid
from .transformer import _Layer


def _gates(p, x_t, h):
    """The split gate product ``x_t @ W[:D] + h @ W[D:] + b``."""
    d = x_t.shape[-1]
    w = p["weights"]
    return dot(x_t, w[:d]) + dot(h, w[d:]) + p["bias"]


def lstm_step(cell, p, x_t, state):
    """ONE token of the LSTM for every row: x_t (B, D), state ``{"h",
    "c"}`` (B, H) each → (h, new state)."""
    i, f, g, o = _gates(p, x_t, state["h"]).chunk(4, dim=-1)
    i = stable_sigmoid(i)
    # the bias is a weak scalar beside the gate, as jnp takes it
    f = stable_sigmoid(f + weak_scalar(cell.forget_bias, f.dtype))
    g = torch.tanh(g)
    o = stable_sigmoid(o)
    c = f * state["c"] + i * g
    h = o * torch.tanh(c)
    return h, {"h": h, "c": c}


def rnn_step(cell, p, x_t, state):
    """ONE token of the tanh RNN: h = tanh(x_t W[:D] + h W[D:] + b)."""
    h = torch.tanh(_gates(p, x_t, state["h"]))
    return h, {"h": h}


class _RecurrentConfig(RecurrentCell):
    #: gate blocks of the weight matrix
    GATES = 1

    def _configure(self, hidden_size, return_sequences) -> None:
        self.hidden_size = int(hidden_size)
        self.return_sequences = bool(return_sequences)

    def output_shape_for(self, input_shape):
        b, t, _ = input_shape
        if self.return_sequences:
            return (b, t, self.hidden_size)
        return (b, self.hidden_size)

    def _shapes(self, d: int) -> Dict[str, tuple]:
        g = self.GATES * self.hidden_size
        return {"weights": (d + self.hidden_size, g), "bias": (g,)}


class _LSTMMath(_RecurrentConfig):
    GATES = 4

    def state_shapes(self, batch: int) -> Dict[str, tuple]:
        return {"h": (batch, self.hidden_size),
                "c": (batch, self.hidden_size)}

    def step_state(self, params, x_t, state):
        return lstm_step(self, params, x_t, state)


class _RNNMath(_RecurrentConfig):
    def state_shapes(self, batch: int) -> Dict[str, tuple]:
        return {"h": (batch, self.hidden_size)}

    def step_state(self, params, x_t, state):
        return rnn_step(self, params, x_t, state)


class _RecurrentUnit(ForwardBase):
    """The training form's parameters: the weight matrix from the unit's
    keyed stream at stddev ``weights_stddev`` or 1/sqrt(D + H), the bias
    zero."""

    hide_from_registry = True
    PARAMETERIZED = True

    def create_params(self, rng) -> Dict[str, Array]:
        d = int(self.input.shape[-1])
        dtype = root.common.engine.precision_type
        shapes = self._shapes(d)
        stddev = self.weights_stddev or (
            1.0 / numpy.sqrt(d + self.hidden_size))
        w = numpy.zeros(shapes["weights"], dtype=dtype)
        prng.get(self.name).fill_normal(w, stddev)
        return {"weights": Array(w, name=self.name + ".weights"),
                "bias": Array(numpy.zeros(shapes["bias"], dtype=dtype),
                              name=self.name + ".bias")}

    def apply(self, params, x):
        return self.sequence(params, x)


class LSTM(_LSTMMath, _RecurrentUnit):
    """LSTM training unit (layer type "lstm")."""

    MAPPING = "lstm"
    hide_from_registry = False

    def __init__(self, workflow, hidden_size=128, return_sequences=False,
                 forget_bias=1.0, **kwargs):
        self.weights_stddev = kwargs.pop("weights_stddev", None)
        super().__init__(workflow, **kwargs)
        self._configure(hidden_size, return_sequences)
        self.forget_bias = float(forget_bias)


class RNN(_RNNMath, _RecurrentUnit):
    """Vanilla tanh RNN training unit (layer type "rnn")."""

    MAPPING = "rnn"
    hide_from_registry = False

    def __init__(self, workflow, hidden_size=128, return_sequences=False,
                 **kwargs):
        self.weights_stddev = kwargs.pop("weights_stddev", None)
        super().__init__(workflow, **kwargs)
        self._configure(hidden_size, return_sequences)


class _RecurrentLayer(_Layer):
    def __init__(self, dim, hidden_size, return_sequences, name, device,
                 dtype) -> None:
        super().__init__(name)
        self.dim = int(dim)
        self._configure(hidden_size, return_sequences)
        self._make_params(device, dtype)

    def param_shapes(self):
        return self._shapes(self.dim)

    def forward(self, x):
        return self.sequence(self.params(), x)


class LSTMLayer(_LSTMMath, _RecurrentLayer):
    """The serving module of :class:`LSTM`."""

    def __init__(self, dim: int, hidden_size: int = 128,
                 return_sequences: bool = False, forget_bias: float = 1.0,
                 name: str = "lstm", device=None,
                 dtype=torch.float32) -> None:
        super().__init__(dim, hidden_size, return_sequences, name, device,
                         dtype)
        self.forget_bias = float(forget_bias)


class RNNLayer(_RNNMath, _RecurrentLayer):
    """The serving module of :class:`RNN`."""

    def __init__(self, dim: int, hidden_size: int = 128,
                 return_sequences: bool = False, name: str = "rnn",
                 device=None, dtype=torch.float32) -> None:
        super().__init__(dim, hidden_size, return_sequences, name, device,
                         dtype)


@matches(LSTM)
class GDLSTM(GradientDescentBase):
    MAPPING = "gd_lstm"
    hide_from_registry = False


@matches(RNN)
class GDRNN(GradientDescentBase):
    MAPPING = "gd_rnn"
    hide_from_registry = False

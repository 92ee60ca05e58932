"""The shared recurrent protocol and the SSD/linear-attention block
(counterpart of ``veles_tpu/nn/ssm.py``).

There is exactly ONE per-token step body per recurrent unit
(``step_state``); "scan mode" (training, the serving lane's prefill) is
:func:`recurrent_scan`, a Python loop of that body over time, and
"recurrent mode" (decode) is a single application of it. The two modes
run the same ops in the same order on the same shapes, so they agree bit
for bit by construction, not within a tolerance: every gate goes through
:func:`stable_sigmoid`, and a length-masked step keeps the old state
through :func:`mask_keep`.

Per head ``h`` with head dim ``e`` the SSM block's state is an ``e x e``
matrix ``S`` updated by a learned scalar decay ``a_h =
sigmoid(a_log_h)``::

    S_t = a_h * S_{t-1} + k_t ⊗ v_t          # (e, e) outer product
    y_t = (q_t · S_t) / sqrt(e)              # linear-attention read
    out = (concat_h y_t * sigmoid(x_t W_g)) W_o
    x_t ← x_t + out                          # residual

Each recurrent unit has two forms that share its math (as the
transformer layers do): a workflow unit for training (``SSMBlock``,
``ssm_block``, paired with ``GDSSMBlock``; parameters from the
reference's keyed streams) and an ``nn.Module`` for serving
(``SSMBlockLayer``, parameters under the reference's names and layout).
Both expose the protocol ``state_shapes`` / ``init_state`` /
``step_state`` / ``scan_state`` that ``serving/recurrent.py`` drives.
The products go through ``ops/precision.dot``; the recurrent units hold
float32 (``TrainStep`` refuses them under ``engine.mixed_precision``).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy
import torch

from ..config import root
from ..error import VelesError
from ..memory import Array
from .. import prng
from ..ops.precision import dot
from .nn_units import ForwardBase, GradientDescentBase, matches
from .transformer import _Layer

State = Dict[str, torch.Tensor]


def stable_sigmoid(v):
    """``sigmoid`` written out as ``0.5 * (tanh(v / 2) + 1)``, the
    reference's form: every recurrent gate goes through it."""
    return 0.5 * (torch.tanh(0.5 * v) + 1.0)


def mask_keep(keep, new, old):
    """``where(keep, new, old)``: a Python bool picks a whole leaf, a
    ``(B,)`` row mask broadcasts over each leaf's trailing dims. A
    masked-out row keeps its old state bit for bit."""
    if isinstance(keep, bool):
        return new if keep else old
    keep = keep.reshape(keep.shape + (1,) * (new.ndim - keep.ndim))
    return torch.where(keep, new, old)


def recurrent_scan(unit, params, x, state: State, length=None
                   ) -> Tuple[torch.Tensor, State]:
    """Scan mode of every recurrent unit: ``unit.step_state`` over time,
    a Python loop. ``x`` is (B, T, D); ``length`` (an int or a (B,) int
    tensor) keeps the state of a row unchanged at positions ``t >=
    length``, so a padded scan carries exactly the state of the
    unpadded one. Returns (ys (B, T, H_out), final state)."""
    # one (T, B, D) copy: each step then reads a contiguous (B, D) row
    # block, as a decode step's input is
    xs = x.transpose(0, 1).contiguous()
    ys = []
    for t in range(xs.shape[0]):
        y, new = unit.step_state(params, xs[t], state)
        if length is not None:
            keep = t < length
            new = {k: mask_keep(keep, v, state[k]) for k, v in new.items()}
        state = new
        ys.append(y)
    return torch.stack(ys, dim=1), state


def decay_logits(n_heads: int, decay_min: float, decay_max: float
                 ) -> numpy.ndarray:
    """The reference's deterministic ``a_log`` init: per-head decays
    spread over [decay_min, decay_max], as logits (float64)."""
    a = numpy.linspace(decay_min, decay_max, n_heads).astype(numpy.float64)
    a = numpy.clip(a, 1e-4, 1.0 - 1e-4)
    return numpy.log(a / (1.0 - a))


def ssm_step(block, p, x_t, state: State) -> Tuple[torch.Tensor, State]:
    """ONE token of the SSM block for every row: x_t (B, D), state
    ``{"s": (B, H, e, e)}`` → (y_t (B, D), new state)."""
    b, d = x_t.shape
    h = block.n_heads
    hd = d // h
    q = dot(x_t, p["wq"]).reshape(b, h, hd)
    k = dot(x_t, p["wk"]).reshape(b, h, hd)
    v = dot(x_t, p["wv"]).reshape(b, h, hd)
    a = stable_sigmoid(p["a_log"]).to(x_t.dtype)                # (H,)
    s = a[None, :, None, None] * state["s"] \
        + k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhd,bhde->bhe", q, s) * (1.0 / math.sqrt(hd))
    gate = stable_sigmoid(dot(x_t, p["wg"]))
    out = dot(y.reshape(b, d).to(x_t.dtype) * gate, p["wo"])
    return x_t + out, {"s": s}


class RecurrentCell:
    """The recurrent protocol over a unit's ``state_shapes`` and
    ``step_state``, shared by the training units and the serving
    modules of ``nn/ssm.py`` and ``nn/rnn.py``."""

    #: output of the whole-sequence forward: every position, or only the
    #: final state's
    return_sequences = True

    def state_shapes(self, batch: int) -> Dict[str, tuple]:
        raise NotImplementedError

    def init_state(self, batch: int, dtype=torch.float32,
                   device=None) -> State:
        return {k: torch.zeros(shape, dtype=dtype, device=device)
                for k, shape in self.state_shapes(batch).items()}

    def step_state(self, params, x_t, state: State):
        raise NotImplementedError

    def scan_state(self, params, x, state: State, length=None):
        return recurrent_scan(self, params, x, state, length)

    def sequence(self, params, x):
        """The whole-sequence forward from a zero state: (B, T, D) →
        (B, T, H_out), or the last position's (B, H_out) when the unit
        does not return sequences."""
        ys, _ = self.scan_state(params, x, self.init_state(
            x.shape[0], x.dtype, x.device))
        return ys if self.return_sequences else ys[:, -1]


class _SSMConfig(RecurrentCell):
    def _configure(self, n_heads, decay_min, decay_max) -> None:
        self.n_heads = int(n_heads)
        if self.n_heads < 1:
            raise VelesError("ssm_block needs n_heads >= 1")
        self.decay_min = float(decay_min)
        self.decay_max = float(decay_max)

    def _check_dim(self, d: int) -> None:
        if d % self.n_heads:
            raise VelesError("ssm_block dim %d not divisible by n_heads %d"
                             % (d, self.n_heads))

    def state_shapes(self, batch: int) -> Dict[str, tuple]:
        hd = self.dim // self.n_heads
        return {"s": (batch, self.n_heads, hd, hd)}

    def step_state(self, params, x_t, state):
        return ssm_step(self, params, x_t, state)


class SSMBlock(_SSMConfig, ForwardBase):
    """Gated linear-attention (SSD) block, (B, T, D) → (B, T, D),
    residual: the training unit. ``n_heads`` must divide D."""

    MAPPING = "ssm_block"
    PARAMETERIZED = True
    hide_from_registry = False
    MIXED_PRECISION = False
    PARAM_NAMES = ("wq", "wk", "wv", "wg", "wo", "a_log")
    LORA_TARGETS = ()

    def __init__(self, workflow, n_heads=4, decay_min=0.6, decay_max=0.95,
                 **kwargs):
        self.weights_stddev = kwargs.pop("weights_stddev", None)
        super().__init__(workflow, **kwargs)
        self._configure(n_heads, decay_min, decay_max)

    @property
    def dim(self) -> int:
        return int(self.input.shape[-1])

    def output_shape_for(self, input_shape):
        return tuple(input_shape)

    def create_params(self, rng) -> Dict[str, Array]:
        d = self.dim
        self._check_dim(d)
        dtype = root.common.engine.precision_type
        stddev = self.weights_stddev or (1.0 / numpy.sqrt(d))
        out: Dict[str, Array] = {}
        for k in ("wq", "wk", "wv", "wg", "wo"):
            w = numpy.zeros((d, d), dtype=dtype)
            prng.get("%s.%s" % (self.name, k)).fill_normal(w, stddev)
            out[k] = Array(w, name="%s.%s" % (self.name, k))
        out["a_log"] = Array(decay_logits(
            self.n_heads, self.decay_min, self.decay_max).astype(dtype),
            name=self.name + ".a_log")
        return out

    def apply(self, params, x):
        return self.sequence(params, x)


class SSMBlockLayer(_SSMConfig, _Layer):
    """The serving module of :class:`SSMBlock`: (B, T, D) → (B, T, D)."""

    def __init__(self, dim: int, n_heads: int = 4, decay_min: float = 0.6,
                 decay_max: float = 0.95, name: str = "ssm_block",
                 device=None, dtype=torch.float32) -> None:
        super().__init__(name)
        self._configure(n_heads, decay_min, decay_max)
        self.dim = int(dim)
        self._check_dim(self.dim)
        self._make_params(device, dtype)

    def param_shapes(self):
        d = self.dim
        shapes = {k: (d, d) for k in ("wq", "wk", "wv", "wg", "wo")}
        shapes["a_log"] = (self.n_heads,)
        return shapes

    def deterministic_params(self) -> Dict[str, numpy.ndarray]:
        """Parameters whose init is no draw: ``a_log``'s decay spread."""
        return {"a_log": decay_logits(self.n_heads, self.decay_min,
                                      self.decay_max)}

    def forward(self, x):
        return self.sequence(self.params(), x)


@matches(SSMBlock)
class GDSSMBlock(GradientDescentBase):
    MAPPING = "gd_ssm_block"
    hide_from_registry = False

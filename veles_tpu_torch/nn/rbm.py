"""Restricted Boltzmann machine: the hidden probabilities and the CD-1
trainer (counterpart of ``veles_tpu/nn/rbm.py``; unit types "rbm" and
"rbm_trainer").

Bernoulli–Bernoulli, contrastive divergence with one Gibbs step: the
products of both phases run as torch ops on the unit's device. The
sampling uniforms are an input of :func:`cd1_step`. The trainer draws
them from its keyed stream on the host (``prng.get(self.name)``, a
(minibatch, hidden) float32 array, 16 KB at 64 × 64) and copies them to
the device, as the reference's ``numpy_run`` draws them; so the port
follows the reference's host path step for step from the same seed. The
reference's device path draws them with ``jax.random.uniform`` from a
threefry key, whose bits nothing here can reproduce.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy
import torch

from ..error import VelesError
from ..memory import Array
from .. import prng
from .nn_units import ForwardBase


def _sigmoid(z: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-z))


def cd1_step(params: Dict[str, torch.Tensor], v0: torch.Tensor,
             u_h0: torch.Tensor, lr: float
             ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One CD-1 update from the visible batch ``v0`` with the sampling
    uniforms ``u_h0``: (new params, the reconstruction error as a 0-d
    tensor)."""
    w, vb, hb = params["weights"], params["vbias"], params["hbias"]
    h0_prob = _sigmoid(v0 @ w + hb)
    h0 = (u_h0 < h0_prob).to(v0.dtype)
    v1_prob = _sigmoid(h0 @ w.T + vb)
    h1_prob = _sigmoid(v1_prob @ w + hb)
    n = v0.shape[0]
    dw = (v0.T @ h0_prob - v1_prob.T @ h1_prob) / n
    dvb = (v0 - v1_prob).mean(dim=0)
    dhb = (h0_prob - h1_prob).mean(dim=0)
    new = {"weights": w + lr * dw, "vbias": vb + lr * dvb,
           "hbias": hb + lr * dhb}
    err = ((v0 - v1_prob) ** 2).mean()
    return new, err


class RBM(ForwardBase):
    """Forward: the hidden units' probabilities ``sigmoid(x·W + hbias)``."""

    MAPPING = "rbm"
    PARAMETERIZED = True
    hide_from_registry = False
    PARAM_NAMES = ("weights", "vbias", "hbias")

    def __init__(self, workflow, n_hidden: int = 64, **kwargs) -> None:
        self.weights_stddev = kwargs.pop("weights_stddev", 0.01)
        super().__init__(workflow, **kwargs)
        self.n_hidden = int(n_hidden)

    def output_shape_for(self, input_shape):
        return (input_shape[0], self.n_hidden)

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """weights (visible, hidden), vbias, hbias (``convert.py``)."""
        if self.input is None or not self.input:
            raise VelesError("%s: its input fixes the weights' shape; link "
                             "it first" % self.name)
        n_vis = int(numpy.prod(self.input.shape[1:]))
        return {"weights": (n_vis, self.n_hidden), "vbias": (n_vis,),
                "hbias": (self.n_hidden,)}

    def create_params(self, rng: prng.RandomGenerator) -> Dict[str, Array]:
        shapes = self.param_shapes()
        return {
            "weights": Array(rng.normal(
                0.0, self.weights_stddev, shapes["weights"]).astype(
                    "float32"), name=self.name + ".weights"),
            "vbias": Array(numpy.zeros(shapes["vbias"], dtype="float32"),
                           name=self.name + ".vbias"),
            "hbias": Array(numpy.zeros(shapes["hbias"], dtype="float32"),
                           name=self.name + ".hbias"),
        }

    def apply(self, params, x):
        x = x.reshape(x.shape[0], -1).to(params["weights"].dtype)
        return _sigmoid(x @ params["weights"] + params["hbias"])

    def reconstruct(self, params, x):
        """v → h_prob → v̂ (the deterministic mean-field
        reconstruction)."""
        h = self.apply(params, x)
        return _sigmoid(h @ params["weights"].T + params["vbias"])


class RBMTrainer(RBM):
    """CD-1 trainer owning the RBM's parameters."""

    MAPPING = "rbm_trainer"
    hide_from_registry = False

    def __init__(self, workflow, n_hidden: int = 64,
                 learning_rate: float = 0.1, **kwargs) -> None:
        super().__init__(workflow, n_hidden=n_hidden, **kwargs)
        self.learning_rate = float(learning_rate)
        self.steps = 0
        self._rng = prng.get(self.name)
        #: the last step's reconstruction error, on the device until read
        self._err: Optional[torch.Tensor] = None

    @property
    def reconstruction_error(self) -> float:
        return float("nan") if self._err is None else float(self._err)

    def torch_run(self) -> None:
        v0 = self.input.device_view(self.device)
        v0 = v0.reshape(v0.shape[0], -1).to(torch.float32)
        # the reference's numpy_run draw, copied to the device
        u = torch.from_numpy(self._rng.rand(
            v0.shape[0], self.n_hidden).astype("float32")).to(self.device)
        arrays = self.param_arrays()
        params = {k: v.device_view(self.device) for k, v in arrays.items()}
        new, self._err = cd1_step(params, v0, u, self.learning_rate)
        for k, arr in arrays.items():
            arr.assign_devmem(new[k])
        self.steps += 1

    def get_metric_values(self) -> Dict[str, Any]:
        return {"rbm_reconstruction_error": self.reconstruction_error,
                "rbm_steps": self.steps}

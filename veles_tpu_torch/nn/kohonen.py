"""Kohonen self-organising map: the winner lookup and the batch-SOM
trainer (counterpart of ``veles_tpu/nn/kohonen.py``; unit types
"kohonen_forward" and "kohonen_trainer").

A step is :func:`som_step` in torch ops on the unit's device: the
squared distances of every sample to every neuron through the GEMM
expansion ``‖x‖² − 2·x·Wᵀ + ‖w‖²``, the winner (the first index among
equal distances, as ``argmin`` gives it in both packages), the Gaussian
neighbourhood over the 2-D grid, and the neighbourhood-weighted mean
pull of the weights toward the batch. The radius and the rate decay
exponentially with the trainer's clock, which snapshots carry as
``__time__``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy
import torch

from ..error import VelesError
from ..memory import Array
from .. import prng
from .nn_units import ForwardBase


def _grid_coords(sy: int, sx: int) -> numpy.ndarray:
    yy, xx = numpy.mgrid[0:sy, 0:sx]
    return numpy.stack([yy.ravel(), xx.ravel()], axis=1).astype("float32")


def _pairwise_sqdist(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """‖x−w‖² per (sample, neuron) via the GEMM expansion."""
    x2 = (x * x).sum(dim=1)[:, None]
    w2 = (w * w).sum(dim=1)[None, :]
    return x2 - 2.0 * (x @ w.T) + w2


def som_step(weights: torch.Tensor, grid: torch.Tensor, x: torch.Tensor,
             lr: float, sigma: float
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One batch-SOM update: (new weights, int32 winners, the mean
    quantisation error as a 0-d tensor)."""
    d2 = _pairwise_sqdist(x, weights)
    winners = torch.argmin(d2, dim=1)
    rows = torch.arange(x.shape[0], device=x.device)
    qerr = torch.sqrt(torch.clamp(d2[rows, winners], min=0.0)).mean()
    # neighbourhood over the grid: h[i, j] = exp(-‖g_win(i) − g_j‖²/2σ²)
    gwin = grid[winners]
    gd2 = ((gwin[:, None, :] - grid[None, :, :]) ** 2).sum(dim=2)
    h = torch.exp(-gd2 / (2.0 * sigma * sigma))
    num = h.T @ x
    den = h.sum(dim=0)[:, None]
    target = num / torch.clamp(den, min=1e-12)
    new_w = weights + lr * torch.clamp(den, max=1.0) * (target - weights)
    return new_w, winners.to(torch.int32), qerr


class KohonenForward(ForwardBase):
    """Maps each sample to the index of its best-matching neuron."""

    MAPPING = "kohonen_forward"
    PARAMETERIZED = True
    hide_from_registry = False
    PARAM_NAMES = ("weights",)

    def __init__(self, workflow, shape: Tuple[int, int] = (8, 8),
                 **kwargs) -> None:
        self.weights_stddev = kwargs.pop("weights_stddev", 0.05)
        super().__init__(workflow, **kwargs)
        self.shape = tuple(shape)

    @property
    def neurons_number(self) -> int:
        return self.shape[0] * self.shape[1]

    def output_shape_for(self, input_shape):
        return (input_shape[0],)

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """{"weights": (neurons, features)} (``convert.py``)."""
        if self.input is None or not self.input:
            raise VelesError("%s: its input fixes the weights' shape; link "
                             "it first" % self.name)
        return {"weights": (self.neurons_number,
                            int(numpy.prod(self.input.shape[1:])))}

    def create_params(self, rng: prng.RandomGenerator) -> Dict[str, Array]:
        w = rng.normal(0.0, self.weights_stddev,
                       self.param_shapes()["weights"]).astype("float32")
        return {"weights": Array(w, name=self.name + ".weights")}

    def apply(self, params, x):
        x = x.reshape(x.shape[0], -1).to(params["weights"].dtype)
        return torch.argmin(_pairwise_sqdist(x, params["weights"]),
                            dim=1).to(torch.int32)

    def initialize(self, device=None, **kwargs):
        res = super().initialize(device=device, **kwargs)
        if res:
            return res
        # winner indices are int32, not the float minibatch dtype
        if self.input is not None and self.input:
            self.output.reset(numpy.zeros(self.input.shape[0],
                                          dtype=numpy.int32))
        return None


class KohonenTrainer(ForwardBase):
    """Batch-SOM trainer with an exponentially decaying radius and rate;
    owns the weights (a KohonenForward can link to them)."""

    MAPPING = "kohonen_trainer"
    PARAMETERIZED = True
    hide_from_registry = False
    PARAM_NAMES = ("weights",)

    def __init__(self, workflow, shape: Tuple[int, int] = (8, 8),
                 sigma0: Optional[float] = None, lr0: float = 0.5,
                 decay: float = 200.0, **kwargs) -> None:
        self.weights_stddev = kwargs.pop("weights_stddev", 0.05)
        super().__init__(workflow, **kwargs)
        self.shape = tuple(shape)
        self.sigma0 = float(sigma0 if sigma0 is not None
                            else max(self.shape) / 2.0)
        self.lr0 = float(lr0)
        self.decay = float(decay)
        self.time = 0
        self.grid = _grid_coords(*self.shape)
        self._grid_dev: Optional[torch.Tensor] = None
        #: the last step's winners and quantisation error, on the device
        #: until read
        self._winners: Optional[torch.Tensor] = None
        self._qerr: Optional[torch.Tensor] = None

    neurons_number = KohonenForward.neurons_number
    param_shapes = KohonenForward.param_shapes
    create_params = KohonenForward.create_params

    def output_shape_for(self, input_shape):
        return (input_shape[0],)

    @property
    def winners(self) -> Optional[numpy.ndarray]:
        """The last step's winner per sample (int32)."""
        return None if self._winners is None else \
            self._winners.cpu().numpy()

    @property
    def quantization_error(self) -> float:
        """The last step's mean distance of a sample to its winner."""
        return float("nan") if self._qerr is None else float(self._qerr)

    def schedule(self) -> Tuple[float, float]:
        """(lr, sigma) at the trainer's clock."""
        factor = numpy.exp(-float(self.time) / self.decay)
        return (max(self.lr0 * factor, 1e-4),
                max(self.sigma0 * factor, 0.35))

    def torch_run(self) -> None:
        lr, sigma = self.schedule()
        if self._grid_dev is None or self._grid_dev.device != self.device:
            self._grid_dev = torch.from_numpy(self.grid).to(self.device)
        x = self.input.device_view(self.device)
        x = x.reshape(x.shape[0], -1).to(torch.float32)
        w, self._winners, self._qerr = som_step(
            self.weights.device_view(self.device).to(torch.float32),
            self._grid_dev, x, lr, sigma)
        self.weights.assign_devmem(w)
        self.time += 1

    def get_metric_values(self) -> Dict[str, Any]:
        return {"som_qerr": self.quantization_error,
                "som_steps": self.time}

    # the trainer's state beyond its weights: the decay clock
    def state_dict(self):
        sd = super().state_dict()
        sd["__time__"] = numpy.int64(self.time)
        return sd

    def load_state_dict(self, sd):
        sd = dict(sd)
        t = sd.pop("__time__", None)
        if t is not None:
            self.time = int(t)
        super().load_state_dict(sd)

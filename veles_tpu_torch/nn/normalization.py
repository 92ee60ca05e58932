"""Local response normalisation across channels (counterpart of
``veles_tpu/nn/normalization.py``; layer type "norm", which AlexNet-style
configs use)::

    y = x / (k + alpha · Σ_{j in window} x_j²) ** beta

over a window of ``2·(n // 2) + 1`` channels centred on each channel,
clipped at the edges. The window's sum of squares is taken in float32,
as the reference takes it, and the result returns in the input's dtype;
its gradient comes from autograd.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .nn_units import ForwardBase


class LRNormalizerForward(ForwardBase):
    MAPPING = "norm"
    hide_from_registry = False

    def __init__(self, workflow, alpha=1e-4, beta=0.75, n=5, k=2.0,
                 **kwargs):
        super().__init__(workflow, **kwargs)
        self.alpha, self.beta, self.n, self.k = alpha, beta, n, k

    def output_shape_for(self, input_shape):
        return input_shape

    def apply(self, params, x):
        half = self.n // 2
        c = x.shape[-1]
        sqp = F.pad(torch.square(x.float()), (half, half))
        win = sum(sqp[..., i:i + c] for i in range(2 * half + 1))
        return (x / torch.pow(self.k + self.alpha * win,
                              self.beta)).to(x.dtype)

"""Pooling units and their GD units (counterpart of
``veles_tpu/nn/pooling.py``; layer types "max_pooling", "avg_pooling",
"stochastic_pooling").

The reference pools in ceil mode: a partial window at the right or
bottom edge counts, and an input smaller than the window gives one
window. Its output is ``oh = ceil((h - ky) / sy) + 1`` (1 when h < ky),
which ``ceil_mode=True`` does not give when the window is smaller than
the stride. So the input is padded explicitly to ``(oh - 1)·sy + ky``
rows (and likewise columns) — with −inf for max, 0 for avg — and pooled
with no padding of torch's own. Avg divides by the edge-clipped window
size, a count map; max sends a window's gradient to its first maximum in
scan order, as the reference's ``reduce_window`` VJP does. A window that
lies wholly in the padding (possible when kx < sx) is −inf (max) or
0/0 (avg), as the reference's.

Stochastic pooling is max pooling in evaluation. In training it picks
one element of each window by Gumbel-argmax over the window's values —
element i with probability ∝ exp(x_i), a padded −inf position never —
drawing from the layer's ``torch.Generator``; the reference draws with
``jax.random.gumbel``, whose bits the port cannot reproduce. Its
gradient reaches the picked element only (autograd through the
gather), and it pairs with the max-pooling GD unit, as in the
reference.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy
import torch
import torch.nn.functional as F

from .nn_units import ForwardBase, GradientDescentBase, matches


def ceil_windows(n: int, k: int, s: int) -> int:
    """Windows of ``k`` at stride ``s`` over ``n`` in ceil mode."""
    return -(-(n - k) // s) + 1 if n >= k else 1


def clipped_counts(n: int, k: int, s: int) -> numpy.ndarray:
    """Each window's count of real (unpadded) positions."""
    starts = numpy.arange(ceil_windows(n, k, s)) * s
    return numpy.clip(numpy.minimum(starts + k, n) - starts, 0, None)


class Pooling(ForwardBase):
    hide_from_registry = True

    def __init__(self, workflow, kx=2, ky=2, sliding=None, **kwargs):
        super().__init__(workflow, **kwargs)
        self.kx, self.ky = kx, ky
        self.sliding = tuple(sliding) if sliding else (kx, ky)

    def output_shape_for(self, input_shape):
        b, h, w, c = input_shape
        sx, sy = self.sliding
        return (b, ceil_windows(h, self.ky, sy),
                ceil_windows(w, self.kx, sx), c)

    def _padded(self, x, value) -> torch.Tensor:
        """``x`` as an NCHW (channels_last) view, padded at the bottom and
        right to whole windows with ``value``."""
        _, h, w, _ = x.shape
        _, oh, ow, _ = self.output_shape_for(x.shape)
        sx, sy = self.sliding
        pad_h = (oh - 1) * sy + self.ky - h
        pad_w = (ow - 1) * sx + self.kx - w
        return F.pad(x.permute(0, 3, 1, 2), (0, pad_w, 0, pad_h),
                     value=value)

    def _window(self) -> Dict[str, Tuple[int, int]]:
        sx, sy = self.sliding
        return dict(kernel_size=(self.ky, self.kx), stride=(sy, sx))


class MaxPooling(Pooling):
    MAPPING = "max_pooling"
    hide_from_registry = False

    def apply(self, params, x):
        y = F.max_pool2d(self._padded(x, float("-inf")), **self._window())
        return y.permute(0, 2, 3, 1)


class AvgPooling(Pooling):
    MAPPING = "avg_pooling"
    hide_from_registry = False

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self._counts: Dict[tuple, torch.Tensor] = {}

    def counts(self, h: int, w: int, dtype, device) -> torch.Tensor:
        """The (oh, ow, 1) map of edge-clipped window sizes, in ``dtype``
        on ``device`` (made once per geometry)."""
        key = (h, w, dtype, str(device))
        got = self._counts.get(key)
        if got is None:
            sx, sy = self.sliding
            grid = numpy.outer(clipped_counts(h, self.ky, sy),
                               clipped_counts(w, self.kx, sx))
            got = self._counts[key] = torch.from_numpy(
                grid[:, :, None].astype(numpy.float32)).to(device, dtype)
        return got

    def apply(self, params, x):
        _, h, w, _ = x.shape
        summed = F.avg_pool2d(self._padded(x, 0.0), divisor_override=1,
                              **self._window())
        return summed.permute(0, 2, 3, 1) / self.counts(h, w, x.dtype,
                                                        x.device)


class StochasticPooling(MaxPooling):
    MAPPING = "stochastic_pooling"
    hide_from_registry = False
    NEEDS_RNG = True

    def apply(self, params, x, train=False, generator=None):
        if not train or generator is None:
            return super().apply(params, x)
        sx, sy = self.sliding
        # (B, C, OH, OW, ky·kx) windows of the −inf-padded NCHW view
        wins = self._padded(x, float("-inf")).unfold(2, self.ky, sy) \
            .unfold(3, self.kx, sx)
        wins = wins.reshape(wins.shape[:4] + (self.ky * self.kx,))
        logits = torch.where(torch.isfinite(wins), wins, -1e30)
        u = torch.rand(wins.shape, generator=generator, device=x.device,
                       dtype=torch.float32).clamp_(
            min=torch.finfo(torch.float32).tiny)
        gumbel = (-torch.log(-torch.log(u))).to(wins.dtype)
        choice = torch.argmax(logits + gumbel, dim=-1, keepdim=True)
        return torch.gather(wins, -1, choice)[..., 0].permute(0, 2, 3, 1)


@matches(MaxPooling)
class GDMaxPooling(GradientDescentBase):
    MAPPING = "gd_max_pooling"


@matches(AvgPooling)
class GDAvgPooling(GradientDescentBase):
    MAPPING = "gd_avg_pooling"

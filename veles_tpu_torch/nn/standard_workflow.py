"""Layer-config → module stack (the forward half of
``veles_tpu/nn/standard_workflow.py``).

:func:`build_forwards` takes the same ``layers`` list of dicts that the
reference's ``StandardWorkflow`` takes (``models/char_lm.py``
``build_workflow``/``build_bench_workflow`` pass it) and returns the
port's module stack, each layer named as the reference names its unit:
the dict's ``"name"``, else ``"<type><index>"``. The graph engine
(units, links, the training step) is not ported yet, so the keys that
configure training (solver, learning rates, decay, initialisers) are
accepted and ignored.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from ..backends import device_for
from ..config import root
from ..error import VelesError
from .transformer import (Embedding, LMHead, PositionalEmbedding,
                          TransformerBlock)

#: layer-dict keys that configure training only
TRAINING_KEYS = frozenset((
    "solver", "learning_rate", "learning_rate_bias", "weights_decay",
    "weights_decay_bias", "gradient_moment", "gradient_moment_bias",
    "l1_vs_l2", "weights_stddev", "bias_stddev", "stddev"))


class Forwards(nn.Module):
    """The ordered forward stack; ``layers[name]`` is the layer the
    reference calls ``name``."""

    def __init__(self, layers: Dict[str, nn.Module]) -> None:
        super().__init__()
        self.layers = nn.ModuleDict(layers)

    def __iter__(self):
        return iter(self.layers.values())

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward(self, ids):
        """Full-window forward: (B, T) ids → (B, T, V) logits."""
        x = ids
        for layer in self.layers.values():
            x = layer(x)
        return x


def build_forwards(layers: List[dict], seq_len: Optional[int] = None,
                   device=None) -> Forwards:
    """Turn a reference ``layers`` config into a :class:`Forwards` stack
    with zero parameters on ``device`` (default: the card), in
    ``root.common.engine.precision_type``. Widths flow from the
    embedding's ``dim``; a ``pos_embedding`` layer needs the table
    length ``seq_len`` (the reference sizes it from its loader's
    sequence length)."""
    device = device_for(device)
    dtype = getattr(torch, str(root.common.engine.precision_type))
    out: Dict[str, nn.Module] = {}
    dim = None
    for i, cfg in enumerate(layers):
        cfg = {k: v for k, v in cfg.items() if k not in TRAINING_KEYS}
        kind = cfg.pop("type")
        name = cfg.pop("name", "%s%d" % (kind, i))
        kw = dict(cfg, name=name, device=device, dtype=dtype)
        if kind == "embedding":
            layer = Embedding(**kw)
            dim = layer.dim
        elif dim is None:
            raise VelesError("layer %r: the stack must start with an "
                             "embedding" % name)
        elif kind == "pos_embedding":
            if seq_len is None:
                raise VelesError("layer %r: pos_embedding needs seq_len"
                                 % name)
            layer = PositionalEmbedding(seq_len, dim, **kw)
        elif kind == "transformer_block":
            layer = TransformerBlock(dim, **kw)
        elif kind == "lm_head":
            layer = LMHead(dim, **kw)
        else:
            raise VelesError("layer type %r is not ported yet" % (kind,))
        if name in out:
            raise VelesError("duplicate layer name %r" % name)
        out[name] = layer
    return Forwards(out)

"""Auto-vivifying configuration tree (trimmed counterpart of
``veles_tpu/config.py``).

A global attribute tree ``root`` where any ``root.a.b.c = v`` path
springs into existence. The port keeps only the keys its ported slice
reads; unlike the reference it reads no site or user override files.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterator, Tuple


class Config:
    """A node in the auto-vivifying config tree."""

    def __init__(self, path: str = "root") -> None:
        object.__setattr__(self, "_path_", path)

    def __getattr__(self, name: str) -> "Config":
        if name.startswith("__") and name.endswith("__"):
            raise AttributeError(name)
        child = Config("%s.%s" % (self._path_, name))
        object.__setattr__(self, name, child)
        return child

    def __contains__(self, name: str) -> bool:
        return name in self.__dict__ and not name.endswith("_")

    def _is_husk(self) -> bool:
        """True when this node holds nothing but (recursively) empty
        Config children — the shape mere reads auto-vivify."""
        return all(isinstance(v, Config) and v._is_husk()
                   for _k, v in self.items())

    def get(self, name: str, default: Any = None) -> Any:
        """Like dict.get; a node vivified by mere reads counts as
        unset."""
        if name in self:
            val = self.__dict__[name]
            if isinstance(val, Config) and val._is_husk():
                return default
            return val
        return default

    def items(self) -> Iterator[Tuple[str, Any]]:
        for k, v in self.__dict__.items():
            if k.endswith("_") or k.startswith("_"):
                continue
            yield k, v

    def update(self, tree: Dict[str, Any] = None, **kwargs: Any) -> "Config":
        """Deep-merge a nested dict (or kwargs) into this subtree."""
        tree = dict(tree or {})
        tree.update(kwargs)
        for k, v in tree.items():
            if isinstance(v, dict):
                getattr(self, k).update(v)
            else:
                setattr(self, k, v)
        return self

    def __repr__(self) -> str:
        return "<Config %s: %s>" % (self._path_, sorted(
            k for k, _ in self.items()))


def _default_root() -> Config:
    r = Config("root")
    r.common.update({
        # master seed of every keyed stream (prng._default_seed)
        "random_seed": 1234,
        "dirs": {
            # first place datasets.load_mnist looks for the real files
            "datasets": os.path.expanduser("~/.veles_tpu/datasets"),
            # where a Snapshotter given no directory writes
            "snapshots": os.path.expanduser("~/.veles_tpu/snapshots"),
        },
        "engine": {
            # the whole-epoch fused-FC SGD kernel for eligible
            # [all2all_tanh..., softmax] chains
            # (TrainStep._setup_fused_fc); off by default, as in the
            # reference
            "fused_fc_scan": False,
            # parameter dtype of the stacks build_forwards makes; this
            # slice runs float32 end to end
            "precision_type": "float32",
            # TrainStep's bf16 forward/backward over float32 masters,
            # and bf16 storage of the interlayer activations under it;
            # off by default, as in the reference
            "mixed_precision": False,
            "bf16_activations": False,
            # storage dtype of float datasets (loader/fullbatch.py);
            # None = precision_type
            "dataset_dtype": None,
            # the hand-written flash kernel for prefill attention. True =
            # use it on a CUDA device whenever the head dim qualifies
            # (ops/flash_attention.choose_flash); False = always the
            # plain torch attention
            "flash_attention": True,
        },
        "resilience": {
            "max_queue": 256,         # GenerationAPI queue bound
            # fault-injection spec (point:action[:k=v,...];...); the
            # VELES_FAULTS environment variable overrides it
            "faults": "",
            # default RetryPolicy knobs (exponential backoff + jitter)
            "retry": {"max_attempts": 4, "base_delay": 0.5,
                      "max_delay": 30.0},
            "keep_last": 0,           # snapshot retention; 0 = keep all
        },
        # the reference's non-blocking snapshots: not ported (the
        # Snapshotter refuses True)
        "overlap": {
            "async_snapshots": False,
        },
        "serving": {
            # the reference's defaults. "continuous" = the paged
            # slot-pool engine (serving/engine.py); "recurrent" = the
            # O(1)-state slot pool (serving/recurrent.py); "window" = the
            # shape-keyed coalescing worker, which also takes every
            # request the pool cannot hold. Not ported yet: the
            # reference's spec_gamma, beam_width, qos, prefix_cache,
            # prefill_chunk, artifact and tp knobs (the engine raises
            # "not ported yet" for the ones it takes as arguments)
            "engine": "continuous",
            "max_slots": 8,
            "buckets": [16, 32, 64, 128],
            "max_context": 640,
            "decode_block": 1,
            "page_size": 16,
            # None = the dense-equivalent max_slots x pages_per_slot
            "pages": None,
            # the O(1)-state lane (serving/recurrent.py, which
            # "continuous" falls back to for Embedding → LSTM/RNN/SSM →
            # LMHead stacks; "recurrent" pins it): its state-checkpoint
            # prefix cache, off by default as in the reference, and the
            # cache's soft block budget (None = unbounded). The cache
            # is not ported yet: turning it on raises
            "state_cache": False,
            "state_cache_blocks": None,
        },
    })
    # models/mnist.py defaults (the reference's optimisable ranges
    # collapsed to their defaults)
    r.mnist.update({"lr": 0.03, "hidden": 100})
    return r


#: The global configuration tree.
root = _default_root()

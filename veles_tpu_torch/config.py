"""Auto-vivifying configuration tree (counterpart of
``veles_tpu/config.py``).

A global attribute tree ``root`` where any ``root.a.b.c = v`` path
springs into existence, with protected keys, deep ``update``, layered
overrides from a ``.py``/``.json`` file (``update_from_file``) and from
``VELES_TPU_CFG_*`` environment variables (``update_from_env``), and the
printable form ``--dump-config`` shows (``print_``). The port keeps only
the keys its ported slices read; unlike the reference it reads no site
or user override files.
"""

from __future__ import annotations

import json
import os
import runpy
import sys
from typing import Any, Dict, Iterator, Tuple

_PROTECTED = "_protected_"


class Config:
    """A node in the auto-vivifying config tree."""

    def __init__(self, path: str = "root") -> None:
        object.__setattr__(self, "_path_", path)
        object.__setattr__(self, _PROTECTED, set())

    def __getattr__(self, name: str) -> "Config":
        if name.startswith("__") and name.endswith("__"):
            raise AttributeError(name)
        child = Config("%s.%s" % (self._path_, name))
        object.__setattr__(self, name, child)
        return child

    def __setattr__(self, name: str, value: Any) -> None:
        if name in object.__getattribute__(self, _PROTECTED):
            raise AttributeError(
                "config key %s.%s is protected" % (self._path_, name))
        object.__setattr__(self, name, value)

    def protect(self, *names: str) -> None:
        """Forbid further assignment of the given child keys."""
        object.__getattribute__(self, _PROTECTED).update(names)

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

    def update_from_file(self, path: str) -> "Config":
        """Apply a ``.json`` file (deep-merged) or a ``.py`` file (run
        with ``root`` bound to this node)."""
        if path.endswith(".json"):
            with open(path, "r") as fin:
                self.update(json.load(fin))
        else:
            runpy.run_path(path, init_globals={"root": self})
        return self

    def update_from_env(self, prefix: str = "VELES_TPU_CFG_") -> "Config":
        """``VELES_TPU_CFG_ENGINE__FORCE_NUMPY=true`` sets
        ``engine.force_numpy``: path components are separated by a
        DOUBLE underscore, values parse as JSON where they can."""
        for key, val in os.environ.items():
            if not key.startswith(prefix):
                continue
            node = self
            *parents, leaf = key[len(prefix):].lower().split("__")
            for part in parents:
                node = getattr(node, part)
            try:
                val = json.loads(val)
            except ValueError:
                pass
            setattr(node, leaf, val)
        return self

    def as_dict(self) -> Dict[str, Any]:
        return {k: v.as_dict() if isinstance(v, Config) else v
                for k, v in self.items()}

    def print_(self, indent: int = 0, file=None) -> None:
        """Dump the tree, one ``key: repr(value)`` line per leaf."""
        file = file or sys.stdout
        for k, v in self.items():
            if isinstance(v, Config):
                print("%s%s:" % ("  " * indent, k), file=file)
                v.print_(indent + 1, file)
            else:
                print("%s%s: %r" % ("  " * indent, k, v), file=file)

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
            # where an ImageSaver given no directory writes
            "cache": os.path.expanduser("~/.veles_tpu/cache"),
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
            # the --backend default (backends.device_for_backend): "auto"
            # = the card; force_numpy = the reference's numpy device, which
            # here is the CPU
            "backend": "auto",
            "force_numpy": False,
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
            "max_pending": 64,        # RESTfulAPI in-flight bound
            # /healthz: a heartbeat older than this is unhealthy
            # (resilience/health.py)
            "heartbeat_timeout": 300.0,
        },
        # telemetry spans (telemetry/spans.py): THE switch, honored
        # centrally by the recorder, so it covers Unit.run,
        # workflow.run/initialize, the train step, the decoders and the
        # serving engines; the ring's capacity (the GET /trace/spans
        # pull window) and the JSONL sink's rotation size (0 = never);
        # ``requests`` gates the per-request lifecycle spans and flight
        # events (serving/scheduler.py) — the SLO histograms count
        # either way. The reference's defaults
        "trace": {"spans": True, "span_ring": 65536,
                  "rotate_bytes": 64 << 20, "requests": True},
        "telemetry": {
            # the flight recorder (telemetry/recorder.py): a bounded
            # ring of span closes, alarm-counter increments and request
            # events; autodump writes blackbox-<ts>_<pid>.jsonl on an
            # unhandled Workflow.run exception or SIGTERM; any single
            # counter increment of at least counter_threshold is also
            # recorded (0 = alarm counters only)
            "recorder": {"enabled": True, "capacity": 4096,
                         "autodump": False, "counter_threshold": 0},
        },
        # int8 serving (veles_tpu_torch/quant/), the reference's keys
        # and defaults: off, and the off path is the float engine's.
        # weights = per-channel int8 decode matmul weights dequantized
        # on read; kv = the int8 page pool with one scale a position;
        # granularity = per_channel (one scale an output column) or
        # per_tensor
        "quant": {
            "weights": False,
            "kv": False,
            "granularity": "per_channel",
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
            # request the pool cannot hold. spec_gamma is the pool's
            # speculation round width, beam_width its beam group width;
            # stream = False answers "stream": true requests buffered.
            # qos turns the QoS plane on (priority admission, batch
            # preemption while qos_preempt); drain_handoff makes a drain
            # hand in-flight requests back with their progress instead
            # of waiting out drain_grace. Not ported yet: the
            # reference's prefix_cache, prefill_chunk, artifact and tp
            # knobs (the engine raises for the ones it takes as
            # arguments)
            "engine": "continuous",
            "max_slots": 8,
            "buckets": [16, 32, 64, 128],
            "max_context": 640,
            "decode_block": 1,
            "page_size": 16,
            # None = the dense-equivalent max_slots x pages_per_slot
            "pages": None,
            "spec_gamma": 4,
            "beam_width": 4,
            "stream": True,
            "qos": False,
            "qos_preempt": True,
            "drain_handoff": True,
            # the O(1)-state lane (serving/recurrent.py, which
            # "continuous" falls back to for Embedding → LSTM/RNN/SSM →
            # LMHead stacks; "recurrent" pins it): its state-checkpoint
            # prefix cache, off by default as in the reference, and the
            # cache's soft block budget (None = unbounded)
            "state_cache": False,
            "state_cache_blocks": None,
        },
    })
    # models/mnist.py defaults (the reference's optimisable ranges
    # collapsed to their defaults)
    r.mnist.update({"lr": 0.03, "hidden": 100})
    r.common.update_from_env()
    return r


#: The global configuration tree.
root = _default_root()

"""Deterministic, seedable, keyed random streams (counterpart of
``veles_tpu/prng.py``).

Each named stream has a host side, a ``numpy.random.RandomState``
seeded exactly as the reference seeds it (the first four bytes of the
key's sha256, little-endian, XOR ``root.common.random_seed``), so the
port draws the reference's initial weights, synthetic data and shuffles
bit for bit from the same seed. The device side is a
``torch.Generator`` on the workflow's device (:meth:`torch_generator`);
it does not reproduce the reference's threefry bits.

A stream pickles to the reference's state schema (``__getstate__``):
``key``, ``_seed`` and the numpy side's ``RandomState.get_state()``
tuple, plus ``_torch_states``, {device: ``torch.Generator.get_state()``
as a numpy uint8 array}, the port's own key. The reference's dict loads
here with its ``_counter`` and ``_jax_root`` (threefry's) ignored, and
the port's loads into the reference, whose ``__setstate__`` keeps the
extra key as a plain attribute. A generator's state comes back only on
a device of its type: a CUDA generator's state only on a card, a CPU
one's only on the CPU. A stream asked for its generator on a device
whose state the snapshot does not hold (a card snapshot resumed on the
CPU, or the reverse) reseeds that generator from the stream's seed, with
a warning.
"""

from __future__ import annotations

import hashlib
import logging
import threading
from typing import Dict, Optional

import numpy
import torch

_lock = threading.Lock()
_generators: Dict[str, "RandomGenerator"] = {}
#: streams left out of snapshots (operational, not model state):
#: restoring them would replay e.g. the fault-injection die rolls after
#: every resume (the reference's ``_ephemeral``)
_ephemeral: set = {"fault_injection"}


class RandomGenerator:
    """Named random stream with a host (numpy) and a device (torch) side,
    both derived from one seed."""

    def __init__(self, key: str, seed: Optional[int] = None) -> None:
        self.key = key
        self.seed(seed if seed is not None else _default_seed(key))

    def seed(self, seed: int) -> None:
        """(Re)seed both sides."""
        self._seed = int(seed) & 0xFFFFFFFF
        self.state = numpy.random.RandomState(self._seed)
        self._torch: Dict[str, torch.Generator] = {}
        #: generator states restored from a snapshot, applied when the
        #: stream's generator on that device is first asked for
        self._torch_pending: Dict[str, numpy.ndarray] = {}

    @property
    def initial_seed(self) -> int:
        return self._seed

    # -- device side --------------------------------------------------------
    def torch_generator(self, device) -> torch.Generator:
        """The stream's ``torch.Generator`` on ``device`` ("cuda" is the
        current card's), made at first use: in the state a restored
        snapshot holds for that device, else seeded from the stream's
        seed."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        gen = self._torch.get(str(dev))
        if gen is None:
            gen = self._torch[str(dev)] = torch.Generator(device=dev)
            saved = self._torch_pending.pop(str(dev), None)
            if saved is not None:
                gen.set_state(torch.from_numpy(saved.copy()))
            else:
                gen.manual_seed(self._seed)
                if self._torch_pending:
                    logging.getLogger("prng").warning(
                        "stream %r: the snapshot holds its generator state "
                        "for %s, not for %s; that generator reseeds from "
                        "the stream's seed", self.key,
                        ", ".join(sorted(self._torch_pending)), dev)
        return gen

    # -- host side ----------------------------------------------------------
    def randint(self, low, high=None, size=None):
        return self.state.randint(low, high, size)

    def shuffle(self, arr) -> None:
        self.state.shuffle(arr)

    def permutation(self, n):
        return self.state.permutation(n)

    def rand(self, *shape):
        return self.state.rand(*shape)

    def normal(self, loc=0.0, scale=1.0, size=None):
        return self.state.normal(loc, scale, size)

    def fill_normal(self, arr, scale: float) -> None:
        arr[...] = self.state.normal(0.0, scale,
                                     arr.shape).astype(arr.dtype)

    # -- snapshots (the reference's state schema) ----------------------------
    def __getstate__(self):
        states = dict(self._torch_pending)
        states.update({dev: gen.get_state().numpy().copy()
                       for dev, gen in self._torch.items()})
        return {"key": self.key, "_seed": self._seed,
                "state": self.state.get_state(), "_torch_states": states}

    def __setstate__(self, d):
        self.key = d["key"]
        self._seed = int(d["_seed"])
        self.state = numpy.random.RandomState()
        self.state.set_state(d["state"])
        self._torch = {}
        self._torch_pending = {
            dev: numpy.asarray(st, dtype=numpy.uint8)
            for dev, st in (d.get("_torch_states") or {}).items()}


def _default_seed(key: str) -> int:
    from .config import root
    base = int(root.common.random_seed)
    h = int.from_bytes(hashlib.sha256(key.encode()).digest()[:4], "little")
    return (base ^ h) & 0xFFFFFFFF


def get(key: str = "default", ephemeral: bool = False) -> RandomGenerator:
    """The process-wide stream named ``key`` (created at first use);
    ``ephemeral`` leaves it out of snapshots."""
    with _lock:
        if ephemeral:
            _ephemeral.add(key)
        gen = _generators.get(key)
        if gen is None:
            gen = _generators[key] = RandomGenerator(key)
        return gen


def seed_all(seed: int) -> None:
    """Reseed every existing stream from one master seed; streams made
    later seed from it too."""
    from .config import root
    root.common.random_seed = int(seed)
    with _lock:
        for key, gen in _generators.items():
            gen.seed(_default_seed(key))

"""Deterministic, seedable, keyed random streams (counterpart of
``veles_tpu/prng.py``).

Each named stream has a host side, a ``numpy.random.RandomState``
seeded exactly as the reference seeds it (the first four bytes of the
key's sha256, little-endian, XOR ``root.common.random_seed``), so the
port draws the reference's initial weights, synthetic data and shuffles
bit for bit from the same seed. The device side is a
``torch.Generator`` on the workflow's device (:meth:`torch_generator`);
it does not reproduce the reference's threefry bits.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, Optional

import numpy
import torch

_lock = threading.Lock()
_generators: Dict[str, "RandomGenerator"] = {}


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

    @property
    def initial_seed(self) -> int:
        return self._seed

    # -- device side --------------------------------------------------------
    def torch_generator(self, device) -> torch.Generator:
        """The stream's ``torch.Generator`` on ``device``, seeded from the
        stream's seed at first use."""
        dev = torch.device(device)
        gen = self._torch.get(str(dev))
        if gen is None:
            gen = self._torch[str(dev)] = torch.Generator(device=dev)
            gen.manual_seed(self._seed)
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


def _default_seed(key: str) -> int:
    from .config import root
    base = int(root.common.random_seed)
    h = int.from_bytes(hashlib.sha256(key.encode()).digest()[:4], "little")
    return (base ^ h) & 0xFFFFFFFF


def get(key: str = "default") -> RandomGenerator:
    """The process-wide stream named ``key`` (created at first use)."""
    with _lock:
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

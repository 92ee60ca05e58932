"""Array: a host numpy mirror plus a ``torch.Tensor`` on an explicit
device, with explicit coherence (counterpart of ``veles_tpu/memory.py``).

The protocol tracks which side is newer:

- ``map_read()``        → make ``mem`` (numpy) current, copying
  device → host if the device side is newer;
- ``map_write()``       → the same, then mark the host side newer;
- ``map_invalidate()``  → the host will overwrite everything: no copy;
- ``assign_devmem(t)``  → a step produced a new device tensor; the device
  side becomes the newer one (no copy until someone reads);
- ``device_view(dev)``  → the tensor for compute on ``dev``, pushing the
  host data if it is newer or the cached tensor lies elsewhere.

The host side is a numpy array, or a CPU ``torch.Tensor`` for a dtype
numpy has not (a bfloat16 dataset, ``engine.dataset_dtype``); ``mem``
then is that tensor, and the protocol is the same.
"""

from __future__ import annotations

import threading
from typing import Any, Optional, Tuple

import numpy
import torch

from .error import Bug
from .logger import Logger


class Array(Logger):
    """Host/device tensor pair."""

    def __init__(self, data: Any = None, shape: Tuple[int, ...] = None,
                 dtype: Any = numpy.float32, name: str = "") -> None:
        super().__init__()
        self.name = name
        self._lock = threading.RLock()
        self.mem: Optional[numpy.ndarray] = None
        self.devmem: Optional[torch.Tensor] = None
        self._host_newer = False
        self._dev_newer = False
        if data is not None:
            self.reset(numpy.asarray(data))
        elif shape is not None:
            self.reset(numpy.zeros(shape, dtype=dtype))

    @property
    def shape(self):
        return self.mem.shape if self.mem is not None else None

    @property
    def dtype(self):
        return self.mem.dtype if self.mem is not None else None

    @property
    def nbytes(self) -> int:
        return self.mem.nbytes if self.mem is not None else 0

    def __bool__(self) -> bool:
        return self.mem is not None

    def __len__(self) -> int:
        return len(self.mem) if self.mem is not None else 0

    def reset(self, data: Optional[numpy.ndarray] = None) -> "Array":
        """(Re)bind host storage, dropping any device copy."""
        with self._lock:
            self.devmem = None
            self.mem = data
            self._host_newer = data is not None
            self._dev_newer = False
        return self

    def map_read(self) -> numpy.ndarray:
        with self._lock:
            if self._dev_newer:
                host = self.devmem.detach().cpu()
                if isinstance(self.mem, torch.Tensor):
                    host = host.to(self.mem.dtype)
                else:
                    host = host.numpy()
                    if self.mem is not None and host.dtype != self.mem.dtype:
                        host = host.astype(self.mem.dtype)
                self.mem = host
                self._dev_newer = False
            return self.mem

    def map_write(self) -> numpy.ndarray:
        mem = self.map_read()
        with self._lock:
            self._host_newer = True
        return mem

    def map_invalidate(self) -> numpy.ndarray:
        with self._lock:
            self._dev_newer = False
            self._host_newer = True
            return self.mem

    def detach_devmem(self) -> None:
        """Forget the device copy, keeping the host mirror canonical: the
        train step owns the device tensors from here on."""
        with self._lock:
            if self._dev_newer:
                self.map_read()
            self.devmem = None
            self._host_newer = self.mem is not None

    def assign_devmem(self, devmem: torch.Tensor) -> None:
        """Adopt a device tensor a step produced."""
        with self._lock:
            self.devmem = devmem
            self._dev_newer = True
            self._host_newer = False

    def device_view(self, device=None) -> torch.Tensor:
        """The tensor on ``device`` (default: wherever the cached copy
        is, else the CPU), pushing host data if it is newer. The host
        buffer is copied, never aliased: the loader rewrites its plan
        buffers in place while an earlier step may still read them."""
        with self._lock:
            want = torch.device(device) if device is not None else None
            stale = (self.devmem is not None and want is not None
                     and self.devmem.device != want)
            if stale and self._dev_newer:
                self.map_read()
            if self.devmem is None or self._host_newer or stale:
                if self.mem is None:
                    raise Bug("Array %s: device_view before reset"
                              % self.name)
                target = want or torch.device("cpu")
                host = (self.mem.clone() if isinstance(self.mem, torch.Tensor)
                        else torch.from_numpy(numpy.array(self.mem)))
                self.devmem = host.to(target)
                self._host_newer = False
            return self.devmem

    def __repr__(self) -> str:
        return "<Array %r %s %s host_newer=%s dev_newer=%s>" % (
            self.name, self.shape, self.dtype, self._host_newer,
            self._dev_newer)

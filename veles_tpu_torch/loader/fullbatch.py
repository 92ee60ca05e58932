"""Full-batch loaders: the whole dataset in memory, and on the device
for fused steps (counterpart of ``veles_tpu/loader/fullbatch.py``).

The dataset (and, for :class:`FullBatchLoaderMSE`, the row-aligned
targets) is placed on the workflow's device once; a fused ``TrainStep``
gathers each minibatch's rows there by plan index, so no sample crosses
from the host per step. Integer arrays (token ids) keep their dtype; float
arrays take ``engine.dataset_dtype`` when it is set (bfloat16 halves the
dataset's device memory), else ``engine.precision_type``. numpy has no
bfloat16, so a bfloat16 array is kept as a CPU torch tensor
(``memory.Array`` takes one as its host side).
"""

from __future__ import annotations

from typing import Optional

import numpy
import torch

from ..config import root
from ..memory import Array
from .base import TRAIN, VALID, Loader, LoaderMSE


def _storage_dtype(arr: numpy.ndarray):
    """The reference's storage policy: integer arrays (token ids) keep
    their dtype — a float policy would corrupt large ids; float arrays
    take ``engine.dataset_dtype`` when it is set, else the param policy
    dtype ``engine.precision_type``."""
    if numpy.issubdtype(arr.dtype, numpy.integer):
        return arr.dtype
    return (root.common.engine.get("dataset_dtype", None)
            or root.common.engine.precision_type)


def _stored(arr: numpy.ndarray):
    """``arr`` contiguous in its storage dtype: a numpy array, or a CPU
    torch tensor for bfloat16."""
    dtype = _storage_dtype(arr)
    if str(dtype) in ("bfloat16", "torch.bfloat16"):
        return torch.from_numpy(numpy.ascontiguousarray(
            arr, dtype=numpy.float32)).to(torch.bfloat16)
    return numpy.ascontiguousarray(arr, dtype=dtype)


def _zeros(shape, dtype):
    """A host buffer of a stored array's dtype (numpy or torch)."""
    if isinstance(dtype, torch.dtype):
        return torch.zeros(shape, dtype=dtype)
    return numpy.zeros(shape, dtype=dtype)


class FullBatchLoader(Loader):
    """Subclasses fill ``original_data``/``original_labels`` in
    ``load_data`` (``create_originals``) and set ``class_lengths``."""

    hide_from_registry = True

    def __init__(self, workflow, validation_ratio=None, **kwargs):
        super().__init__(workflow, **kwargs)
        self.original_data = Array(name=self.name + ".original_data")
        self.original_labels = Array(name=self.name + ".original_labels")
        #: a validation share carved from the train rows by the file
        #: loaders that have no validation set (resize_validation)
        self.validation_ratio = validation_ratio

    def create_originals(self, data: numpy.ndarray,
                         labels: Optional[numpy.ndarray] = None) -> None:
        self.original_data.reset(_stored(numpy.asarray(data)))
        if labels is not None:
            self.original_labels.reset(
                numpy.ascontiguousarray(labels, dtype=numpy.int32))

    def resize_validation(self, ratio: float) -> None:
        """Carve a random validation subset out of the train region: the
        train rows are permuted first (from the loader's stream, as the
        reference does), and every row-aligned array follows them."""
        n_train = self.class_lengths[TRAIN]
        n_valid = int(n_train * ratio)
        start = self.class_lengths[0] + self.class_lengths[VALID]
        perm = start + self.prng.permutation(n_train)
        for arr in (self.original_data, self.original_labels,
                    getattr(self, "original_targets", None)):
            if arr is not None and arr:
                arr.mem[start:] = arr.mem[perm]
        self.class_lengths[VALID] += n_valid
        self.class_lengths[TRAIN] -= n_valid

    def create_minibatch_data(self) -> None:
        n = self.max_minibatch_size
        self.minibatch_data.reset(_zeros(
            (n,) + tuple(self.original_data.shape[1:]),
            self.original_data.dtype))
        if self.original_labels:
            self.minibatch_labels.reset(numpy.zeros(n, dtype=numpy.int32))

    def fill_minibatch(self) -> None:
        idx = self.minibatch_indices.mem
        self.minibatch_data.map_invalidate()[...] = \
            self.original_data.mem[idx]
        if self.original_labels:
            self.minibatch_labels.map_invalidate()[...] = \
                self.original_labels.mem[idx]

    def fetch_batch(self, idx, size):
        """The pure mirror of :meth:`fill_minibatch` (fancy indexing
        copies); a subclass with its own fill opts out (None)."""
        if type(self).fill_minibatch not in (
                FullBatchLoader.fill_minibatch,
                FullBatchLoaderMSE.fill_minibatch):
            return None
        out = {"data": self.original_data.mem[idx]}
        if self.original_labels:
            out["labels"] = self.original_labels.mem[idx]
        return out


class FullBatchLoaderMSE(FullBatchLoader, LoaderMSE):
    """Full-batch loader with row-aligned targets (``original_targets``,
    served as ``minibatch_targets``): a language model's (N, T) int32
    next-token targets beside its (N, T) int32 token rows."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.original_targets = Array(name=self.name + ".original_targets")

    def create_originals(self, data, labels=None, targets=None):
        super().create_originals(data, labels)
        if targets is not None:
            self.original_targets.reset(_stored(numpy.asarray(targets)))

    def create_minibatch_data(self) -> None:
        super().create_minibatch_data()
        if self.original_targets:
            n = self.max_minibatch_size
            self.minibatch_targets.reset(_zeros(
                (n,) + tuple(self.original_targets.shape[1:]),
                self.original_targets.dtype))

    def fill_minibatch(self) -> None:
        super().fill_minibatch()
        if self.original_targets:
            self.minibatch_targets.map_invalidate()[...] = \
                self.original_targets.mem[self.minibatch_indices.mem]

    def fetch_batch(self, idx, size):
        out = super().fetch_batch(idx, size)
        if out is not None and self.original_targets:
            out["targets"] = self.original_targets.mem[idx]
        return out

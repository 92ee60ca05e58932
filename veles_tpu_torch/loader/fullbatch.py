"""Full-batch loader: the whole dataset in memory, and on the device
for fused steps (counterpart of ``veles_tpu/loader/fullbatch.py``).

The dataset is placed on the workflow's device once; a fused
``TrainStep`` gathers each minibatch's rows there by plan index, so no
sample crosses from the host per step.
"""

from __future__ import annotations

from typing import Optional

import numpy

from ..config import root
from ..memory import Array
from .base import Loader


class FullBatchLoader(Loader):
    """Subclasses fill ``original_data``/``original_labels`` in
    ``load_data`` (``create_originals``) and set ``class_lengths``."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.original_data = Array(name=self.name + ".original_data")
        self.original_labels = Array(name=self.name + ".original_labels")

    def create_originals(self, data: numpy.ndarray,
                         labels: Optional[numpy.ndarray] = None) -> None:
        data = numpy.asarray(data)
        dtype = (data.dtype if numpy.issubdtype(data.dtype, numpy.integer)
                 else root.common.engine.precision_type)
        self.original_data.reset(numpy.ascontiguousarray(data, dtype=dtype))
        if labels is not None:
            self.original_labels.reset(
                numpy.ascontiguousarray(labels, dtype=numpy.int32))

    def create_minibatch_data(self) -> None:
        n = self.max_minibatch_size
        self.minibatch_data.reset(numpy.zeros(
            (n,) + tuple(self.original_data.shape[1:]),
            dtype=self.original_data.dtype))
        if self.original_labels:
            self.minibatch_labels.reset(numpy.zeros(n, dtype=numpy.int32))

    def fill_minibatch(self) -> None:
        idx = self.minibatch_indices.mem
        self.minibatch_data.map_invalidate()[...] = \
            self.original_data.mem[idx]
        if self.original_labels:
            self.minibatch_labels.map_invalidate()[...] = \
                self.original_labels.mem[idx]

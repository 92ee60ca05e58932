"""Loader base: the minibatch-serving contract (counterpart of
``veles_tpu/loader/base.py``).

Three sample sets are served per epoch in the fixed order TEST →
VALIDATION → TRAIN, with the train tail reshuffled every epoch from the
loader's keyed stream (bit-identical to the reference for the same
seed). Minibatches have a static size; a short tail is padded with its
last valid index and carries a validity mask, so a padded row is inert.

Fused consumption (what ``TrainStep`` sets before ``initialize``): the
host gathers no data (``fused``), serves up to ``plan_steps``
minibatches of one class per run as a ``(K, mb)`` int32 index plan
with an f32 mask, or, with ``block_epochs`` = H > 1, H whole epochs per
run as per-class ``(H, K_c, mb)`` plans. The dataset itself lives on
the device and the step gathers the rows.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy

from ..error import Bug, NoMoreJobs
from ..memory import Array
from ..mutable import Bool
from ..units import Unit
from .. import prng

TEST, VALID, TRAIN = 0, 1, 2
CLASS_NAMES = ("test", "validation", "train")


class Loader(Unit):
    """Minibatch server."""

    hide_from_registry = True

    def __init__(self, workflow, minibatch_size=100, shuffle_limit=None,
                 **kwargs):
        super().__init__(workflow, **kwargs)
        self.view_group = "LOADER"
        self.max_minibatch_size = int(minibatch_size)
        #: samples per class: [test, validation, train]
        self.class_lengths: List[int] = [0, 0, 0]
        self.epoch_number = 0
        self.shuffle_limit = (numpy.inf if shuffle_limit is None
                              else shuffle_limit)
        self.epoch_ended = Bool(False)
        self.last_minibatch = Bool(False)
        self.train_ended = Bool(False)
        self.test_ended = Bool(False)
        self.minibatch_data = Array(name=self.name + ".minibatch_data")
        self.minibatch_labels = Array(name=self.name + ".minibatch_labels")
        self.minibatch_indices = Array(name=self.name + ".minibatch_indices")
        self.minibatch_mask = Array(name=self.name + ".minibatch_mask")
        self.minibatch_class = TRAIN
        self.minibatch_size = 0          # valid samples in this minibatch
        self.minibatch_offset = 0
        #: minibatches served per run as one (K, mb) plan
        self.plan_steps = 1
        #: valid rows of the current plan
        self.plan_length = 1
        #: True: a fused step gathers on the device; no host fill
        self.fused = False
        #: whole epochs served per run as per-class (H, K_c, mb) plans
        self.block_epochs = 1
        #: {class: (idx Array (H, K_c, mb) int32, mask Array f32)}
        self.block_plans: Dict[int, tuple] = {}
        #: hard epoch cap (Decision.max_epochs): the final block clamps
        #: to the epochs remaining under it
        self.block_epochs_cap: Optional[int] = None
        #: epochs served by the last serve_epoch_block
        self.block_length = 0
        self._global_offset = 0
        self._shuffled_indices: Optional[numpy.ndarray] = None
        self.samples_served = 0
        self.prng = prng.get(self.name)

    # -- subclass contract ---------------------------------------------------
    def load_data(self) -> None:
        """Populate class_lengths (and the dataset). Called at init."""
        raise NotImplementedError

    def create_minibatch_data(self) -> None:
        """Allocate minibatch_data/labels with static shapes."""
        raise NotImplementedError

    def fill_minibatch(self) -> None:
        """Copy samples minibatch_indices → minibatch_data/labels."""
        raise NotImplementedError

    # -- geometry ------------------------------------------------------------
    @property
    def total_samples(self) -> int:
        return int(sum(self.class_lengths))

    @property
    def class_end_offsets(self) -> List[int]:
        ends, acc = [], 0
        for n in self.class_lengths:
            acc += n
            ends.append(acc)
        return ends

    def class_of_offset(self, offset: int) -> int:
        for idx, end in enumerate(self.class_end_offsets):
            if offset < end:
                return idx
        raise NoMoreJobs("offset %d beyond %d samples" %
                         (offset, self.total_samples))

    def plan_rows_for(self, cls: int) -> int:
        """Static plan height of one class: ceil(len / mb)."""
        n = self.class_lengths[cls]
        mb = self.max_minibatch_size
        return -(-n // mb) if n else 0

    # -- lifecycle -----------------------------------------------------------
    def initialize(self, **kwargs):
        res = super().initialize(**kwargs)
        if res:
            return res
        self.load_data()
        if self.total_samples == 0:
            raise NoMoreJobs("loader %s has no samples" % self.name)
        self._shuffled_indices = numpy.arange(self.total_samples,
                                              dtype=numpy.int32)
        self.shuffle()
        self.create_minibatch_data()
        n = self.max_minibatch_size
        if self.plan_steps > 1:
            # rows past a class boundary are mask-zero dead compute:
            # clamp the plan to the tallest class
            tallest = max((self.plan_rows_for(c) for c in range(3)
                           if self.class_lengths[c]), default=1)
            if tallest < self.plan_steps:
                self.info("%s: plan_steps clamped %d -> %d (tallest "
                          "class plan)", self.name, self.plan_steps,
                          tallest)
                self.plan_steps = tallest
        k = self.plan_steps
        if k > 1 and not self.fused:
            raise Bug("plan_steps>1 requires a fused consumer (host "
                      "fill_minibatch cannot batch plans)")
        shape = (k, n) if k > 1 else (n,)
        self.minibatch_indices.reset(numpy.zeros(shape, dtype=numpy.int32))
        self.minibatch_mask.reset(numpy.zeros(shape, dtype=numpy.float32))
        self.info("%s: %d samples (test=%d validation=%d train=%d), mb=%d",
                  self.name, self.total_samples, *self.class_lengths, n)
        return None

    def shuffle(self) -> None:
        """Shuffle only the train tail of the index order."""
        if self.class_lengths[TRAIN] == 0:
            return
        if self.epoch_number > self.shuffle_limit:
            return
        start = self.class_end_offsets[VALID]
        self.prng.shuffle(self._shuffled_indices[start:])

    # -- the serving loop ----------------------------------------------------
    def run(self) -> None:
        if self.block_epochs > 1:
            self.serve_epoch_block()
        elif self.plan_steps > 1:
            self.serve_plan()
        else:
            self.serve_next_minibatch()

    def _begin_serving(self) -> None:
        if bool(self.epoch_ended):
            self.epoch_number += 1
            self._global_offset = 0
            self.shuffle()
        self.epoch_ended <<= False
        self.last_minibatch <<= False
        self.train_ended <<= False
        self.test_ended <<= False

    def _next_geometry(self):
        """(offset, class, valid size) of the next minibatch."""
        offset = self._global_offset
        cls = self.class_of_offset(offset)
        return offset, cls, min(self.max_minibatch_size,
                                self.class_end_offsets[cls] - offset)

    def _fill_row(self, idx_row, mask_row, offset, size) -> None:
        """One index row, tail-padded with the last valid index, and its
        validity mask."""
        src = self._shuffled_indices
        idx_row[:size] = src[offset:offset + size]
        idx_row[size:] = idx_row[size - 1] if size else 0
        mask_row[:size] = 1.0
        mask_row[size:] = 0.0

    def _advance(self, cls, size) -> None:
        """Move the global offset and update the flags."""
        self.samples_served += size
        self._global_offset += size
        if self._global_offset >= self.class_end_offsets[cls]:
            if cls == TEST:
                self.test_ended <<= True
            if cls == TRAIN:
                self.train_ended <<= True
        if self._global_offset >= self.total_samples:
            self.last_minibatch <<= True
            self.epoch_ended <<= True

    def serve_next_minibatch(self) -> None:
        self._begin_serving()
        offset, cls, size = self._next_geometry()
        self.minibatch_offset = offset
        self.minibatch_class = cls
        self.minibatch_size = size
        self._fill_row(self.minibatch_indices.map_invalidate(),
                       self.minibatch_mask.map_invalidate(), offset, size)
        if not self.fused:
            self.fill_minibatch()
        self._advance(cls, size)

    def serve_plan(self) -> None:
        """Up to plan_steps minibatches of ONE class as a (plan_steps, mb)
        index/mask plan; unused rows are mask-zero. Stops at class and
        epoch boundaries so the Decision's flags stay exact."""
        self._begin_serving()
        idx = self.minibatch_indices.map_invalidate()
        mask = self.minibatch_mask.map_invalidate()
        first_cls = None
        k = 0
        while k < self.plan_steps:
            if self._global_offset >= self.total_samples:
                break
            offset, cls, size = self._next_geometry()
            if first_cls is None:
                first_cls = cls
                self.minibatch_offset = offset
            elif cls != first_cls:
                break
            self._fill_row(idx[k], mask[k], offset, size)
            self._advance(cls, size)
            k += 1
        mask[k:] = 0.0
        idx[k:] = 0
        self.minibatch_class = first_cls if first_cls is not None else TRAIN
        self.plan_length = k
        self.minibatch_size = int(mask.sum())

    def serve_epoch_block(self) -> None:
        """``block_epochs`` whole epochs as per-class stacked plans: for
        each class with samples, (H, K_c, mb) indices and mask, in the
        classic loop's offset order within each epoch; the flags and
        counters advance as if the epochs were served one by one."""
        if not self.fused:
            raise Bug("serve_epoch_block requires a fused consumer")
        h = self.block_epochs
        if self.block_epochs_cap is not None:
            completed = self.epoch_number + (1 if bool(self.epoch_ended)
                                             else 0)
            h = max(1, min(h, self.block_epochs_cap - completed))
        mb = self.max_minibatch_size
        if not self.block_plans:
            for cls in (TEST, VALID, TRAIN):
                rows = self.plan_rows_for(cls)
                if not rows:
                    continue
                shape = (h, rows, mb)
                self.block_plans[cls] = (
                    Array(numpy.zeros(shape, numpy.int32),
                          name="%s.block_idx%d" % (self.name, cls)),
                    Array(numpy.zeros(shape, numpy.float32),
                          name="%s.block_mask%d" % (self.name, cls)))
        self.block_length = h
        views = {cls: (idx.map_invalidate(), mask.map_invalidate())
                 for cls, (idx, mask) in self.block_plans.items()}
        for e in range(h):
            self._begin_serving()
            rows_done = {cls: 0 for cls in views}
            while self._global_offset < self.total_samples:
                offset, cls, size = self._next_geometry()
                idx, mask = views[cls]
                k = rows_done[cls]
                self._fill_row(idx[e, k], mask[e, k], offset, size)
                rows_done[cls] = k + 1
                self._advance(cls, size)
        self.minibatch_class = TRAIN
        self.plan_length = self.plan_rows_for(TRAIN)
        self.minibatch_size = mb

    # -- snapshots (the reference's schema) ---------------------------------
    def state_dict(self):
        return {
            "epoch_number": self.epoch_number,
            "global_offset": self._global_offset,
            "class_lengths": list(self.class_lengths),
            "shuffled_indices": (None if self._shuffled_indices is None
                                 else numpy.array(self._shuffled_indices)),
            "samples_served": self.samples_served,
            "flags": {"epoch_ended": bool(self.epoch_ended),
                      "last_minibatch": bool(self.last_minibatch),
                      "train_ended": bool(self.train_ended),
                      "test_ended": bool(self.test_ended)},
        }

    def load_state_dict(self, sd) -> None:
        """The served position; the next epoch's shuffle continues from
        the restored index order and the restored ``prng`` stream."""
        self.epoch_number = sd["epoch_number"]
        self._global_offset = sd["global_offset"]
        if "class_lengths" in sd:
            self.class_lengths = list(sd["class_lengths"])
        if sd["shuffled_indices"] is not None:
            self._shuffled_indices = numpy.array(sd["shuffled_indices"])
        self.samples_served = sd["samples_served"]
        flags = sd["flags"]
        self.epoch_ended <<= flags["epoch_ended"]
        self.last_minibatch <<= flags["last_minibatch"]
        self.train_ended <<= flags["train_ended"]
        self.test_ended <<= flags["test_ended"]

    def get_metric_values(self) -> Dict[str, object]:
        return {"epochs_served": self.epoch_number,
                "samples_served": self.samples_served}


class LoaderMSE(Loader):
    """Loader with targets instead of (or beside) integer labels: the
    (B, T) next-token targets of a language model, or regression
    targets."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.minibatch_targets = Array(name=self.name + ".minibatch_targets")

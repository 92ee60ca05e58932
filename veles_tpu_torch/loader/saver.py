"""Minibatch record and replay (counterpart of
``veles_tpu/loader/saver.py``): a :class:`MinibatchesSaver` linked after
a loader records every served minibatch (data, labels, class, size) into
one gzip stream of pickles; :class:`MinibatchesLoader` replays that file
as a full-batch loader, a preprocessed pipeline without the original
dataset. The file format is the reference's (magic ``VTMB1``), so either
package reads the other's files.
"""

from __future__ import annotations

import gzip
import pickle
from typing import Optional

import numpy

from ..error import VelesError
from ..units import Unit
from .base import Loader
from .fullbatch import FullBatchLoader

MAGIC = b"VTMB1\n"


def _host(rows):
    """Served rows as a numpy array (a bfloat16 dataset widened)."""
    if hasattr(rows, "numpy"):
        return rows.float().numpy().copy()
    return numpy.array(rows)


class MinibatchesSaver(Unit):
    """Link after a loader: records each minibatch as it is served;
    :meth:`stop` closes the file. A fused loader's rows are gathered
    from its dataset by the served index plan."""

    MAPPING = "minibatches_saver"

    def __init__(self, workflow, file_name: str = "minibatches.vtmb",
                 **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.view_group = "SERVICE"
        self.file_name = file_name
        self.loader: Optional[Loader] = None
        self._fout = None
        self._count = 0

    def initialize(self, **kwargs):
        res = super().initialize(**kwargs)
        if res:
            return res
        if self.loader is None:
            raise VelesError("%s needs .loader set" % self.name)
        self._fout = gzip.open(self.file_name, "wb")
        self._fout.write(MAGIC)
        self._count = 0
        return None

    def run(self) -> None:
        ld = self.loader
        if ld.fused:
            # fused loaders never fill minibatch_data on host; gather the
            # served rows from the originals via the index plan
            idx = ld.minibatch_indices.mem
            mask = ld.minibatch_mask.mem
            rows = idx.reshape(1, -1) if idx.ndim == 1 else idx
            mrows = mask.reshape(1, -1) if mask.ndim == 1 else mask
            for k in range(getattr(ld, "plan_length", 1) or 1):
                size = int(mrows[k].sum())
                if not size:
                    continue
                sel = rows[k][:size]
                self._dump({
                    "class": ld.minibatch_class, "size": size,
                    "data": _host(ld.original_data.mem[sel]),
                    "labels": (numpy.array(ld.original_labels.mem[sel])
                               if ld.original_labels else None)})
            return
        self._dump({
            "class": ld.minibatch_class,
            "size": ld.minibatch_size,
            "data": _host(ld.minibatch_data.mem[:ld.minibatch_size]),
            "labels": (numpy.array(
                ld.minibatch_labels.mem[:ld.minibatch_size])
                if ld.minibatch_labels else None),
        })

    def _dump(self, rec) -> None:
        pickle.dump(rec, self._fout, protocol=pickle.HIGHEST_PROTOCOL)
        self._count += 1

    def stop(self) -> None:
        if self._fout is not None:
            self._fout.close()
            self._fout = None
            self.info("saved %d minibatches → %s", self._count,
                      self.file_name)


class MinibatchesLoader(FullBatchLoader):
    """Replays a MinibatchesSaver file as a full-batch loader: the
    records of each class, concatenated in file order, are its dataset,
    which a fused step gathers on the device like any other."""

    MAPPING = "minibatches_loader"

    def __init__(self, workflow, file_name: str = "minibatches.vtmb",
                 **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.file_name = file_name

    def load_data(self) -> None:
        per_class = {0: ([], []), 1: ([], []), 2: ([], [])}
        with gzip.open(self.file_name, "rb") as fin:
            if fin.read(len(MAGIC)) != MAGIC:
                raise VelesError("%s is not a minibatches file"
                                 % self.file_name)
            while True:
                try:
                    rec = pickle.load(fin)
                except EOFError:
                    break
                datas, labels = per_class[rec["class"]]
                datas.append(rec["data"])
                if rec["labels"] is not None:
                    labels.append(rec["labels"])
        datas, labelss, lengths = [], [], [0, 0, 0]
        for cls in (0, 1, 2):
            d, l = per_class[cls]
            if not d:
                continue
            data = numpy.concatenate(d)
            datas.append(data)
            if l:
                labelss.append(numpy.concatenate(l))
            lengths[cls] = len(data)
        if not datas:
            raise VelesError("%s holds no minibatches" % self.file_name)
        self.create_originals(
            numpy.concatenate(datas),
            numpy.concatenate(labelss) if labelss else None)
        self.class_lengths = lengths

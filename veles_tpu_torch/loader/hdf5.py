"""HDF5Loader: datasets stored in HDF5 files (counterpart of
``veles_tpu/loader/hdf5.py``): per-class files, each with a "data" and
(optionally) a "labels" dataset. It needs ``h5py``, and raises a
VelesError that names it where ``h5py`` is missing.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy

from ..error import VelesError
from .base import TEST, VALID, TRAIN
from .fullbatch import FullBatchLoader


class HDF5Loader(FullBatchLoader):
    """``files``: 3-sequence (test, validation, train) of .h5/.hdf5 paths,
    None for absent classes; ``data_key``/``labels_key`` name the datasets
    inside each file."""

    MAPPING = "hdf5_loader"

    def __init__(self, workflow, files: Sequence[Optional[str]] = (),
                 data_key: str = "data", labels_key: str = "labels",
                 **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        if len(files) != 3:
            raise VelesError(
                "files must be (test, validation, train) paths")
        self.files = list(files)
        self.data_key = data_key
        self.labels_key = labels_key

    def load_data(self) -> None:
        try:
            import h5py
        except ImportError as exc:
            raise VelesError("HDF5Loader needs h5py: %s" % exc)
        datas, labelss, lengths = [], [], [0, 0, 0]
        have_labels = None
        for cls in (TEST, VALID, TRAIN):
            path = self.files[cls]
            if not path:
                continue
            with h5py.File(path, "r") as fin:
                if self.data_key not in fin:
                    raise VelesError("%s has no %r dataset"
                                     % (path, self.data_key))
                data = numpy.asarray(fin[self.data_key])
                labels = (numpy.asarray(fin[self.labels_key])
                          if self.labels_key in fin else None)
            if have_labels is None:
                have_labels = labels is not None
            elif have_labels != (labels is not None):
                raise VelesError(
                    "inconsistent %r presence across class files"
                    % self.labels_key)
            if labels is not None:
                if len(labels) != len(data):
                    raise VelesError("%s: %d labels for %d samples"
                                     % (path, len(labels), len(data)))
                labelss.append(labels)
            datas.append(data)
            lengths[cls] = len(data)
        self.create_originals(
            numpy.concatenate(datas),
            numpy.concatenate(labelss) if labelss else None)
        self.class_lengths = lengths
        if self.validation_ratio and not lengths[VALID]:
            self.resize_validation(self.validation_ratio)

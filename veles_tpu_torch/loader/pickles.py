"""PicklesLoader: datasets stored as pickle files (counterpart of
``veles_tpu/loader/pickles.py``): one pickle per class position (test,
validation, train), each an array, a (data, labels) pair or a dict with
"data" and "labels"; a missing class is empty.

The files are read with ``pickle.load``: load only pickles you trust.
"""

from __future__ import annotations

import pickle
from typing import Optional, Sequence

import numpy

from ..error import VelesError
from .base import TEST, VALID, TRAIN
from .fullbatch import FullBatchLoader


def _load_one(path: str):
    with open(path, "rb") as fin:
        obj = pickle.load(fin)
    if isinstance(obj, (tuple, list)) and len(obj) == 2:
        data, labels = obj
        return numpy.asarray(data), numpy.asarray(labels)
    if isinstance(obj, dict):
        return (numpy.asarray(obj["data"]),
                numpy.asarray(obj["labels"]) if "labels" in obj else None)
    return numpy.asarray(obj), None


class PicklesLoader(FullBatchLoader):
    """``files`` is a 3-sequence (test, validation, train) of pickle paths
    (None/"" = class absent), mirroring the reference's per-class file
    list."""

    MAPPING = "pickles_loader"

    def __init__(self, workflow, files: Sequence[Optional[str]] = (),
                 **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        if len(files) != 3:
            raise VelesError(
                "files must be (test, validation, train) paths")
        self.files = list(files)

    def load_data(self) -> None:
        datas, labelss, lengths = [], [], [0, 0, 0]
        have_labels = None
        for cls in (TEST, VALID, TRAIN):
            path = self.files[cls]
            if not path:
                continue
            data, labels = _load_one(path)
            if have_labels is None:
                have_labels = labels is not None
            elif have_labels != (labels is not None):
                raise VelesError("inconsistent labels across classes")
            datas.append(data)
            if labels is not None:
                if len(labels) != len(data):
                    raise VelesError("%s: %d labels for %d samples"
                                     % (path, len(labels), len(data)))
                labelss.append(labels)
            lengths[cls] = len(data)
        self.create_originals(
            numpy.concatenate(datas),
            numpy.concatenate(labelss) if labelss else None)
        self.class_lengths = lengths
        if self.validation_ratio and not lengths[VALID]:
            self.resize_validation(self.validation_ratio)

"""EnsembleLoader: member predictions as a dataset (counterpart of
``veles_tpu/loader/ensemble.py``): reads the per-member outputs listed in
an ensemble run's outputs manifest (JSON ``{"outputs": [npy, ...],
"labels": npy}``) and serves them, concatenated along the class axis, as
the training set of a stacking combiner.
"""

from __future__ import annotations

import json

import numpy

from ..error import VelesError
from .base import TRAIN
from .fullbatch import FullBatchLoader


class EnsembleLoader(FullBatchLoader):
    """``manifest``: path of the outputs JSON ({"outputs": [npy, ...],
    "labels": npy}); features = member probabilities concatenated along
    the class axis."""

    MAPPING = "ensemble_loader"

    def __init__(self, workflow, manifest: str = "", **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.manifest = manifest

    def load_data(self) -> None:
        with open(self.manifest) as fin:
            man = json.load(fin)
        outputs = man.get("outputs", [])
        if not outputs:
            raise VelesError("%s lists no member outputs" % self.manifest)
        probs = [numpy.load(p) for p in outputs]
        shapes = {p.shape for p in probs}
        if len(shapes) != 1:
            raise VelesError("member output shapes differ: %s"
                             % sorted(shapes))
        data = numpy.concatenate(probs, axis=1)
        labels = (numpy.load(man["labels"])
                  if man.get("labels") else None)
        self.create_originals(data, labels)
        self.class_lengths = [0, 0, len(data)]
        if self.validation_ratio:
            self.resize_validation(self.validation_ratio)

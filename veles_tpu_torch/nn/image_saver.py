"""ImageSaver: dump the samples a model got wrong as PNGs (counterpart
of ``veles_tpu/nn/image_saver.py``; unit type "image_saver").

One directory per true class, the truth and the prediction in each file
name. The PNGs are written with Pillow, as the reference writes them;
where Pillow is not installed, writing raises a ``VelesError`` that names
it rather than skipping the file.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import numpy
import torch

from ..config import root
from ..error import VelesError
from ..units import Unit


class ImageSaver(Unit):
    """Saves up to ``limit`` wrong samples per run. Wire it after the
    evaluator::

        saver = ImageSaver(wf, out_dir=...)
        saver.link_attrs(loader, ("input", "minibatch_data"),
                         ("labels", "minibatch_labels"))
        saver.link_attrs(evaluator, ("output", "output"))

    It reads the minibatch buffers as they are when it runs, so it runs
    in line, never deferred."""

    MAPPING = "image_saver"
    hide_from_registry = False

    def __init__(self, workflow, out_dir: Optional[str] = None,
                 limit: int = 64, only_wrong: bool = True,
                 **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.view_group = "SERVICE"
        self.out_dir = out_dir or os.path.join(root.common.dirs.cache,
                                               "image_saver")
        self.limit = int(limit)
        self.only_wrong = only_wrong
        self.input = None       # minibatch data (B, ...) floats
        self.labels = None      # (B,) int truth
        self.output = None      # (B, classes) predictions
        self.saved_count = 0
        self.demand("input", "output", "labels")

    def reset_epoch(self) -> None:
        """Clear the directory and the counter (linked from the decision
        at an epoch's end)."""
        self.saved_count = 0
        if os.path.isdir(self.out_dir):
            shutil.rmtree(self.out_dir)

    @staticmethod
    def _to_image(sample: numpy.ndarray) -> numpy.ndarray:
        img = numpy.asarray(sample, dtype=numpy.float32)
        if img.ndim == 1:           # flat: square if it can be
            side = int(round(img.shape[0] ** 0.5))
            if side * side == img.shape[0]:
                img = img.reshape(side, side)
            else:
                img = img[None, :]
        lo, hi = float(img.min()), float(img.max())
        scaled = (img - lo) / (hi - lo) if hi > lo else img * 0
        return (scaled * 255).astype(numpy.uint8)

    def run(self) -> None:
        if self.saved_count >= self.limit:
            return
        data = self._read(self.input)
        labels = self._read(self.labels).astype(int)
        out = self._read(self.output)
        preds = (out.argmax(axis=1) if out.ndim > 1
                 else out.astype(int))
        n = min(len(data), len(labels), len(preds))
        for i in range(n):
            if self.saved_count >= self.limit:
                break
            truth, pred = int(labels[i]), int(preds[i])
            if self.only_wrong and truth == pred:
                continue
            sub = os.path.join(self.out_dir, str(truth))
            os.makedirs(sub, exist_ok=True)
            fname = "%05d_truth%d_pred%d.png" % (self.saved_count, truth,
                                                 pred)
            self._write_png(self._to_image(data[i]),
                            os.path.join(sub, fname))
            self.saved_count += 1

    @staticmethod
    def _read(arr) -> numpy.ndarray:
        """An Array, tensor or array as a host numpy array (a bf16
        tensor widened to float32)."""
        if hasattr(arr, "map_read"):
            arr = arr.map_read()
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu()
            if arr.is_floating_point():
                arr = arr.float()
            arr = arr.numpy()
        return numpy.asarray(arr)

    @staticmethod
    def _write_png(img: numpy.ndarray, path: str) -> None:
        try:
            from PIL import Image
        except ImportError as exc:
            raise VelesError("ImageSaver writes PNGs with Pillow (the PIL "
                             "package), which is not installed: %s"
                             % exc) from exc
        Image.fromarray(img).save(path)

    def get_metric_values(self):
        return {"images_saved": self.saved_count} if self.saved_count \
            else {}

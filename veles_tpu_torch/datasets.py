"""Dataset acquisition for the bundled models (counterpart of
``veles_tpu/datasets.py``).

Each loader looks for the real dataset in the same cache locations as
the reference (``root.common.dirs.datasets``, the keras and ``~/data``
layouts) and otherwise synthesises the reference's deterministic
surrogate — identical shapes, dtypes, class structure and, from the same
seed, identical bits.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
from typing import Optional, Tuple

import numpy

from .config import root

Arrays = Tuple[numpy.ndarray, numpy.ndarray, numpy.ndarray, numpy.ndarray]

#: fixed seed of the synthetic surrogates (the reference's)
SYNTHETIC_SEED = 20260101


def _dataset_dirs():
    yield root.common.dirs.datasets
    yield os.path.expanduser("~/.keras/datasets")
    yield os.path.expanduser("~/data")


def _find(*names: str) -> Optional[str]:
    for d in _dataset_dirs():
        for n in names:
            p = os.path.join(d, n)
            if os.path.exists(p):
                return p
    return None


def _read_idx(path: str) -> numpy.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return numpy.frombuffer(f.read(), dtype=numpy.uint8).reshape(shape)


def load_mnist(flat: bool = True) -> Arrays:
    """(train_x, train_y, test_x, test_y); x float32 in [0, 1), shape
    (N, 784) or (N, 28, 28, 1). Without the real files: the synthetic
    surrogate of 60,000 + 10,000 rows."""
    npz = _find("mnist.npz")
    if npz is not None:
        with numpy.load(npz) as d:
            tx, ty = d["x_train"], d["y_train"]
            vx, vy = d["x_test"], d["y_test"]
    else:
        idx = _find("train-images-idx3-ubyte.gz", "train-images-idx3-ubyte")
        if idx is None:
            return _synthetic_images((28, 28), 10, 60000, 10000, flat,
                                     key="mnist")
        base = os.path.dirname(idx)

        def g(n):
            p = os.path.join(base, n + ".gz")
            return _read_idx(p if os.path.exists(p)
                             else os.path.join(base, n))
        tx = g("train-images-idx3-ubyte")
        ty = g("train-labels-idx1-ubyte")
        vx = g("t10k-images-idx3-ubyte")
        vy = g("t10k-labels-idx1-ubyte")
    tx = tx.astype(numpy.float32) / 255.0
    vx = vx.astype(numpy.float32) / 255.0
    if flat:
        tx, vx = tx.reshape(len(tx), -1), vx.reshape(len(vx), -1)
    else:
        tx, vx = tx[..., None], vx[..., None]
    return tx, ty.astype(numpy.int32), vx, vy.astype(numpy.int32)


class _ArrayUnpickler(pickle.Unpickler):
    """Unpickles plain containers and numpy arrays only: the CIFAR-10
    batches are pickles, read from a directory the program does not
    own, so no other global may be loaded from them."""

    ALLOWED = {("numpy", "ndarray"), ("numpy", "dtype"),
               ("numpy.core.multiarray", "_reconstruct"),
               ("numpy._core.multiarray", "_reconstruct")}

    def find_class(self, module, name):
        if (module, name) not in self.ALLOWED:
            raise pickle.UnpicklingError("refusing %s.%s in a dataset "
                                         "pickle" % (module, name))
        return super().find_class(module, name)


def load_cifar10(n_train: int = 50000, n_test: int = 10000) -> Arrays:
    """(train_x, train_y, test_x, test_y); x float32 NHWC (N, 32, 32, 3)
    in [0, 1]. The real pickled batches (``cifar-10-batches-py``) when a
    dataset directory holds them, all 50,000 + 10,000 rows; otherwise the
    synthetic surrogate of ``n_train`` + ``n_test`` rows. Nothing is
    downloaded."""
    d = _find("cifar-10-batches-py")
    if d is None:
        return _synthetic_images((32, 32, 3), 10, n_train, n_test,
                                 flat=False, key="cifar10")

    def batch(name):
        with open(os.path.join(d, name), "rb") as f:
            b = _ArrayUnpickler(f, encoding="bytes").load()
        return numpy.asarray(b[b"data"]), b[b"labels"]

    def fmt(x):
        return (x.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
                .astype(numpy.float32) / 255.0)
    train = [batch("data_batch_%d" % i) for i in range(1, 6)]
    tx = numpy.concatenate([x for x, _ in train])
    ty = numpy.asarray([y for _, ys in train for y in ys], dtype=numpy.int32)
    vx, vy = batch("test_batch")
    return fmt(tx), ty, fmt(vx), numpy.asarray(vy, dtype=numpy.int32)


def load_synthetic(sample_shape, n_classes, n_train, n_test,
                   flat=False, key="synth") -> Arrays:
    """The class-template surrogate generator the real loaders fall
    back to."""
    return _synthetic_images(sample_shape, n_classes, n_train, n_test,
                             flat, key=key)


def _synthetic_images(sample_shape, n_classes, n_train, n_test, flat,
                      key="synth") -> Arrays:
    """Deterministic class-structured surrogate: each class is a smooth
    random template plus per-sample noise, so simple models learn."""
    del key  # the reference names the stream; its seed is fixed
    rng = numpy.random.RandomState(SYNTHETIC_SEED)
    full_shape = (tuple(sample_shape) + (1,) if len(sample_shape) == 2
                  else tuple(sample_shape))
    templates = rng.rand(n_classes, *full_shape).astype(numpy.float32)
    for _ in range(2):
        templates = (templates +
                     numpy.roll(templates, 1, axis=1) +
                     numpy.roll(templates, 1, axis=2)) / 3.0

    def make(n, seed):
        r = numpy.random.RandomState(seed)
        y = r.randint(0, n_classes, n).astype(numpy.int32)
        x = templates[y] * 0.7 + 0.3 * r.rand(n, *full_shape).astype(
            numpy.float32)
        return x.astype(numpy.float32), y

    tx, ty = make(n_train, 1)
    vx, vy = make(n_test, 2)
    if len(sample_shape) == 2:
        tx, vx = tx[..., 0], vx[..., 0]
        if flat:
            tx, vx = tx.reshape(n_train, -1), vx.reshape(n_test, -1)
        else:
            tx, vx = tx[..., None], vx[..., None]
    return tx, ty, vx, vy


def mnist_is_real() -> bool:
    return _find("mnist.npz", "train-images-idx3-ubyte.gz",
                 "train-images-idx3-ubyte") is not None


def cifar10_is_real() -> bool:
    return _find("cifar-10-batches-py") is not None

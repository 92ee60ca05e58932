"""Convolutional autoencoder — BASELINE config #3, ImagenetAE
(counterpart of ``models/imagenet_ae.py``): a conv + avg-pool encoder, a
depool + deconv decoder, trained to reconstruct its input under MSE
(``target_mode`` "auto", which resolves to "input"); the decision reports
the rmse.

- :func:`build_workflow`: 32×32×3 CIFAR-10 images (the synthetic
  surrogate without the real batches), 4,000 train / 800 validation
  rows, conv_tanh 5×5×16, avg-pool 2, conv_tanh 3×3×8, depool 2, deconv
  5×5×3; mb 50, lr 0.01.
- :func:`build_bench_workflow`: the reference bench's compute-bound
  section (``bench.py`` ``bench_conv_ae``): 128×128×3 synthetic images,
  1,024 / 128 rows, conv_relu 5×5×64, avg-pool 2, conv_relu 3×3×128,
  avg-pool 2, conv_relu 3×3×128, depool 2, deconv 3×3×64, depool 2,
  deconv 5×5×3; mb 64, lr 1e-4; it never stops by itself (set
  ``wf.decision.max_epochs``).

    python -m veles_tpu_torch.models.imagenet_ae --epochs 20 [--device cpu]

runs on the card unless ``--device cpu`` is given.
"""

import argparse
import time

import numpy

from .. import datasets
from ..loader import FullBatchLoader
from ..nn.standard_workflow import StandardWorkflow


class AELoader(FullBatchLoader):
    """CIFAR-10 images with no labels: validation rows first."""

    hide_from_registry = True

    def __init__(self, workflow, image_size=32, n_train=4000, n_valid=800,
                 **kwargs):
        super().__init__(workflow, **kwargs)
        self.image_size = image_size
        self.n_train, self.n_valid = n_train, n_valid

    def load_data(self):
        tx, _, vx, _ = datasets.load_cifar10(n_train=self.n_train,
                                             n_test=self.n_valid)
        self.create_originals(numpy.concatenate([vx, tx]), None)
        self.class_lengths = [0, len(vx), len(tx)]


def build_workflow(epochs=20, minibatch_size=50, lr=0.01):
    loader = AELoader(None, minibatch_size=minibatch_size, name="ae")
    layers = [
        # encoder
        {"type": "conv_tanh", "n_kernels": 16, "kx": 5, "ky": 5,
         "padding": (2, 2, 2, 2), "learning_rate": lr},
        {"type": "avg_pooling", "kx": 2, "ky": 2},
        {"type": "conv_tanh", "n_kernels": 8, "kx": 3, "ky": 3,
         "padding": (1, 1, 1, 1), "learning_rate": lr},
        # decoder
        {"type": "depooling", "kx": 2, "ky": 2},
        {"type": "deconv", "n_channels": 3, "kx": 5, "ky": 5,
         "padding": (2, 2, 2, 2), "learning_rate": lr},
    ]
    return StandardWorkflow(
        name="imagenet-ae", layers=layers, loader_unit=loader,
        loss_function="mse",
        decision_config=dict(max_epochs=epochs, fail_iterations=50))


class SyntheticImageLoader(FullBatchLoader):
    """Uniform [-1, 1) RGB images of any size from numpy seed 123456, as
    the reference's: the bench's throughput does not depend on the
    pixels."""

    hide_from_registry = True

    def __init__(self, workflow, image_size=128, n_train=1024, n_valid=128,
                 **kwargs):
        super().__init__(workflow, **kwargs)
        self.image_size = image_size
        self.n_train, self.n_valid = n_train, n_valid

    def load_data(self):
        rng = numpy.random.RandomState(123456)
        s = self.image_size
        data = rng.uniform(-1.0, 1.0, (self.n_valid + self.n_train, s, s, 3)
                           ).astype(numpy.float32)
        self.create_originals(data, None)
        self.class_lengths = [0, self.n_valid, self.n_train]


def build_bench_workflow(image_size=128, minibatch_size=64, n_train=1024,
                         n_valid=128, lr=1e-4, remat=False):
    """Most of the work sits in the 64→128 and 128→128 3×3 convs; only
    the RGB stem and head are narrow."""
    loader = SyntheticImageLoader(
        None, image_size=image_size, n_train=n_train, n_valid=n_valid,
        minibatch_size=minibatch_size, name="ae-bench")
    layers = [
        # encoder
        {"type": "conv_relu", "n_kernels": 64, "kx": 5, "ky": 5,
         "padding": (2, 2, 2, 2), "learning_rate": lr},
        {"type": "avg_pooling", "kx": 2, "ky": 2},
        {"type": "conv_relu", "n_kernels": 128, "kx": 3, "ky": 3,
         "padding": (1, 1, 1, 1), "learning_rate": lr},
        {"type": "avg_pooling", "kx": 2, "ky": 2},
        {"type": "conv_relu", "n_kernels": 128, "kx": 3, "ky": 3,
         "padding": (1, 1, 1, 1), "learning_rate": lr},
        # decoder
        {"type": "depooling", "kx": 2, "ky": 2},
        {"type": "deconv", "n_channels": 64, "kx": 3, "ky": 3,
         "padding": (1, 1, 1, 1), "learning_rate": lr},
        {"type": "depooling", "kx": 2, "ky": 2},
        {"type": "deconv", "n_channels": 3, "kx": 5, "ky": 5,
         "padding": (2, 2, 2, 2), "learning_rate": lr},
    ]
    return StandardWorkflow(
        name="imagenet-ae-bench", layers=layers, loader_unit=loader,
        loss_function="mse",
        decision_config=dict(max_epochs=10 ** 9, fail_iterations=10 ** 9),
        remat=remat)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--mb", type=int, default=50)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--device", default=None,
                   help="cuda[:N] (default: the card) or cpu")
    args = p.parse_args(argv)
    wf = build_workflow(args.epochs, args.mb, args.lr)
    wf.initialize(device=args.device)
    t0 = time.time()
    wf.run()
    dt = time.time() - t0
    res = wf.gather_results()
    print("dataset: %s CIFAR-10" %
          ("REAL" if datasets.cifar10_is_real() else "synthetic"))
    print("best validation rmse: %.4f (epoch %d)" %
          (res["best_rmse"], res["best_epoch"]))
    print("throughput: %.0f samples/sec" % (wf.loader.samples_served / dt))
    return res


if __name__ == "__main__":
    main()

"""VideoAE — a fully-connected autoencoder over synthetic video frames
(counterpart of ``models/video_ae.py``): 256 → 96 → 24 → 96 → 256, each
layer tanh, adam lr 0.02, mb 64, MSE on the input (``target_mode=
"input"``), 1,920 train / 384 validation frames.

The frames are generated as the reference generates them
(``RandomState(71)``): a bright square orbiting over a static noisy
16 × 16 background, so consecutive frames share structure the
bottleneck must find.

    python -m veles_tpu_torch.models.video_ae --epochs 10 [--device cpu]

runs on the card unless ``--device cpu`` is given.
"""

import argparse
import time

import numpy

from ..loader import FullBatchLoader
from ..nn.standard_workflow import StandardWorkflow

SIZE = 16


def make_frames(rng, n, size=SIZE):
    """n frames of a square orbiting a noisy static background."""
    background = 0.2 * rng.rand(size, size).astype(numpy.float32)
    frames = numpy.empty((n, size, size), dtype=numpy.float32)
    for i in range(n):
        t = 2.0 * numpy.pi * (i / 24.0 + rng.rand() / 24.0)
        cy = int(size / 2 + (size / 3) * numpy.sin(t))
        cx = int(size / 2 + (size / 3) * numpy.cos(t))
        f = background + 0.05 * rng.rand(size, size).astype(numpy.float32)
        f[max(cy - 2, 0):cy + 2, max(cx - 2, 0):cx + 2] = \
            0.8 + 0.2 * rng.rand()
        frames[i] = numpy.clip(f, 0.0, 1.0)
    return frames.reshape(n, -1)


class VideoLoader(FullBatchLoader):
    hide_from_registry = True

    def __init__(self, workflow, n_train=1920, n_valid=384, **kwargs):
        super().__init__(workflow, **kwargs)
        self.n_train, self.n_valid = n_train, n_valid

    def load_data(self):
        rng = numpy.random.RandomState(71)
        n = self.n_valid + self.n_train
        self.create_originals(make_frames(rng, n))
        self.class_lengths = [0, self.n_valid, self.n_train]


def build_workflow(epochs=10, minibatch_size=64, lr=0.02,
                   n_train=1920, n_valid=384, bottleneck=24):
    loader = VideoLoader(None, n_train=n_train, n_valid=n_valid,
                         minibatch_size=minibatch_size, name="video")
    return StandardWorkflow(
        name="video_ae",
        layers=[{"type": "all2all_tanh", "output_sample_shape": width,
                 "solver": "adam", "learning_rate": lr}
                for width in (96, bottleneck, 96, SIZE * SIZE)],
        loader_unit=loader, loss_function="mse", target_mode="input",
        decision_config=dict(max_epochs=epochs, fail_iterations=40))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--mb", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--device", default=None,
                   help="cuda[:N] (default: the card) or cpu")
    args = p.parse_args(argv)
    wf = build_workflow(args.epochs, args.mb, args.lr)
    wf.initialize(device=args.device)
    t0 = time.time()
    wf.run()
    dt = time.time() - t0
    res = wf.gather_results()
    print("device: %s" % wf.device)
    print("best validation rmse: %.4f (epoch %d)" %
          (res["best_rmse"], res["best_epoch"]))
    print("throughput: %.0f samples/sec" % (wf.loader.samples_served / dt))
    return res


if __name__ == "__main__":
    main()

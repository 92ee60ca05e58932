"""Kanji — an MSE net mapping noisy glyph renderings to their clean
templates (counterpart of ``models/kanji.py``): 576 → 256 tanh → 576
tanh, adam lr 0.005, mb 80, the loader's targets (``target_mode=
"targets"``), 2,400 train / 480 validation rows.

Glyphs are generated as the reference generates them (``RandomState
(43)``): each class is a fixed set of strokes on a 24 × 24 grid, and a
sample is a shifted, noised rendering of its class's template.

    python -m veles_tpu_torch.models.kanji --epochs 12 [--device cpu]

runs on the card unless ``--device cpu`` is given.
"""

import argparse
import time

import numpy

from ..loader import FullBatchLoaderMSE
from ..nn.standard_workflow import StandardWorkflow

SIZE = 24
N_CLASSES = 12
STROKES_PER_GLYPH = 6


def make_templates(rng, n_classes=N_CLASSES, size=SIZE):
    """Per-class glyph template: horizontal/vertical strokes on a grid,
    values in [0, 1]."""
    templates = numpy.zeros((n_classes, size, size), dtype=numpy.float32)
    for c in range(n_classes):
        for _ in range(STROKES_PER_GLYPH):
            horizontal = rng.rand() < 0.5
            pos = rng.randint(2, size - 2)
            lo = rng.randint(0, size // 2)
            hi = rng.randint(size // 2, size)
            thickness = rng.randint(1, 3)
            if horizontal:
                templates[c, pos:pos + thickness, lo:hi] = 1.0
            else:
                templates[c, lo:hi, pos:pos + thickness] = 1.0
    return templates


def render(rng, template):
    """One distorted rendering: random shift, speckle noise, contrast
    jitter."""
    dy, dx = rng.randint(-2, 3, size=2)
    img = numpy.roll(numpy.roll(template, dy, axis=0), dx, axis=1)
    img = img * (0.7 + 0.3 * rng.rand()) + 0.25 * rng.rand(*img.shape)
    return numpy.clip(img, 0.0, 1.0).astype(numpy.float32)


class KanjiLoader(FullBatchLoaderMSE):
    hide_from_registry = True

    def __init__(self, workflow, n_train=2400, n_valid=480, **kwargs):
        super().__init__(workflow, **kwargs)
        self.n_train, self.n_valid = n_train, n_valid

    def load_data(self):
        rng = numpy.random.RandomState(43)
        self.templates = make_templates(rng)
        n = self.n_valid + self.n_train
        labels = rng.randint(0, N_CLASSES, n).astype(numpy.int32)
        data = numpy.stack([render(rng, self.templates[c])
                            for c in labels])
        targets = self.templates[labels].reshape(n, -1)
        self.create_originals(data.reshape(n, -1), labels, targets)
        self.class_lengths = [0, self.n_valid, self.n_train]


def build_workflow(epochs=12, minibatch_size=80, lr=0.005,
                   n_train=2400, n_valid=480, hidden=256):
    loader = KanjiLoader(None, n_train=n_train, n_valid=n_valid,
                         minibatch_size=minibatch_size, name="kanji")
    return StandardWorkflow(
        name="kanji",
        layers=[
            {"type": "all2all_tanh", "output_sample_shape": hidden,
             "solver": "adam", "learning_rate": lr},
            {"type": "all2all_tanh", "output_sample_shape": SIZE * SIZE,
             "solver": "adam", "learning_rate": lr},
        ],
        loader_unit=loader, loss_function="mse", target_mode="targets",
        decision_config=dict(max_epochs=epochs, fail_iterations=50))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--mb", type=int, default=80)
    p.add_argument("--lr", type=float, default=0.005)
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

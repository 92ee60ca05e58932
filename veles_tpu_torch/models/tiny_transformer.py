"""Tiny transformer — the zoo's sequence classifier (counterpart of
``models/tiny_transformer.py``): a positional embedding, ``n_blocks``
identical pre-LN transformer blocks (d 32, 4 heads of 8, FFN 64,
non-causal), a mean-pool head and a 2-way softmax, all trained with
adam at lr 0.003, mb 64, on 2,560 train / 512 validation rows.

The task (generated as the reference generates it, ``RandomState(23)``):
the ORDER of two marker bursts in a noisy (16, 32) sequence, so the
positional embedding is load-bearing and attention must relate the two
marker positions. On the card the blocks' attention runs through the
flash kernels at head dim 8, non-causal, forward and backward.

    python -m veles_tpu_torch.models.tiny_transformer --epochs 20 \\
        [--device cpu]

runs on the card unless ``--device cpu`` is given; ``python -m
veles_tpu_torch veles_tpu_torch/models/tiny_transformer.py`` runs
``build_workflow()`` through the CLI.
"""

import argparse
import time

import numpy

# absolute imports: the CLI executes this file by its path
from veles_tpu_torch.loader import FullBatchLoader
from veles_tpu_torch.nn.standard_workflow import StandardWorkflow

SEQ_LEN = 16
DIM = 32
N_CLASSES = 2       # marker A before B, or B before A


class OrderLoader(FullBatchLoader):
    """Marker A (features 0..7) and marker B (features 8..15) at two
    distinct positions; the label says which comes first."""

    hide_from_registry = True

    def __init__(self, workflow, n_train=2560, n_valid=512, **kwargs):
        super().__init__(workflow, **kwargs)
        self.n_train, self.n_valid = n_train, n_valid

    def load_data(self):
        rng = numpy.random.RandomState(23)
        n = self.n_valid + self.n_train
        x = 0.2 * rng.randn(n, SEQ_LEN, DIM).astype(numpy.float32)
        y = rng.randint(0, 2, n).astype(numpy.int32)
        for i in range(n):
            pa, pb = sorted(rng.choice(SEQ_LEN, 2, replace=False))
            first, second = (pa, pb) if y[i] == 0 else (pb, pa)
            x[i, first, :8] += 1.0       # marker A at `first`
            x[i, second, 8:16] += 1.0    # marker B at `second`
        self.create_originals(x, y)
        self.class_lengths = [0, self.n_valid, self.n_train]


def build_workflow(epochs=20, minibatch_size=64, lr=0.003, n_blocks=4,
                   n_train=2560, n_valid=512):
    loader = OrderLoader(None, n_train=n_train, n_valid=n_valid,
                         minibatch_size=minibatch_size, name="order")
    layers = ([{"type": "pos_embedding", "solver": "adam",
                "learning_rate": lr}]
              + [{"type": "transformer_block", "n_heads": 4,
                  "ffn_hidden": 64, "causal": False,
                  "solver": "adam", "learning_rate": lr,
                  "name": "blk%d" % i} for i in range(n_blocks)]
              + [{"type": "mean_pool"},
                 {"type": "softmax", "output_sample_shape": N_CLASSES,
                  "solver": "adam", "learning_rate": lr}])
    return StandardWorkflow(
        name="tiny-transformer",
        layers=layers, loader_unit=loader, loss_function="softmax",
        decision_config=dict(max_epochs=epochs, fail_iterations=50))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--mb", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.003)
    p.add_argument("--blocks", type=int, default=4)
    p.add_argument("--device", default=None,
                   help="cuda[:N] (default: the card) or cpu")
    args = p.parse_args(argv)
    wf = build_workflow(args.epochs, args.mb, args.lr, args.blocks)
    wf.initialize(device=args.device)
    t0 = time.time()
    wf.run()
    dt = time.time() - t0
    res = wf.gather_results()
    print("device: %s" % wf.device)
    print("best validation error: %.4f (epoch %d)" %
          (res["best_err"], res["best_epoch"]))
    print("throughput: %.0f samples/sec" % (wf.loader.samples_served / dt))
    return res


if __name__ == "__main__":
    main()

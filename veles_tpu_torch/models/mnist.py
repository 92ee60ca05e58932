"""MNIST-784 fully-connected workflow — BASELINE config #1 (counterpart
of ``models/mnist.py``): 784 → 100 tanh → 10 softmax, minibatch 100,
learning rate 0.03 with ``exp_decay(0.98)``, 60,000 train / 10,000
validation rows. Without the MNIST files the data is the reference's
synthetic surrogate of the same shape (``datasets.load_mnist``).

    python -m veles_tpu_torch.models.mnist --epochs 8 \\
        --epochs-per-dispatch 4 --fused-fc [--device cpu]

runs on the card unless ``--device cpu`` is given. With
``--snapshot-dir D`` it writes snapshots to ``D`` (``D/mnist_current.
pickle.gz`` is the newest); ``--resume D/mnist_current.pickle.gz``
continues such a run up to ``--epochs``, from a file of either package.
"""

import argparse
import time

import numpy

from .. import datasets
from ..config import root
from ..snapshotter import Snapshotter, resume
from ..loader import FullBatchLoader
from ..nn.lr_adjust import exp_decay
from ..nn.standard_workflow import StandardWorkflow


class MnistLoader(FullBatchLoader):
    """60k train / 10k validation, flattened 784-vectors."""

    hide_from_registry = True

    def load_data(self):
        tx, ty, vx, vy = datasets.load_mnist(flat=True)
        self.create_originals(numpy.concatenate([vx, tx]),
                              numpy.concatenate([vy, ty]))
        self.class_lengths = [0, len(vx), len(tx)]


def build_workflow(epochs=10, minibatch_size=100, lr=None, hidden=None,
                   snapshot_dir=None, epochs_per_dispatch=1):
    """The reference's ``build_workflow``; ``lr``/``hidden`` left None
    resolve from ``root.mnist``; ``snapshot_dir`` adds a gz
    ``Snapshotter`` with the prefix "mnist"."""
    lr = float(root.mnist.lr) if lr is None else lr
    hidden = int(root.mnist.hidden) if hidden is None else hidden
    loader = MnistLoader(None, minibatch_size=minibatch_size, name="mnist")
    snap = (Snapshotter(None, prefix="mnist", directory=snapshot_dir)
            if snapshot_dir else None)
    return StandardWorkflow(
        name="mnist-784",
        layers=[
            {"type": "all2all_tanh", "output_sample_shape": hidden,
             "learning_rate": lr},
            {"type": "softmax", "output_sample_shape": 10,
             "learning_rate": lr},
        ],
        loader_unit=loader,
        loss_function="softmax",
        decision_config=dict(max_epochs=epochs, fail_iterations=50),
        lr_schedule=exp_decay(0.98),
        snapshotter_unit=snap,
        epochs_per_dispatch=epochs_per_dispatch,
    )


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--mb", type=int, default=100)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--epochs-per-dispatch", type=int, default=1)
    p.add_argument("--fused-fc", action="store_true",
                   help="train each epoch in the fused-FC kernel")
    p.add_argument("--device", default=None,
                   help="cuda[:N] (default: the card) or cpu")
    p.add_argument("--snapshot-dir", default=None)
    p.add_argument("--resume", default=None,
                   help="snapshot file to resume from")
    args = p.parse_args(argv)
    if args.fused_fc and args.epochs_per_dispatch < 2:
        p.error("--fused-fc runs the kernel inside an epoch block: give "
                "--epochs-per-dispatch 2 or more")
    root.common.engine.fused_fc_scan = bool(args.fused_fc)
    wf = build_workflow(args.epochs, args.mb, args.lr,
                        snapshot_dir=args.snapshot_dir,
                        epochs_per_dispatch=args.epochs_per_dispatch)
    wf.initialize(device=args.device)
    if args.resume:
        resume(wf, args.resume)
        wf.decision.complete <<= False
        print("resumed from %s at epoch %d" %
              (args.resume, wf.decision.epoch_number))
    t0 = time.time()
    wf.run()
    dt = time.time() - t0
    res = wf.gather_results()
    print("dataset: %s MNIST" %
          ("REAL" if datasets.mnist_is_real() else "synthetic"))
    print("device: %s, fused-FC kernel: %s" % (
        wf.device, bool(wf.train_step._fused_fc_active)))
    print("best validation error: %.4f (epoch %d)" %
          (res["best_err"], res["best_epoch"]))
    print("throughput: %.0f samples/sec" % (wf.loader.samples_served / dt))
    return res


if __name__ == "__main__":
    main()

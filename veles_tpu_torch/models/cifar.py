"""CIFAR-10 conv net — BASELINE config #4 on one card (counterpart of
``models/cifar.py``): the caffe cifar10_quick stack the reference
shipped, 50,000 train / 10,000 validation NHWC images less the train
mean (the synthetic surrogate without the real batches), mb 100, lr
0.001 with ``step_exp(0.5, 20)``.

    python -m veles_tpu_torch.models.cifar --epochs 30 [--device cpu]

runs on the card unless ``--device cpu`` is given. Data parallelism
(``--data-par`` above 1) is not ported yet.
"""

import argparse
import time

import numpy

from .. import datasets
from ..error import VelesError
from ..loader import FullBatchLoader
from ..nn.lr_adjust import step_exp
from ..nn.standard_workflow import StandardWorkflow


class CifarLoader(FullBatchLoader):
    """50k train / 10k validation NHWC images, mean-subtracted."""

    hide_from_registry = True

    def load_data(self):
        tx, ty, vx, vy = datasets.load_cifar10()
        mean = tx.mean(axis=0)
        self.create_originals(numpy.concatenate([vx, tx]) - mean,
                              numpy.concatenate([vy, ty]))
        self.class_lengths = [0, len(vx), len(tx)]


def caffe_quick_layers(lr):
    """The caffe cifar10_quick stack: conv 5×5×32, max-pool 3/2, relu,
    conv_relu 5×5×32, avg-pool 3/2, conv_relu 5×5×64, avg-pool 3/2,
    all2all 64, softmax 10; decay 1e-4 on every parameterised layer."""
    return [
        {"type": "conv", "n_kernels": 32, "kx": 5, "ky": 5,
         "padding": (2, 2, 2, 2), "learning_rate": lr,
         "weights_decay": 1e-4},
        {"type": "max_pooling", "kx": 3, "ky": 3, "sliding": (2, 2)},
        {"type": "activation_str"},
        {"type": "conv_relu", "n_kernels": 32, "kx": 5, "ky": 5,
         "padding": (2, 2, 2, 2), "learning_rate": lr,
         "weights_decay": 1e-4},
        {"type": "avg_pooling", "kx": 3, "ky": 3, "sliding": (2, 2)},
        {"type": "conv_relu", "n_kernels": 64, "kx": 5, "ky": 5,
         "padding": (2, 2, 2, 2), "learning_rate": lr,
         "weights_decay": 1e-4},
        {"type": "avg_pooling", "kx": 3, "ky": 3, "sliding": (2, 2)},
        {"type": "all2all", "output_sample_shape": 64,
         "learning_rate": lr, "weights_decay": 1e-4},
        {"type": "softmax", "output_sample_shape": 10,
         "learning_rate": lr, "weights_decay": 1e-4},
    ]


def build_workflow(epochs=30, minibatch_size=100, lr=0.001, data_par=1):
    if data_par > 1:
        raise VelesError("data_par=%d: data parallelism is not ported yet"
                         % data_par)
    loader = CifarLoader(None, minibatch_size=minibatch_size, name="cifar")
    return StandardWorkflow(
        name="cifar-conv", layers=caffe_quick_layers(lr),
        loader_unit=loader, loss_function="softmax",
        decision_config=dict(max_epochs=epochs, fail_iterations=100),
        lr_schedule=step_exp(0.5, 20))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--mb", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--data-par", type=int, default=1,
                   help="size of the data-parallel axis (only 1 is "
                        "ported)")
    p.add_argument("--device", default=None,
                   help="cuda[:N] (default: the card) or cpu")
    args = p.parse_args(argv)
    wf = build_workflow(args.epochs, args.mb, args.lr, args.data_par)
    wf.initialize(device=args.device)
    t0 = time.time()
    wf.run()
    dt = time.time() - t0
    res = wf.gather_results()
    print("dataset: %s CIFAR-10" %
          ("REAL" if datasets.cifar10_is_real() else "synthetic"))
    print("best validation error: %.4f (epoch %d)" %
          (res["best_err"], res["best_epoch"]))
    print("throughput: %.0f samples/sec" % (wf.loader.samples_served / dt))
    return res


if __name__ == "__main__":
    main()

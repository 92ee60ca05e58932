"""AlexNet through the ``mcdnnic_topology`` shorthand (counterpart of
``models/alexnet.py``): the whole conv-pool-dense stack comes from one
topology string, scaled by ``image_size`` — two conv stages and two
dense layers below 96 px (32 by default, the CI size), the five-conv
stack ``3xSxS-48C7-MP2-128C5-MP2-192C3-192C3-128C3-MP2-512N-512N-10N``
from 96 px (224 is the classic geometry). Adam at lr 0.001, mb 64, on
the imagenet surrogate's 1,600 train / 320 validation rows (the
reference's class-template images; real ImageNet is not in the repo).

    python -m veles_tpu_torch.models.alexnet --size 224 --epochs 2 \\
        [--device cpu]

runs on the card unless ``--device cpu`` is given; ``python -m
veles_tpu_torch veles_tpu_torch/models/alexnet.py`` runs
``build_workflow()`` through the CLI.
"""

import argparse
import time

import numpy

# absolute imports: the CLI executes this file by its path
from veles_tpu_torch.datasets import load_synthetic
from veles_tpu_torch.loader import FullBatchLoader
from veles_tpu_torch.nn.standard_workflow import StandardWorkflow

N_CLASSES = 10


class SyntheticImagenet(FullBatchLoader):
    hide_from_registry = True

    def __init__(self, workflow, image_size=32, n_train=1600,
                 n_valid=320, **kwargs):
        super().__init__(workflow, **kwargs)
        self.image_size = image_size
        self.n_train, self.n_valid = n_train, n_valid

    def load_data(self):
        tx, ty, vx, vy = load_synthetic(
            (self.image_size, self.image_size, 3), N_CLASSES,
            self.n_train, self.n_valid, flat=False, key="alexnet")
        self.create_originals(numpy.concatenate([vx, tx]),
                              numpy.concatenate([vy, ty]))
        self.class_lengths = [0, self.n_valid, self.n_train]


def topology(image_size: int) -> str:
    """The AlexNet-shaped stack for the input size: the five-conv stack
    from 96 px, two conv+pool stages and two dense layers below."""
    if image_size >= 96:
        return ("3x%dx%d-48C7-MP2-128C5-MP2-192C3-192C3-128C3-MP2-"
                "512N-512N-%dN" % (image_size, image_size, N_CLASSES))
    return ("3x%dx%d-16C5-MP2-32C3-MP2-64N-%dN"
            % (image_size, image_size, N_CLASSES))


def build_workflow(epochs=10, minibatch_size=64, lr=0.001, image_size=32,
                   n_train=1600, n_valid=320):
    loader = SyntheticImagenet(None, image_size=image_size,
                               n_train=n_train, n_valid=n_valid,
                               minibatch_size=minibatch_size,
                               name="imagenet")
    return StandardWorkflow(
        name="alexnet",
        mcdnnic_topology=topology(image_size),
        mcdnnic_parameters={"learning_rate": lr, "solver": "adam"},
        loader_unit=loader, loss_function="softmax",
        decision_config=dict(max_epochs=epochs, fail_iterations=40))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--mb", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--size", type=int, default=32)
    p.add_argument("--device", default=None,
                   help="cuda[:N] (default: the card) or cpu")
    args = p.parse_args(argv)
    wf = build_workflow(args.epochs, args.mb, args.lr, args.size)
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

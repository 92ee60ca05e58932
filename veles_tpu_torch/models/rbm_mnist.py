"""An RBM trained by CD-1 on MNIST's rows: the reference's RBM units
(``veles_tpu/nn/rbm.py``) in a workflow loop of the DemoKohonen shape —
Repeater → loader → RBMTrainer → RBMDecision — since CD-1 is no loss
graph either. 784 visible units (the 28×28 images in [0, 1), the
synthetic surrogate without the MNIST files) → 256 hidden, mb 64, lr
0.1; each epoch serves ``n_train`` train rows (12,800: 200 CD-1 steps).

    python -m veles_tpu_torch.models.rbm_mnist --epochs 4 [--device cpu]

runs on the card unless ``--device cpu`` is given.
"""

import argparse
import time

from .. import datasets
from ..accelerated import AcceleratedWorkflow
from ..loader import FullBatchLoader
from ..mutable import Bool
from ..nn.rbm import RBMTrainer
from ..plumbing import Repeater
from ..units import Unit


class MnistRows(FullBatchLoader):
    """The first ``n_train`` MNIST train rows, flattened, as one train
    class."""

    hide_from_registry = True

    def __init__(self, workflow, n_train=12800, **kwargs):
        super().__init__(workflow, **kwargs)
        self.n_train = n_train

    def load_data(self):
        tx, ty, _, _ = datasets.load_mnist(flat=True)
        self.create_originals(tx[:self.n_train], ty[:self.n_train])
        self.class_lengths = [0, 0, len(self.original_data)]


class RBMDecision(Unit):
    """Records the trainer's reconstruction error after its first step
    and at each epoch's end; raises ``complete`` at ``max_epochs``."""

    hide_from_registry = True

    def __init__(self, workflow, max_epochs=4, **kwargs):
        super().__init__(workflow, **kwargs)
        self.view_group = "TRAINER"
        self.max_epochs = max_epochs
        self.complete = Bool(False)
        self.epoch_number = 0
        self.first_error = None
        self.error_history = []
        self.loader = None
        self.trainer = None
        self.demand("loader", "trainer")

    def run(self) -> None:
        if self.first_error is None:
            self.first_error = self.trainer.reconstruction_error
        if not bool(self.loader.epoch_ended):
            return
        self.epoch_number += 1
        err = self.trainer.reconstruction_error
        self.error_history.append(err)
        self.info("epoch %d  reconstruction error %.5f", self.epoch_number,
                  err)
        if self.epoch_number >= self.max_epochs:
            self.complete <<= True

    def get_metric_values(self):
        return {"epochs": self.epoch_number,
                "first_error": self.first_error,
                "final_error": (self.error_history[-1]
                                if self.error_history else None),
                "error_history": list(self.error_history)}


class RBMWorkflow(AcceleratedWorkflow):
    """The Repeater loop around loader → RBMTrainer."""

    hide_from_registry = True

    def __init__(self, epochs=4, minibatch_size=64, n_hidden=256, lr=0.1,
                 n_train=12800, **kwargs):
        super().__init__(**kwargs)
        self.loader = MnistRows(self, n_train=n_train,
                                minibatch_size=minibatch_size, name="mnist")
        self.trainer = RBMTrainer(self, n_hidden=n_hidden,
                                  learning_rate=lr, name="rbm")
        self.trainer.link_attrs(self.loader, ("input", "minibatch_data"))
        self.decision = RBMDecision(self, max_epochs=epochs,
                                    name="rbm_decision")
        self.decision.loader = self.loader
        self.decision.trainer = self.trainer
        self.repeater = Repeater(self)
        self.repeater.link_from(self.start_point)
        self.loader.link_from(self.repeater)
        self.trainer.link_from(self.loader)
        self.decision.link_from(self.trainer)
        self.repeater.link_from(self.decision)
        self.repeater.gate_block = self.decision.complete
        self.end_point.link_from(self.decision)
        self.end_point.gate_block = ~self.decision.complete


def build_workflow(epochs=4, minibatch_size=64, n_hidden=256, lr=0.1,
                   n_train=12800):
    return RBMWorkflow(epochs=epochs, minibatch_size=minibatch_size,
                       n_hidden=n_hidden, lr=lr, n_train=n_train,
                       name="rbm_mnist")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--mb", type=int, default=64)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--device", default=None,
                   help="cuda[:N] (default: the card) or cpu")
    args = p.parse_args(argv)
    wf = build_workflow(args.epochs, args.mb, args.hidden)
    wf.initialize(device=args.device)
    t0 = time.time()
    wf.run()
    dt = time.time() - t0
    res = wf.gather_results()
    print("device: %s" % wf.device)
    print("reconstruction error: %.5f after the first step, %.5f after %d "
          "epochs" % (res["first_error"], res["final_error"],
                      res["epochs"]))
    print("throughput: %.0f samples/sec" % (wf.loader.samples_served / dt))
    return res


if __name__ == "__main__":
    main()

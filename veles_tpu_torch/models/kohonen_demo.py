"""DemoKohonen: a self-organising map on 2-D point clusters (counterpart
of ``models/kohonen_demo.py``). SOM training is no loss graph, so the
workflow wires its own loop, as the reference's does: Repeater → loader
→ KohonenTrainer → SOMDecision, the trainer's batch-SOM step in torch
ops on the card. The map has organised when the final quantisation
error lies below the clusters' noise radius (0.25).

    python -m veles_tpu_torch.models.kohonen_demo --epochs 10 \\
        [--device cpu]

runs on the card unless ``--device cpu`` is given.
"""

import argparse
import time

import numpy

from ..accelerated import AcceleratedWorkflow
from ..loader import FullBatchLoader
from ..mutable import Bool
from ..nn.kohonen import KohonenTrainer
from ..plumbing import Repeater
from ..units import Unit

N_CLUSTERS = 5


def make_clusters(rng, n, n_clusters=N_CLUSTERS, noise=0.25):
    centers = 4.0 * rng.rand(n_clusters, 2).astype(numpy.float32)
    labels = rng.randint(0, n_clusters, n).astype(numpy.int32)
    x = centers[labels] + noise * rng.randn(n, 2).astype(numpy.float32)
    return x, labels


class ClusterLoader(FullBatchLoader):
    hide_from_registry = True

    def __init__(self, workflow, n_train=1500, **kwargs):
        super().__init__(workflow, **kwargs)
        self.n_train = n_train

    def load_data(self):
        rng = numpy.random.RandomState(29)
        x, labels = make_clusters(rng, self.n_train)
        self.create_originals(x, labels)
        self.class_lengths = [0, 0, self.n_train]


class SOMDecision(Unit):
    """Records the trainer's quantisation error at each epoch's end and
    raises ``complete`` at ``max_epochs``."""

    hide_from_registry = True

    def __init__(self, workflow, max_epochs=10, **kwargs):
        super().__init__(workflow, **kwargs)
        self.view_group = "TRAINER"
        self.max_epochs = max_epochs
        self.complete = Bool(False)
        self.epoch_number = 0
        self.qerr_history = []
        self.loader = None
        self.trainer = None
        self.demand("loader", "trainer")

    def run(self) -> None:
        if not bool(self.loader.epoch_ended):
            return
        self.epoch_number += 1
        qerr = self.trainer.quantization_error
        self.qerr_history.append(qerr)
        self.info("epoch %d  som_qerr=%.4f", self.epoch_number, qerr)
        if self.epoch_number >= self.max_epochs:
            self.complete <<= True

    def get_metric_values(self):
        return {"epochs": self.epoch_number,
                "final_qerr": (self.qerr_history[-1]
                               if self.qerr_history else None),
                "qerr_history": list(self.qerr_history)}


class KohonenDemoWorkflow(AcceleratedWorkflow):
    """The Repeater loop around loader → KohonenTrainer."""

    hide_from_registry = True

    def __init__(self, shape=(6, 6), epochs=10, minibatch_size=100,
                 n_train=1500, lr0=0.5, decay=120.0, **kwargs):
        super().__init__(**kwargs)
        self.loader = ClusterLoader(self, n_train=n_train,
                                    minibatch_size=minibatch_size,
                                    name="clusters")
        self.trainer = KohonenTrainer(self, shape=shape, lr0=lr0,
                                      decay=decay, name="som")
        self.trainer.link_attrs(self.loader, ("input", "minibatch_data"))
        self.decision = SOMDecision(self, max_epochs=epochs,
                                    name="som_decision")
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


def build_workflow(epochs=10, minibatch_size=100, n_train=1500,
                   shape=(6, 6), lr0=0.5, decay=None):
    if decay is None:
        # the decay clock scaled to the run's length, so a short run
        # anneals as the full demo does
        decay = max(epochs * max(n_train // minibatch_size, 1) / 2.0, 10.0)
    return KohonenDemoWorkflow(shape=shape, epochs=epochs,
                               minibatch_size=minibatch_size,
                               n_train=n_train, lr0=lr0, decay=decay,
                               name="kohonen_demo")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--mb", type=int, default=100)
    p.add_argument("--device", default=None,
                   help="cuda[:N] (default: the card) or cpu")
    args = p.parse_args(argv)
    wf = build_workflow(args.epochs, args.mb)
    wf.initialize(device=args.device)
    t0 = time.time()
    wf.run()
    dt = time.time() - t0
    res = wf.gather_results()
    print("device: %s" % wf.device)
    print("final quantization error: %.4f after %d epochs" %
          (res["final_qerr"], res["epochs"]))
    print("throughput: %.0f samples/sec" % (wf.loader.samples_served / dt))
    return res


if __name__ == "__main__":
    main()

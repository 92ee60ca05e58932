"""LSTM sequence classification — BASELINE config #5 on one card
(counterpart of ``models/genre_recognition.py``): the Znicz LSTM
genre_recognition workflow, LSTM(64) → softmax(6) over sequences of
T 64 × 24 features, mb 60, lr 0.05 (SGD), on the reference's synthetic
genre signatures (each genre a frequency/phase signature plus noise;
1,800 train / 360 validation rows).

    python -m veles_tpu_torch.models.genre_recognition --epochs 15
        [--device cpu]

runs on the card unless ``--device cpu`` is given. The recurrence is a
Python loop of the LSTM's step over time (``nn/rnn.py``), its backward
autograd through that loop.
"""

import argparse
import time

import numpy

from ..loader import FullBatchLoader
from ..nn.standard_workflow import StandardWorkflow

N_GENRES = 6
SEQ_LEN = 64
N_FEATURES = 24


class GenreLoader(FullBatchLoader):
    """The reference's synthetic genre-structured sequences: signatures
    from ``RandomState(11)``, the train rows from ``RandomState(1)``,
    the validation rows from ``RandomState(2)``."""

    hide_from_registry = True

    def load_data(self):
        rng = numpy.random.RandomState(11)
        n_train, n_valid = 1800, 360
        freqs = rng.rand(N_GENRES, N_FEATURES) * 0.5 + 0.05
        phases = rng.rand(N_GENRES, N_FEATURES) * numpy.pi

        def make(n, seed):
            r = numpy.random.RandomState(seed)
            y = r.randint(0, N_GENRES, n).astype(numpy.int32)
            t = numpy.arange(SEQ_LEN)[None, :, None]
            x = numpy.sin(t * freqs[y][:, None, :] + phases[y][:, None, :])
            x = (x + 0.5 * r.randn(n, SEQ_LEN, N_FEATURES)).astype(
                numpy.float32)
            return x, y
        tx, ty = make(n_train, 1)
        vx, vy = make(n_valid, 2)
        self.create_originals(numpy.concatenate([vx, tx]),
                              numpy.concatenate([vy, ty]))
        self.class_lengths = [0, n_valid, n_train]


def build_workflow(epochs=15, minibatch_size=60, lr=0.05, hidden=64):
    loader = GenreLoader(None, minibatch_size=minibatch_size, name="genre")
    return StandardWorkflow(
        name="genre-lstm",
        layers=[
            {"type": "lstm", "hidden_size": hidden, "learning_rate": lr},
            {"type": "softmax", "output_sample_shape": N_GENRES,
             "learning_rate": lr},
        ],
        loader_unit=loader, loss_function="softmax",
        decision_config=dict(max_epochs=epochs, fail_iterations=50))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--mb", type=int, default=60)
    p.add_argument("--lr", type=float, default=0.05)
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
    print("best validation error: %.4f (epoch %d)" %
          (res["best_err"], res["best_epoch"]))
    print("throughput: %.0f samples/sec" % (wf.loader.samples_served / dt))
    return res


if __name__ == "__main__":
    main()

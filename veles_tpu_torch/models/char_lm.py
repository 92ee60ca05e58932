"""Character language model (counterpart of ``models/char_lm.py``):
embedding → a stack of RoPE transformer blocks, return-sequences LSTMs
or SSM blocks (``arch``) → LM head, trained with
``loss_function="softmax_seq"`` (per-token cross-entropy on shifted
targets) and adam. The corpus comes from the reference's small
deterministic grammar, or from a text file (``text_file``, ``--text``);
``build_bench_workflow`` is the reference's
throughput-bench LM (6 blocks, d_model 512, T 512) on random tokens.

    python -m veles_tpu_torch.models.char_lm --epochs 10 [--arch lstm]
        [--text FILE] [--device cpu]

runs on the card unless ``--device cpu`` is given; the attention's
forward and backward go through the hand-written flash kernels there.
A recurrent ``arch`` is served by ``serving/recurrent.py``'s O(1)-state
slot pool (``generate`` runs its solo decode).
"""

import argparse
import time

import numpy

from ..loader import FullBatchLoaderMSE
from ..loader.text import TextFileLoader
from ..nn import sampling
from ..nn.ssm import RecurrentCell
from ..nn.standard_workflow import StandardWorkflow, forwards_of

SEQ_LEN = 32
VOCAB = 16


def make_corpus(rng, n_chars):
    """Markov-ish grammar: each symbol strongly prefers (s + 1) % 8 or
    a jump into the 8-15 'punctuation' range that returns to 0."""
    out = numpy.empty(n_chars, dtype=numpy.int32)
    s = 0
    for i in range(n_chars):
        out[i] = s
        r = rng.rand()
        if s < 8:
            s = (s + 1) % 8 if r < 0.8 else 8 + rng.randint(0, 8)
        else:
            s = 0 if r < 0.9 else 8 + rng.randint(0, 8)
    return out


class CharLMLoader(FullBatchLoaderMSE):
    hide_from_registry = True

    def __init__(self, workflow, n_train=1536, n_valid=256, **kwargs):
        super().__init__(workflow, **kwargs)
        self.n_train, self.n_valid = n_train, n_valid

    def load_data(self):
        rng = numpy.random.RandomState(41)
        n = self.n_valid + self.n_train
        corpus = make_corpus(rng, n * SEQ_LEN + 1)
        x = corpus[:-1].reshape(n, SEQ_LEN)
        y = corpus[1:].reshape(n, SEQ_LEN)       # next-token targets
        self.create_originals(x, None, targets=y)
        self.class_lengths = [0, self.n_valid, self.n_train]


def build_workflow(epochs=10, minibatch_size=64, lr=0.003, n_blocks=2,
                   dim=32, n_train=1536, n_valid=256, text_file=None,
                   seq_len=SEQ_LEN, arch="transformer"):
    """The reference's char-LM workflow, on the generated grammar or,
    with ``text_file``, on a real text file through ``TextFileLoader``
    (windows of ``seq_len``, the vocabulary the corpus's characters plus
    the reserved unknown id). ``arch``: "transformer" (RoPE blocks),
    "lstm" (stacked return-sequences LSTMs) or "ssm" (gated
    linear-attention SSD blocks), as the reference builds them."""
    if text_file:
        # the embedding and the head are sized before the loader reads
        # the corpus at initialize: one scan for the vocabulary, passed
        # back in so the loader keeps the same table
        with open(text_file, "r", encoding="utf-8",
                  errors="replace") as f:
            chars = "".join(sorted(set(f.read())))
        loader = TextFileLoader(None, files=[text_file], seq_len=seq_len,
                                vocab=chars, minibatch_size=minibatch_size,
                                name="chars")
        vocab = loader.vocab_size
    else:
        loader = CharLMLoader(None, n_train=n_train, n_valid=n_valid,
                              minibatch_size=minibatch_size, name="chars")
        vocab = VOCAB
    if arch not in ("transformer", "lstm", "ssm"):
        raise ValueError("arch must be 'transformer', 'lstm' or "
                         "'ssm', got %r" % (arch,))
    if arch == "lstm":
        body = [{"type": "lstm", "hidden_size": dim,
                 "return_sequences": True, "solver": "adam",
                 "learning_rate": lr, "name": "lstm%d" % i}
                for i in range(n_blocks)]
    elif arch == "ssm":
        body = [{"type": "ssm_block", "n_heads": 4, "solver": "adam",
                 "learning_rate": lr, "name": "ssm%d" % i}
                for i in range(n_blocks)]
    else:
        body = [{"type": "transformer_block", "n_heads": 4,
                 "ffn_hidden": 2 * dim, "causal": True, "rope": True,
                 "solver": "adam", "learning_rate": lr,
                 "name": "blk%d" % i} for i in range(n_blocks)]
    layers = ([{"type": "embedding", "vocab_size": vocab, "dim": dim,
                "solver": "adam", "learning_rate": lr}]
              + body
              + [{"type": "lm_head", "vocab_size": vocab,
                  "solver": "adam", "learning_rate": lr}])
    return StandardWorkflow(
        name="char-lm", layers=layers, loader_unit=loader,
        loss_function="softmax_seq",
        decision_config=dict(max_epochs=epochs, fail_iterations=50))


class SyntheticTokenLoader(FullBatchLoaderMSE):
    """Random token streams at any (seq_len, vocab) — the LM
    throughput-bench data (content does not affect throughput)."""

    hide_from_registry = True

    def __init__(self, workflow, seq_len=512, vocab=256, n_train=1024,
                 n_valid=128, **kwargs):
        super().__init__(workflow, **kwargs)
        self.seq_len, self.vocab = seq_len, vocab
        self.n_train, self.n_valid = n_train, n_valid

    def load_data(self):
        rng = numpy.random.RandomState(2027)
        n = self.n_valid + self.n_train
        stream = rng.randint(0, self.vocab, n * self.seq_len + 1,
                             dtype=numpy.int32)
        self.create_originals(stream[:-1].reshape(n, self.seq_len), None,
                              targets=stream[1:].reshape(n, self.seq_len))
        self.class_lengths = [0, self.n_valid, self.n_train]


def build_bench_workflow(seq_len=512, dim=512, n_blocks=6,
                         ffn_hidden=2048, n_heads=8, vocab=256,
                         minibatch_size=16, n_train=1024, n_valid=128,
                         lr=1e-4, epochs_per_dispatch=1,
                         snapshotter_unit=None):
    """GPT-style stack at the reference's throughput-bench scale: token
    embedding → N pre-LN RoPE blocks → LM head, per-token CE, adam. It
    never stops by itself (``max_epochs`` 10**9, as in the reference):
    drive it epoch by epoch, or set ``wf.decision.max_epochs``.
    ``snapshotter_unit`` links a Snapshotter (a model file run through
    the CLI with ``--snapshot-dir``)."""
    loader = SyntheticTokenLoader(
        None, seq_len=seq_len, vocab=vocab, n_train=n_train,
        n_valid=n_valid, minibatch_size=minibatch_size, name="lm-bench")
    layers = ([{"type": "embedding", "vocab_size": vocab, "dim": dim,
                "solver": "adam", "learning_rate": lr}]
              + [{"type": "transformer_block", "n_heads": n_heads,
                  "ffn_hidden": ffn_hidden, "causal": True, "rope": True,
                  "solver": "adam", "learning_rate": lr,
                  "name": "blk%d" % i} for i in range(n_blocks)]
              + [{"type": "lm_head", "vocab_size": vocab,
                  "solver": "adam", "learning_rate": lr}])
    return StandardWorkflow(
        name="char-lm-bench", layers=layers, loader_unit=loader,
        loss_function="softmax_seq",
        decision_config=dict(max_epochs=10 ** 9,
                             fail_iterations=10 ** 9),
        steps_per_dispatch=n_train // minibatch_size,
        epochs_per_dispatch=epochs_per_dispatch,
        snapshotter_unit=snapshotter_unit)


def generate(wf, prompt, n_new, temperature=1.0, seed=0):
    """Sample continuations from the trained workflow over its current
    parameters: a transformer stack through the KV-cached sampler
    (``nn/sampling.generate``), a recurrent one through the O(1)-state
    lane's solo decode (``serving.generate_recurrent``)."""
    stack = forwards_of(wf)
    if any(isinstance(layer, RecurrentCell) for layer in stack):
        from ..serving import generate_recurrent
        return generate_recurrent(
            stack, prompt, n_new, temperature=temperature, seed=seed,
            mode="sample" if temperature > 0 else "greedy")
    return sampling.generate(stack, prompt, n_new, temperature=temperature,
                             seed=seed)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--mb", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.003)
    p.add_argument("--blocks", type=int, default=2)
    p.add_argument("--arch", default="transformer",
                   choices=("transformer", "lstm", "ssm"))
    p.add_argument("--sample", type=int, default=48,
                   help="tokens to sample after training (0 = skip)")
    p.add_argument("--text", default=None, metavar="FILE",
                   help="train on a real text file (TextFileLoader) "
                        "instead of the generated grammar")
    p.add_argument("--device", default=None,
                   help="cuda[:N] (default: the card) or cpu")
    args = p.parse_args(argv)

    wf = build_workflow(args.epochs, args.mb, args.lr, args.blocks,
                        text_file=args.text, arch=args.arch)
    wf.initialize(device=args.device)
    t0 = time.time()
    wf.run()
    dt = time.time() - t0
    res = wf.gather_results()
    print("device: %s" % wf.device)
    print("best per-token error: %.4f (epoch %d)" %
          (res["best_err"], res["best_epoch"]))
    print("throughput: %.0f samples/sec" %
          (wf.loader.samples_served / dt))
    if args.sample:
        if args.text:
            # prompt with the corpus's own first characters
            loader = wf.loader
            prompt = [int(t) for t in loader.original_data.mem[0][:8]]
            toks = generate(wf, prompt, args.sample, temperature=0.8)
            print("sample: %r" % loader.decode(prompt + toks))
        else:
            toks = generate(wf, [0, 1, 2], args.sample, temperature=0.8)
            print("sample:", " ".join(str(t) for t in toks))
    return res


if __name__ == "__main__":
    main()

"""The port's text path (loader/text.py TextFileLoader, the loader base's
``fetch_batch``/``apply_batch``/``check_label_diversity``/``stop``,
models/char_lm.py ``text_file``) against the reference's on the same
files and seed, on the CPU:

- ``TextFileLoader`` (tolerance 0): windows, targets, the vocabulary,
  the unknown ids of a restricted vocabulary, the overlap-dropping
  stride and ``class_lengths`` equal the reference's, as do ``decode``
  and the served plans;
- ``check_label_diversity`` returns the reference's p-value;
- the text char LM (seq 16, d 16, 2 blocks, adam) from one seed: its
  initial parameters bitwise equal, the first two adam steps' losses
  within 1e-4 relative of the reference's;
- ``python -m veles_tpu_torch.models.char_lm --text FILE --device cpu``
  trains and samples decoded text.
"""
import numpy
import pytest
import torch

import veles_tpu as vt
from veles_tpu import prng as ref_prng
from veles_tpu.loader import FullBatchLoader as RefFullBatchLoader
from veles_tpu.loader import TextFileLoader as RefTextFileLoader
from veles_tpu_torch import prng
from veles_tpu_torch.convert import vocab_from_jax
from veles_tpu_torch.error import VelesError
from veles_tpu_torch.loader import FullBatchLoader, TextFileLoader
from veles_tpu_torch.models import char_lm

from conftest import import_model

LOSS_RTOL = 1e-4

CORPUS = ("The quick brown fox jumps over the lazy dog. " * 3
          + "Pack my box with five dozen liquor jugs! " * 3
          + "How vexingly quick daft zebras jump; 0123456789.\n") * 2


@pytest.fixture(scope="module")
def ref_lm():
    prev = vt.root.common.engine.compute_dtype
    vt.root.common.engine.compute_dtype = "float32"
    try:
        yield import_model("char_lm")
    finally:
        vt.root.common.engine.compute_dtype = prev


@pytest.fixture
def corpus(tmp_path):
    path = tmp_path / "corpus.txt"
    path.write_text(CORPUS)
    return str(path)


def _loaders(files, **kw):
    ref = RefTextFileLoader(None, files=files, name="txt", **kw)
    port = TextFileLoader(None, files=files, name="txt", **kw)
    ref_prng.seed_all(5)
    ref.initialize()
    prng.seed_all(5)
    port.initialize()
    return ref, port


@pytest.mark.parametrize("kw", [
    dict(seq_len=16, minibatch_size=4),
    dict(seq_len=12, stride=5, minibatch_size=3, validation_ratio=0.2),
    dict(seq_len=8, vocab="abcdefghijklmnopqrstuvwxyz ", minibatch_size=8),
], ids=["default", "overlapping_stride", "restricted_vocab"])
def test_text_loader_equals_the_reference(corpus, kw):
    ref, port = _loaders([corpus, corpus], **kw)
    assert port.vocab == ref.vocab
    assert port.unk_id == ref.unk_id and port.vocab_size == ref.vocab_size
    assert port.class_lengths == ref.class_lengths
    numpy.testing.assert_array_equal(port.original_data.mem,
                                     ref.original_data.mem)
    numpy.testing.assert_array_equal(port.original_targets.mem,
                                     ref.original_targets.mem)
    assert port.original_data.mem.dtype == ref.original_data.mem.dtype
    ids = ref.original_data.mem[0]
    assert port.decode(ids) == ref.decode(ids)
    numpy.testing.assert_array_equal(port.encode(CORPUS[:40]),
                                     ref.encode(CORPUS[:40]))
    if "vocab" in kw:
        assert (port.original_data.mem == port.unk_id).any()
        assert port.UNK_CHAR in port.decode(port.original_data.mem[:4])
    # the served minibatches: the same plans, rows and targets
    for _ in range(6):
        ref.run()
        port.run()
        numpy.testing.assert_array_equal(port.minibatch_indices.mem,
                                         ref.minibatch_indices.mem)
        numpy.testing.assert_array_equal(port.minibatch_data.mem,
                                         ref.minibatch_data.mem)
        numpy.testing.assert_array_equal(port.minibatch_targets.mem,
                                         ref.minibatch_targets.mem)
    mb = port.max_minibatch_size
    idx = numpy.arange(mb, dtype=numpy.int32)[::-1].copy()
    got, want = port.fetch_batch(idx, mb), ref.fetch_batch(idx, mb)
    assert sorted(got) == sorted(want)
    for k in want:
        numpy.testing.assert_array_equal(got[k], want[k])
    port.apply_batch(got)
    numpy.testing.assert_array_equal(port.minibatch_data.mem,
                                     want["data"])
    port.stop()


def test_text_loader_refusals_match(tmp_path, corpus):
    for cls in (RefTextFileLoader, TextFileLoader):
        with pytest.raises(Exception, match="at least one file"):
            cls(None, files=[])
    short = tmp_path / "short.txt"
    short.write_text("abc")
    for cls in (RefTextFileLoader, TextFileLoader):
        ld = cls(None, files=[str(short)], seq_len=8)
        with pytest.raises(Exception, match="cannot fill one"):
            ld.load_data()
        with pytest.raises(Exception, match="no vocabulary"):
            cls(None, files=[corpus]).decode([0])
    with pytest.raises(VelesError, match="missing"):
        TextFileLoader(None, files=[str(tmp_path / "nope")]).load_data()


def test_vocab_from_jax_pins_the_reference_table(corpus):
    ref = RefTextFileLoader(None, files=[corpus], seq_len=8,
                            vocab="abcdefghij ")
    ref.initialize()
    port = TextFileLoader(None, files=[corpus], seq_len=8)
    vocab_from_jax(port, ref)
    port.initialize()
    numpy.testing.assert_array_equal(port.original_data.mem,
                                     ref.original_data.mem)
    with pytest.raises(VelesError, match="another vocabulary"):
        vocab_from_jax(port, "xyz")


@pytest.mark.parametrize("split", ["skewed", "balanced", "one_class"])
def test_check_label_diversity_equals_the_reference(split):
    rng = numpy.random.RandomState(3)
    labels = rng.randint(0, 3, 300).astype(numpy.int32)
    if split == "skewed":
        labels[40:100] = 0
    elif split == "one_class":
        labels[:] = 2

    def load_data(self):
        self.create_originals(
            numpy.zeros((300, 2), numpy.float32), labels)
        self.class_lengths = [40, 60, 200]
    ref = type("RefL", (RefFullBatchLoader,), {"hide_from_registry": True,
                                               "load_data": load_data})
    port = type("PortL", (FullBatchLoader,), {"hide_from_registry": True,
                                              "load_data": load_data})
    r, p = ref(None, name="div"), port(None, name="div")
    r.load_data()
    p.load_data()
    want, got = r.check_label_diversity(), p.check_label_diversity()
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want, rel=1e-12, abs=0)
    if split == "skewed":
        assert got < 0.01


def _text_lm(port, ref_lm, path):
    args = dict(epochs=1, minibatch_size=8, n_blocks=2, dim=16,
                seq_len=16, text_file=path, lr=0.003)
    if port:
        prng.seed_all(11)
        wf = char_lm.build_workflow(**args)
        wf.initialize(device="cpu")
    else:
        ref_prng.seed_all(11)
        wf = ref_lm.build_workflow(**args)
        wf.initialize(device=vt.XLADevice(mesh_axes={"data": 1}))
    return wf


def test_text_char_lm_first_two_adam_steps(tmp_path, ref_lm):
    """18 windows of 16: 16 train = two adam steps of 8 in the one
    epoch, 1 validation (the window straddling the split is dropped):
    the second step's loss (after the first update) within 1e-4
    relative of the reference's, from bitwise-equal parameters, and the
    validation error after them within 1e-5."""
    path = tmp_path / "lm.txt"
    path.write_text(CORPUS[:16 * 18 + 1])
    ref = _text_lm(False, ref_lm, str(path))
    port = _text_lm(True, ref_lm, str(path))
    assert port.loader.class_lengths == ref.loader.class_lengths == \
        [0, 1, 16]
    assert port.loader.vocab == ref.loader.vocab
    for name, params in ref.train_step.params.items():
        for k, v in params.items():
            numpy.testing.assert_array_equal(
                port.train_step.params[name][k].numpy(), numpy.asarray(v),
                err_msg="%s.%s" % (name, k))
    ref.run()
    port.run()
    assert len(port.decision.epoch_losses[2]) == 1
    last_ref = float(numpy.asarray(ref.train_step.last_loss))
    last_port = float(port.train_step.last_loss)
    assert last_port == pytest.approx(last_ref, rel=LOSS_RTOL)
    assert port.decision.epoch_metrics[1] == pytest.approx(
        ref.decision.epoch_metrics[1], abs=1e-5)


def test_main_trains_on_a_text_file(tmp_path, capsys):
    path = tmp_path / "main.txt"
    path.write_text(CORPUS)
    res = char_lm.main(["--text", str(path), "--epochs", "1", "--mb", "16",
                        "--blocks", "1", "--sample", "8", "--device",
                        "cpu"])
    out = capsys.readouterr().out
    assert res["epochs"] == 1
    assert "sample: '" in out
    assert torch.get_default_dtype() == torch.float32

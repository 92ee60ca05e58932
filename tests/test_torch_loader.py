"""The port's loaders, keyed streams and datasets (loader/base.py,
loader/fullbatch.py, prng.py, datasets.py) against the reference's:
for the same seed the served index plans, masks, per-epoch train
shuffles and epoch flags are identical — classic plans, epoch blocks of
1 and 4, a partial tail batch, the ``block_epochs_cap`` clamp — and the
synthetic datasets and stream seeds are bitwise equal."""
import numpy
import pytest

from veles_tpu import datasets as ref_datasets
from veles_tpu import prng as ref_prng
from veles_tpu.loader import FullBatchLoader as RefFullBatchLoader
from veles_tpu_torch import datasets, prng
from veles_tpu_torch.loader import FullBatchLoader


def _data():
    rng = numpy.random.RandomState(11)
    x = rng.rand(160, 6).astype(numpy.float32)
    y = rng.randint(0, 3, 160).astype(numpy.int32)
    return x, y


class RefLoader(RefFullBatchLoader):
    hide_from_registry = True

    def load_data(self):
        self.create_originals(*_data())
        self.class_lengths = [10, 30, 120]


class PortLoader(FullBatchLoader):
    hide_from_registry = True

    def load_data(self):
        self.create_originals(*_data())
        self.class_lengths = [10, 30, 120]


def _make(cls, seed_mod, mb, plan_steps, block, cap):
    seed_mod.seed_all(321)
    loader = cls(None, minibatch_size=mb, name="ld")
    loader.fused = True
    loader.plan_steps = plan_steps
    loader.block_epochs = block
    loader.block_epochs_cap = cap
    loader.initialize()
    return loader


def _snapshot(loader):
    snap = {"class": loader.minibatch_class, "size": loader.minibatch_size,
            "plan_length": loader.plan_length,
            "epoch": loader.epoch_number,
            "flags": [bool(loader.epoch_ended), bool(loader.last_minibatch),
                      bool(loader.train_ended), bool(loader.test_ended)],
            "served": loader.samples_served,
            "order": numpy.array(loader._shuffled_indices)}
    if loader.block_epochs > 1:
        snap["block_length"] = loader.block_length
        for cls, (idx, mask) in loader.block_plans.items():
            h = loader.block_length
            snap["idx%d" % cls] = numpy.array(idx.mem[:h])
            snap["mask%d" % cls] = numpy.array(mask.mem[:h])
    else:
        snap["idx"] = numpy.array(loader.minibatch_indices.mem)
        snap["mask"] = numpy.array(loader.minibatch_mask.mem)
    return snap


@pytest.mark.parametrize("mb,plan_steps,block,cap,runs", [
    (20, 16, 1, None, 12),      # classic plans, 2+ epochs
    (20, 1, 1, None, 20),       # one minibatch per run
    (20, 16, 4, None, 3),       # epoch blocks of 4
    (25, 16, 4, None, 2),       # partial tail batch (120 % 25)
    (20, 16, 4, 6, 2),          # the final block clamps to 2 epochs
])
def test_plans_masks_and_shuffles_match(mb, plan_steps, block, cap, runs):
    ref = _make(RefLoader, ref_prng, mb, plan_steps, block, cap)
    port = _make(PortLoader, prng, mb, plan_steps, block, cap)
    assert port.plan_steps == ref.plan_steps
    for r in range(runs):
        ref.run()
        port.run()
        a, b = _snapshot(ref), _snapshot(port)
        assert sorted(a) == sorted(b)
        for key in a:
            numpy.testing.assert_array_equal(b[key], a[key],
                                             err_msg="run %d %s" % (r, key))
    if cap is not None:
        assert port.block_length == 2


def test_partial_tail_is_padded_and_masked():
    port = _make(PortLoader, prng, 25, 16, 4, None)
    port.run()
    idx, mask = port.block_plans[2]
    tail_idx, tail_mask = idx.mem[0, -1], mask.mem[0, -1]
    assert tail_mask.sum() == 120 % 25
    assert (tail_idx[20:] == tail_idx[19]).all()


@pytest.mark.parametrize("shape,flat", [((28, 28), True), ((28, 28), False),
                                        ((8, 8, 3), False)])
def test_synthetic_datasets_bitwise(shape, flat):
    ref = ref_datasets.load_synthetic(shape, 10, 300, 50, flat=flat,
                                      key="mnist")
    port = datasets.load_synthetic(shape, 10, 300, 50, flat=flat,
                                   key="mnist")
    for a, b in zip(ref, port):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert numpy.array_equal(a, b)


def test_mnist_is_synthetic_here_in_both():
    assert datasets.mnist_is_real() == ref_datasets.mnist_is_real()


@pytest.mark.parametrize("key", ["default", "mnist", "all2all_tanh0",
                                 "softmax1", "bl"])
def test_stream_seeds_and_draws_match(key):
    ref_prng.seed_all(777)
    prng.seed_all(777)
    r, p = ref_prng.get(key), prng.get(key)
    assert p.initial_seed == r.initial_seed
    w_r = numpy.zeros((5, 3), numpy.float32)
    w_p = numpy.zeros((5, 3), numpy.float32)
    r.fill_normal(w_r, 0.1)
    p.fill_normal(w_p, 0.1)
    assert numpy.array_equal(w_r, w_p)
    a, b = numpy.arange(9), numpy.arange(9)
    r.shuffle(a)
    p.shuffle(b)
    assert numpy.array_equal(a, b)


def test_torch_generator_is_seeded_from_the_stream():
    prng.seed_all(5)
    g1 = prng.get("dev").torch_generator("cpu")
    assert g1 is prng.get("dev").torch_generator("cpu")
    assert g1.initial_seed() == prng.get("dev").initial_seed

"""The conv family trained through the port's StandardWorkflow/TrainStep
against the reference's, on the same data and seed, on the CPU:

- the initial conv, deconv and all2all weights are bitwise equal under
  ``prng.seed_all``;
- ImagenetAE (``models/imagenet_ae.py`` ``build_workflow``'s layers,
  16×16 surrogate CIFAR images, 3 epochs; ``target_mode`` "auto" through
  ``build_workflow`` and "input" given): per-epoch train and validation
  rmse within 1e-5 relative, final weights and SGD ``opt_state`` within
  rtol 2e-4 / atol 2e-5 (float32 in another summation order, as the
  MNIST parity);
- ``build_bench_workflow`` (the bench AE: conv_relu, avg-pool,
  depool, deconv at 32×32, mb 16, 2 epochs) in float32 at the same
  tolerances, and under the bench's setting (``engine.mixed_precision``
  with ``dataset_dtype="bfloat16"``): per-epoch rmse within 1e-4
  relative, final weights and ``opt_state`` within rtol 2e-3 / atol
  5e-4 of the reference's, masters float32. Why: the forward and the
  input and weight gradients round where the reference's do
  (tests/test_torch_conv.py holds them to one bf16 ulp), but the
  reference on the CPU sums each bias gradient's B·H·W terms in bf16,
  the port in float32 with one rounding, so the bias steps differ by
  the reference's summation error, a few percent of the gradient
  (observed: rmse 7.7e-6 relative, weights 3.7e-7 and biases 8.3e-5
  abs);
- CIFAR caffe-quick (``models/cifar.py``, 16×16 surrogate, 2 epochs):
  per-epoch error rates within 1e-5, final weights and ``opt_state`` as
  the AE's;
- ``params_from_jax`` carries a trained reference conv tree and its
  ``opt_state`` across, and refuses a wrong shape before it writes;
- ``load_cifar10``'s surrogate is the reference's, byte for byte, and
  so are its arrays from pickled batches in a dataset directory, whose
  unpickling refuses anything but arrays and plain containers;
- the new entry points run on the card unless asked for the CPU.
"""
import jax
import numpy
import pytest
import torch

import veles_tpu as vt
from veles_tpu import datasets as ref_datasets
from veles_tpu import prng as ref_prng
from veles_tpu.config import root as ref_root
from veles_tpu.loader import TRAIN, VALID
from veles_tpu_torch import datasets, prng
from veles_tpu_torch.config import root
from veles_tpu_torch.convert import params_from_jax
from veles_tpu_torch.error import VelesError
from veles_tpu_torch.models import cifar, imagenet_ae
from veles_tpu_torch.nn.standard_workflow import StandardWorkflow

from conftest import import_model

RTOL, ATOL = 2e-4, 2e-5
RMSE_RTOL = 1e-5
ERR_ATOL = 1e-5
AMP_RMSE_RTOL = 1e-4
AMP_RTOL, AMP_ATOL = 2e-3, 5e-4
KNOBS = ("mixed_precision", "dataset_dtype")

REF_AE = import_model("imagenet_ae")
REF_CIFAR = import_model("cifar")


@pytest.fixture(autouse=True)
def _knobs():
    saved = [(cfg, k, cfg.common.engine.get(k, None))
             for cfg in (root, ref_root) for k in KNOBS]
    yield
    for cfg, k, v in saved:
        setattr(cfg.common.engine, k, v)


@pytest.fixture
def small_cifar(monkeypatch):
    """16×16 surrogate CIFAR-10 in both packages, 300 train / 100 test."""
    def load(n_train=50000, n_test=10000):
        return datasets.load_synthetic((16, 16, 3), 10, 300, 100,
                                       key="cifar10")
    monkeypatch.setattr(datasets, "load_cifar10", load)
    monkeypatch.setattr(ref_datasets, "load_cifar10", load)


def _init(wf, port):
    if port:
        return wf.initialize(device="cpu") or wf
    wf.initialize(device=vt.XLADevice(mesh_axes={"data": 1}))
    return wf


def _ae(port, mode="auto", seed=11):
    (prng if port else ref_prng).seed_all(seed)
    mod = imagenet_ae if port else REF_AE
    wf = mod.build_workflow(epochs=3, minibatch_size=50, lr=0.02)
    if mode == "auto":
        return wf
    wf_cls = StandardWorkflow if port else vt.nn.StandardWorkflow
    (prng if port else ref_prng).seed_all(seed)
    return wf_cls(name="ae", layers=wf.layers_config,
                  loader_unit=mod.AELoader(None, minibatch_size=50,
                                           name="ae"),
                  loss_function="mse", target_mode=mode,
                  decision_config=dict(max_epochs=3, fail_iterations=50))


def _bench(port, amp, seed=12):
    cfg = root if port else ref_root
    cfg.common.engine.mixed_precision = amp
    cfg.common.engine.dataset_dtype = "bfloat16" if amp else None
    (prng if port else ref_prng).seed_all(seed)
    wf = (imagenet_ae if port else REF_AE).build_bench_workflow(
        image_size=32, minibatch_size=16, n_train=64, n_valid=32, lr=1e-3)
    wf.decision.max_epochs = 2
    return wf


def _cifar(port, seed=13):
    (prng if port else ref_prng).seed_all(seed)
    return (cifar if port else REF_CIFAR).build_workflow(
        epochs=2, minibatch_size=50, lr=0.05)


def _ref_tree(tree):
    return {n: {k: numpy.asarray(jax.device_get(v), dtype=numpy.float32)
                for k, v in p.items()} for n, p in tree.items()}


def _run_pair(build):
    ref = _init(build(False), False)
    ref.run()
    port = _init(build(True), True)
    port.run()
    return ref, port


def _assert_trained_alike(ref, port, rtol=RTOL, atol=ATOL):
    assert port.decision.epoch_number == ref.decision.epoch_number
    for attr in ("params", "opt_state"):
        want = _ref_tree(getattr(ref.train_step, attr))
        got = getattr(port.train_step, attr)
        assert sorted(want) == sorted(got)
        for name, params in want.items():
            assert sorted(params) == sorted(got[name]), name
            for k, v in params.items():
                assert got[name][k].dtype == torch.float32
                numpy.testing.assert_allclose(
                    got[name][k].numpy(), v, rtol=rtol, atol=atol,
                    err_msg="%s %s.%s" % (attr, name, k))


def _assert_rmse_alike(ref, port, rtol):
    for cls in (TRAIN, VALID):
        want = ref.decision.epoch_metrics[cls]
        assert len(want) == ref.decision.epoch_number
        numpy.testing.assert_allclose(port.decision.epoch_metrics[cls],
                                      want, rtol=rtol, err_msg=str(cls))


@pytest.mark.parametrize("build", ["ae", "cifar"])
def test_initial_weights_bitwise_equal(small_cifar, build):
    make = _ae if build == "ae" else _cifar
    ref = _init(make(False), False)
    port = _init(make(True), True)
    want = _ref_tree(ref.train_step.params)
    assert sorted(want) == sorted(port.train_step.params)
    kinds = {type(f).__name__ for f in port.forwards}
    assert "Conv" in kinds or "ConvTanh" in kinds
    for name, params in want.items():
        for k, v in params.items():
            got = port.train_step.params[name][k].numpy()
            assert got.dtype == v.dtype
            numpy.testing.assert_array_equal(got, v, err_msg=name + k)


@pytest.mark.parametrize("mode", ["auto", "input"])
def test_imagenet_ae_matches_reference(small_cifar, mode):
    ref, port = _run_pair(lambda p: _ae(p, mode))
    assert port.train_step.target_mode == ref.train_step.target_mode \
        == "input"
    assert port.decision.epoch_number == 3
    _assert_rmse_alike(ref, port, RMSE_RTOL)
    assert port.decision.best_epoch == ref.decision.best_epoch
    rmse = port.decision.epoch_metrics[VALID]
    assert rmse[-1] < rmse[0]
    res = port.gather_results()
    assert res["best_rmse"] == pytest.approx(
        ref.gather_results()["best_rmse"], rel=RMSE_RTOL)
    assert res["best_epoch"] == ref.gather_results()["best_epoch"]
    _assert_trained_alike(ref, port)


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "amp_bf16_data"])
def test_bench_workflow_matches_reference(amp):
    ref, port = _run_pair(lambda p: _bench(p, amp))
    assert port.train_step.mixed_precision is amp
    stored = port.loader.original_data.mem
    assert (stored.dtype == torch.bfloat16 if amp
            else stored.dtype == numpy.float32)
    if amp:
        _assert_rmse_alike(ref, port, AMP_RMSE_RTOL)
        _assert_trained_alike(ref, port, AMP_RTOL, AMP_ATOL)
    else:
        _assert_rmse_alike(ref, port, RMSE_RTOL)
        _assert_trained_alike(ref, port)


def test_cifar_matches_reference(small_cifar):
    ref, port = _run_pair(_cifar)
    assert [type(f).__name__ for f in port.forwards] == [
        "Conv", "MaxPooling", "ForwardStrictRelu", "ConvRelu",
        "AvgPooling", "ConvRelu", "AvgPooling", "All2All",
        "All2AllSoftmax"]
    assert port.decision.epoch_number == 2
    for cls in (TRAIN, VALID):
        numpy.testing.assert_allclose(
            port.decision.epoch_metrics[cls],
            ref.decision.epoch_metrics[cls], atol=ERR_ATOL)
    _assert_trained_alike(ref, port)


def test_remat_is_bit_identical(small_cifar):
    runs = []
    for remat in (False, True):
        prng.seed_all(14)
        wf = imagenet_ae.build_bench_workflow(
            image_size=16, minibatch_size=16, n_train=32, n_valid=16,
            remat=remat)
        wf.decision.max_epochs = 1
        _init(wf, True).run()
        runs.append(wf)
    for name, params in runs[0].train_step.params.items():
        for k, v in params.items():
            assert torch.equal(v, runs[1].train_step.params[name][k])


def test_params_from_jax_carries_a_conv_tree(small_cifar):
    ref = _init(_ae(False), False)
    ref.run()
    params = _ref_tree(ref.train_step.params)
    opt = _ref_tree(ref.train_step.opt_state)
    assert params["conv_tanh0"]["weights"].shape == (5, 5, 3, 16)
    assert "bias" not in params["deconv4"]
    port = _init(_ae(True, seed=3), True)
    assert params_from_jax(port, params, opt) is port
    for tree, want in ((port.train_step.params, params),
                       (port.train_step.opt_state, opt)):
        for name, p in want.items():
            for k, v in p.items():
                numpy.testing.assert_array_equal(tree[name][k].numpy(), v)
    for f in port.forwards:
        if f.PARAMETERIZED:
            numpy.testing.assert_array_equal(
                f.weights.map_read(), params[f.name]["weights"])


@pytest.mark.parametrize("bad", ["hwio_transposed", "deconv_bias",
                                 "opt_shape"])
def test_params_from_jax_refuses_before_writing(small_cifar, bad):
    port = _init(_ae(True), True)
    before = {n: {k: v.clone() for k, v in p.items()}
              for n, p in port.train_step.params.items()}
    tree = {n: {k: v.numpy() + 1 for k, v in p.items()}
            for n, p in before.items()}
    opt = {n: {k: v.copy() for k, v in p.items()} for n, p in tree.items()}
    if bad == "hwio_transposed":
        # an OIHW tree where HWIO is expected
        tree["conv_tanh0"]["weights"] = tree["conv_tanh0"][
            "weights"].transpose(3, 2, 0, 1)
    elif bad == "deconv_bias":
        tree["deconv4"]["bias"] = numpy.zeros(3, numpy.float32)
    else:
        opt["conv_tanh2"]["weights"] = opt["conv_tanh2"]["weights"][:-1]
    with pytest.raises(VelesError):
        params_from_jax(port, tree, opt)
    for n, p in before.items():
        for k, v in p.items():
            assert torch.equal(port.train_step.params[n][k], v)


def test_cifar_surrogate_is_the_reference_s():
    got = datasets.load_cifar10(n_train=40, n_test=20)
    want = ref_datasets.load_cifar10(n_train=40, n_test=20)
    assert not datasets.cifar10_is_real()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    assert got[0].shape == (40, 32, 32, 3)


def test_models_are_the_reference_s():
    """The model functions' graphs, layer by layer, against the
    reference's."""
    for port_wf, ref_wf in (
            (imagenet_ae.build_workflow(), REF_AE.build_workflow()),
            (imagenet_ae.build_bench_workflow(),
             REF_AE.build_bench_workflow()),
            (cifar.build_workflow(), REF_CIFAR.build_workflow())):
        assert port_wf.layers_config == ref_wf.layers_config
        assert port_wf.loss_function == ref_wf.loss_function
        assert (port_wf.loader.max_minibatch_size
                == ref_wf.loader.max_minibatch_size)
        assert port_wf.decision.max_epochs == ref_wf.decision.max_epochs
    wf = cifar.build_workflow()
    assert wf.lr_adjust.schedule(20) == pytest.approx(0.5)


def test_entry_points_default_to_the_card(monkeypatch, small_cifar):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (imagenet_ae.build_workflow,
                  imagenet_ae.build_bench_workflow, cifar.build_workflow):
        with pytest.raises(VelesError, match="CUDA"):
            build().initialize()
    for main in (imagenet_ae.main, cifar.main):
        with pytest.raises(VelesError, match="CUDA"):
            main(["--epochs", "1"])


def test_cifar_data_parallel_is_not_ported():
    with pytest.raises(VelesError, match="not ported"):
        cifar.build_workflow(data_par=2)
    with pytest.raises(VelesError, match="not ported"):
        cifar.main(["--data-par", "4", "--device", "cpu"])


def _write_batches(tmp_path, rows):
    """CIFAR-10's python layout at ``rows`` images a batch: uint8 (N,
    3072) channel-major rows and int labels, as the dataset ships."""
    import pickle
    d = tmp_path / "cifar-10-batches-py"
    d.mkdir()
    rng = numpy.random.RandomState(5)
    for name in ["data_batch_%d" % i for i in range(1, 6)] + ["test_batch"]:
        with open(d / name, "wb") as f:
            pickle.dump({b"data": rng.randint(0, 256, (rows, 3072)).astype(
                numpy.uint8), b"labels": [int(y) for y in rng.randint(
                    0, 10, rows)]}, f)
    return d


def test_load_cifar10_reads_the_pickled_batches(tmp_path, monkeypatch):
    _write_batches(tmp_path, rows=3)
    for cfg in (root, ref_root):
        monkeypatch.setattr(cfg.common.dirs, "datasets", str(tmp_path))
    assert datasets.cifar10_is_real()
    got = datasets.load_cifar10()
    want = ref_datasets.load_cifar10()
    assert got[0].shape == (15, 32, 32, 3) and got[2].shape == (3, 32, 32, 3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        numpy.testing.assert_array_equal(g, w)


def test_load_cifar10_refuses_other_pickled_objects(tmp_path, monkeypatch):
    import pickle
    d = _write_batches(tmp_path, rows=2)
    with open(d / "data_batch_1", "wb") as f:
        pickle.dump({b"data": numpy.zeros((2, 3072), numpy.uint8),
                     b"labels": [0, 1], b"x": VelesError("planted")}, f)
    monkeypatch.setattr(root.common.dirs, "datasets", str(tmp_path))
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        datasets.load_cifar10()

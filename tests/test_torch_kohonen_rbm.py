"""The port's unsupervised units (veles_tpu_torch/nn/kohonen.py, rbm.py)
and models (models/kohonen_demo.py, models/rbm_mnist.py) against the
reference's (tests/test_kohonen_rbm.py's oracles), on the CPU, from the
same inputs made from a seed with numpy:

- the Kohonen winner lookup equals the reference's ``numpy_apply``
  exactly, ties going to the first index; one batch-SOM step
  (``som_step``) and the trainer's step equal the reference's numpy
  oracle within rtol 1e-5 / atol 1e-6 (the distances' GEMM sums in
  another order), winners exactly (DemoKohonen below follows the
  reference's jitted path); the map organises (quantisation error
  below half its first after 40 steps) and its decay clock ``__time__``
  round-trips through ``state_dict`` and, with DemoKohonen, through a
  snapshot file in both directions between the packages;
- DemoKohonen at the reference's CI anchor (8 epochs, mb 100, 600 rows):
  its per-epoch quantisation errors and final weights follow the
  reference's run within rtol 1e-4 / atol 1e-5, the final error below
  the clusters' 0.25 noise radius and below the first epoch's;
- the RBM's hidden probabilities and ``cd1_step`` with the same uniforms
  equal the reference's numpy oracle within rtol 1e-5 / atol 1e-6; the
  trainer's steps draw the reference's ``numpy_run`` uniforms from the
  same seed, so 10 steps of each follow one trajectory (rtol 1e-4 /
  atol 1e-6); CD-1 training lowers the reconstruction error (below 0.7
  of its first after 200 steps, the reference's anchor);
- ``params_from_jax`` and ``random_params`` carry the Kohonen and RBM
  trees and refuse a wrong shape before writing anything;
- the new entry points run on the card unless asked for the CPU.
"""
import numpy
import pytest
import torch

import veles_tpu as vt
from veles_tpu import nn as ref_nn
from veles_tpu import prng as ref_prng
from veles_tpu.memory import Array as RefArray
from veles_tpu.nn.kohonen import som_step as ref_som_step
from veles_tpu.nn.rbm import cd1_step as ref_cd1_step
from veles_tpu_torch import datasets, prng, snapshotter
from veles_tpu_torch.convert import params_from_jax, random_params
from veles_tpu_torch.error import VelesError
from veles_tpu_torch.memory import Array
from veles_tpu_torch.models import kohonen_demo, rbm_mnist
from veles_tpu_torch.nn import kohonen, rbm
from veles_tpu_torch.workflow import Workflow

from conftest import import_model

RTOL, ATOL = 1e-5, 1e-6
RTOL_RUN, ATOL_RUN = 1e-4, 1e-5
REF_DEMO = import_model("kohonen_demo")


def ref_dev():
    return vt.XLADevice(mesh_axes={"data": 1})


def fresh(seed=1234):
    for mod in (prng, ref_prng):
        with mod._lock:
            mod._generators.clear()
        mod.seed_all(seed)


def clusters(n=96, seed=0):
    rng = numpy.random.RandomState(seed)
    centers = numpy.array([[0.0, 0.0], [4.0, 4.0], [0.0, 4.0]],
                          dtype=numpy.float32)
    x = numpy.concatenate([
        c + 0.3 * rng.randn(n // 3, 2).astype(numpy.float32)
        for c in centers])
    rng.shuffle(x)
    return x


def bars(n=64, side=4, seed=1):
    rng = numpy.random.RandomState(seed)
    x = numpy.zeros((n, side, side), dtype=numpy.float32)
    for i in range(n):
        for r in range(side):
            if rng.rand() < 0.3:
                x[i, r, :] = 1.0
    return x.reshape(n, side * side)


def pair(ref_cls, port_cls, x, **kw):
    """The reference's unit and the port's on ``x``, initialised from
    the same seed (their initial parameters are equal)."""
    fresh()
    ref = ref_cls(vt.Workflow(name="r"), name="u", **kw)
    ref.input = RefArray(x)
    ref.initialize(device=ref_dev())
    port = port_cls(Workflow(name="p"), name="u", **kw)
    port.input = Array(x)
    port.initialize(device="cpu")
    for k, v in ref.param_arrays().items():
        numpy.testing.assert_array_equal(port.param_arrays()[k].map_read(),
                                         v.map_read())
    return ref, port


def test_kohonen_forward_oracle_and_ties():
    x = clusters()
    ref, port = pair(ref_nn.KohonenForward, kohonen.KohonenForward, x,
                     shape=(4, 4))
    port.run()
    got = port.output.map_read()
    assert got.dtype == numpy.int32
    numpy.testing.assert_array_equal(got, ref.numpy_apply(ref.params_np(),
                                                          x))
    # two equal neurons: the first index wins, as argmin's
    w = numpy.zeros((4, 2), numpy.float32)
    w[1] = w[3] = [1.0, 1.0]
    pts = torch.tensor([[1.0, 1.0], [0.0, 0.0]])
    assert port.apply({"weights": torch.from_numpy(w)}, pts).tolist() \
        == [1, 0]
    assert ref.numpy_apply({"weights": w}, pts.numpy()).tolist() == [1, 0]


def test_som_step_matches_reference():
    x = clusters(30)
    u = kohonen.KohonenTrainer(None, shape=(3, 3))
    w0 = numpy.random.RandomState(4).randn(9, 2).astype(numpy.float32)
    want = ref_som_step(w0.copy(), u.grid, x, 0.4, 1.2, numpy)
    got = kohonen.som_step(torch.from_numpy(w0), torch.from_numpy(u.grid),
                           torch.from_numpy(x), 0.4, 1.2)
    numpy.testing.assert_allclose(got[0].numpy(), want[0], rtol=RTOL,
                                  atol=ATOL)
    numpy.testing.assert_array_equal(got[1].numpy(), want[1])
    assert float(got[2]) == pytest.approx(float(want[2]), rel=RTOL)
    assert got[1].dtype == torch.int32


def test_kohonen_trainer_step_matches_reference():
    x = clusters(30)
    ref, port = pair(ref_nn.KohonenTrainer, kohonen.KohonenTrainer, x,
                     shape=(3, 3))
    ref.numpy_run()
    port.run()
    assert port.time == ref.time == 1
    numpy.testing.assert_allclose(port.weights.map_read(),
                                  ref.weights.map_read(), rtol=RTOL,
                                  atol=ATOL)
    numpy.testing.assert_array_equal(port.winners, ref.winners)
    assert port.get_metric_values()["som_qerr"] == pytest.approx(
        ref.get_metric_values()["som_qerr"], rel=RTOL)


def test_kohonen_convergence_and_state_roundtrip():
    wf = Workflow(name="t")
    u = kohonen.KohonenTrainer(wf, shape=(5, 5), lr0=0.6, decay=60.0)
    u.input = Array(clusters(150))
    u.initialize(device="cpu")
    u.run()
    first = u.quantization_error
    for _ in range(40):
        u.run()
    assert u.quantization_error < first * 0.5, (first,
                                                u.quantization_error)
    assert u.get_metric_values()["som_steps"] == 41
    sd = u.state_dict()
    assert int(sd["__time__"]) == 41
    u2 = kohonen.KohonenTrainer(wf, shape=(5, 5), lr0=0.6, decay=60.0,
                                name="u2")
    u2.input = Array(clusters(150))
    u2.initialize(device="cpu")
    u2.load_state_dict(sd)
    assert u2.time == 41 and u2.schedule() == u.schedule()
    numpy.testing.assert_array_equal(u2.weights.map_read(),
                                     u.weights.map_read())


def _demo(port, epochs=8, decay=None):
    mod = kohonen_demo if port else REF_DEMO
    wf = mod.build_workflow(epochs=epochs, minibatch_size=100, n_train=600,
                            decay=decay)
    wf.initialize(device="cpu" if port else ref_dev())
    return wf


def test_kohonen_demo_follows_reference():
    fresh()
    ref = _demo(False)
    ref.run()
    port = _demo(True)
    port.run()
    want, got = ref.gather_results(), port.gather_results()
    assert got["epochs"] == want["epochs"] == 8
    numpy.testing.assert_allclose(got["qerr_history"], want["qerr_history"],
                                  rtol=RTOL_RUN, atol=ATOL_RUN)
    assert got["final_qerr"] < 0.25
    assert got["qerr_history"][-1] < got["qerr_history"][0]
    numpy.testing.assert_allclose(port.trainer.weights.map_read(),
                                  ref.trainer.weights.map_read(),
                                  rtol=RTOL_RUN, atol=ATOL_RUN)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_kohonen_demo_snapshot_crosses_packages(writer, tmp_path):
    """4 epochs, a snapshot, a resume by the other package and 4 more:
    the clock, the weights and the errors equal the writer's own 8 (one
    decay constant for all three runs: by default it scales with the
    epochs asked for)."""
    fresh()
    first = _demo(writer == "port", epochs=4, decay=24.0)
    first.run()
    snap_cls = snapshotter.Snapshotter if writer == "port" \
        else vt.Snapshotter
    snap = snap_cls(None, prefix="som", directory=str(tmp_path))
    snap.workflow = first
    first.add_ref(snap)
    path = snap.export()
    fresh()
    resumed = _demo(writer != "port", epochs=8, decay=24.0)
    (snapshotter.resume if writer != "port" else vt.resume)(resumed, path)
    assert resumed.trainer.time == first.trainer.time == 24
    resumed.decision.complete <<= False
    resumed.decision.epoch_number = 4
    resumed.run()
    fresh()
    straight = _demo(writer == "port", decay=24.0)
    straight.run()
    assert resumed.trainer.time == straight.trainer.time == 48
    numpy.testing.assert_allclose(resumed.trainer.weights.map_read(),
                                  straight.trainer.weights.map_read(),
                                  rtol=RTOL_RUN, atol=ATOL_RUN)
    numpy.testing.assert_allclose(
        resumed.trainer.quantization_error,
        straight.trainer.quantization_error, rtol=RTOL_RUN)


def test_rbm_forward_oracle():
    x = bars()
    ref, port = pair(ref_nn.RBM, rbm.RBM, x, n_hidden=12)
    port.run()
    y = port.output.map_read()
    numpy.testing.assert_allclose(y, ref.numpy_apply(ref.params_np(), x),
                                  rtol=RTOL, atol=ATOL)
    assert ((0 < y) & (y < 1)).all()
    params = {k: torch.from_numpy(v.map_read())
              for k, v in port.param_arrays().items()}
    numpy.testing.assert_allclose(
        port.reconstruct(params, torch.from_numpy(x)).numpy(),
        ref.reconstruct_np(ref.params_np(), x), rtol=RTOL, atol=ATOL)


def test_cd1_step_same_noise():
    x = bars(16)
    rng = numpy.random.RandomState(7)
    params = {"weights": (rng.randn(16, 8) * 0.1).astype(numpy.float32),
              "vbias": (rng.randn(16) * 0.1).astype(numpy.float32),
              "hbias": (rng.randn(8) * 0.1).astype(numpy.float32)}
    uni = rng.rand(16, 8).astype(numpy.float32)
    want, err = ref_cd1_step(params, x, uni, 0.2, numpy)
    got, got_err = rbm.cd1_step({k: torch.from_numpy(v) for k, v in
                                 params.items()}, torch.from_numpy(x),
                                torch.from_numpy(uni), 0.2)
    for k in params:
        numpy.testing.assert_allclose(got[k].numpy(), want[k], rtol=RTOL,
                                      atol=ATOL)
    assert float(got_err) == pytest.approx(float(err), rel=RTOL)


def test_rbm_trainer_follows_reference_host_path():
    """The port's steps draw the reference's ``numpy_run`` uniforms from
    the same keyed stream: 10 steps, one trajectory."""
    x = bars(32)
    ref, port = pair(ref_nn.RBMTrainer, rbm.RBMTrainer, x, n_hidden=8,
                     learning_rate=0.3)
    for _ in range(10):
        ref.numpy_run()
        port.run()
        assert port.reconstruction_error == pytest.approx(
            ref.reconstruction_error, rel=RTOL_RUN)
    for k, v in ref.param_arrays().items():
        numpy.testing.assert_allclose(port.param_arrays()[k].map_read(),
                                      v.map_read(), rtol=RTOL_RUN,
                                      atol=ATOL)
    assert port.get_metric_values() == {
        "rbm_reconstruction_error": port.reconstruction_error,
        "rbm_steps": 10}


def test_rbm_training_reduces_reconstruction_error():
    wf = Workflow(name="t")
    u = rbm.RBMTrainer(wf, n_hidden=16, learning_rate=0.5)
    x = bars(64)
    u.input = Array(x)
    u.initialize(device="cpu")
    u.run()
    first = u.reconstruction_error
    for _ in range(200):
        u.run()
    assert u.reconstruction_error < first * 0.7, (
        first, u.reconstruction_error)
    params = {k: torch.from_numpy(v.map_read())
              for k, v in u.param_arrays().items()}
    vhat = u.reconstruct(params, torch.from_numpy(x)).numpy()
    assert ((vhat - x) ** 2).mean() < 0.1


def test_rbm_mnist_model_learns(monkeypatch):
    """The model's loop on 640 surrogate rows of MNIST's geometry."""
    monkeypatch.setattr(rbm_mnist.datasets, "load_mnist", lambda flat: (
        datasets.load_synthetic((28, 28), 10, 640, 10, flat=flat)))
    fresh()
    wf = rbm_mnist.build_workflow(epochs=2, n_hidden=32, n_train=640)
    wf.initialize(device="cpu")
    wf.run()
    res = wf.gather_results()
    assert res["epochs"] == 2 and res["rbm_steps"] == 20
    assert res["final_error"] < res["first_error"]


def test_params_from_jax_and_random_params_carry_the_trees():
    fresh()
    demo = _demo(True, epochs=1)
    tree = random_params(demo, seed=3)
    assert sorted(tree) == ["som"]
    assert tree["som"]["weights"].shape == (36, 2)
    assert abs(float(tree["som"]["weights"].std()) - 0.05) < 0.02
    params_from_jax(demo, tree)
    numpy.testing.assert_array_equal(demo.trainer.weights.map_read(),
                                     tree["som"]["weights"])
    u = rbm.RBMTrainer(Workflow(name="t"), n_hidden=8, name="rbm")
    u.input = Array(bars(8))
    rtree = random_params([u], seed=4)
    assert {k: v.shape for k, v in rtree["rbm"].items()} == {
        "weights": (16, 8), "vbias": (16,), "hbias": (8,)}
    assert not rtree["rbm"]["vbias"].any()
    params_from_jax([u], rtree)          # before initialize: kept by it
    u.initialize(device="cpu")
    numpy.testing.assert_array_equal(u.weights.map_read(),
                                     rtree["rbm"]["weights"])
    before = {k: numpy.array(v.map_read())
              for k, v in u.param_arrays().items()}
    bad = {"rbm": dict(rtree["rbm"], hbias=numpy.zeros(9, numpy.float32),
                       weights=rtree["rbm"]["weights"] + 1)}
    with pytest.raises(VelesError, match="hbias"):
        params_from_jax([u], bad)
    for k, v in u.param_arrays().items():
        numpy.testing.assert_array_equal(v.map_read(), before[k])
    with pytest.raises(VelesError, match="missing"):
        params_from_jax(demo, {})


@pytest.mark.parametrize("main", [kohonen_demo.main, rbm_mnist.main])
def test_entry_points_default_to_the_card(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(VelesError, match="CUDA"):
        main(["--epochs", "1"])

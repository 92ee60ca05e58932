"""The port's training engine (nn/standard_workflow.py StandardWorkflow,
nn/train_step.py TrainStep, convert.py) against the reference's on the
same data and seed, on the CPU:

- the initial weights are bitwise equal under ``prng.seed_all``;
- per-epoch TRAIN/VALID/TEST error rates agree within atol 1e-5 and the
  final weights and SGD ``opt_state`` within rtol 2e-4 / atol 2e-5
  (float32; the products run in another order): the classic h = 1 loop,
  an epoch block of h = 4 with ``exp_decay``, the fused-FC route with
  momentum and decay (the port's plain version against the reference's
  Pallas kernel in interpret mode) and a 3-layer chain through it;
- the fused-FC eligibility rejections mirror the reference's;
- ``params_from_jax`` loads a trained reference tree and its
  ``opt_state`` into a port workflow, and checks before it writes;
- the entry points run on the card unless asked for the CPU.
"""
import logging

import jax
import numpy
import pytest
import torch

import veles_tpu as vt
from veles_tpu import nn as ref_nn
from veles_tpu import prng as ref_prng
from veles_tpu.config import root as ref_root
from veles_tpu.loader import FullBatchLoader as RefFullBatchLoader
from veles_tpu.loader import TEST, TRAIN, VALID
from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.convert import params_from_jax
from veles_tpu_torch.error import VelesError
from veles_tpu_torch.loader import FullBatchLoader
from veles_tpu_torch.models import mnist
from veles_tpu_torch.nn.lr_adjust import exp_decay
from veles_tpu_torch.nn.standard_workflow import StandardWorkflow

METRIC_ATOL = 1e-5
RTOL, ATOL = 2e-4, 2e-5


def _blobs():
    """tests/test_fused_fc.py's Blobs: 3 classes, 16 features, 120 train
    / 30 validation rows."""
    rng = numpy.random.RandomState(9)
    n_per, d, k = 50, 16, 3
    centers = rng.randn(k, d) * 2.5
    x = numpy.concatenate([centers[c] + rng.randn(n_per, d)
                           for c in range(k)])
    y = numpy.concatenate([numpy.full(n_per, c) for c in range(k)])
    perm = rng.permutation(len(x))
    return (x[perm].astype(numpy.float32), y[perm].astype(numpy.int32),
            [0, 30, 120])


def _blobs3():
    """tests/test_train_e2e.py's BlobsLoader, cut to 120 rows a class: 3
    classes, 10 features, 90 test / 90 validation / 180 train rows."""
    rng = numpy.random.RandomState(7)
    n_per, d, k = 120, 10, 3
    centers = rng.randn(k, d) * 3
    x = numpy.concatenate([centers[c] + rng.randn(n_per, d)
                           for c in range(k)]).astype(numpy.float32)
    y = numpy.concatenate([numpy.full(n_per, c)
                           for c in range(k)]).astype(numpy.int32)
    perm = rng.permutation(len(x))
    return x[perm], y[perm], [90, 90, 180]


DATA = {"blobs": _blobs, "blobs3": _blobs3}


def _loader_classes(data):
    def load_data(self):
        x, y, lengths = DATA[data]()
        self.create_originals(x, y)
        self.class_lengths = lengths
    ref = type("RefBlobs", (RefFullBatchLoader,),
               {"hide_from_registry": True, "load_data": load_data})
    port = type("PortBlobs", (FullBatchLoader,),
                {"hide_from_registry": True, "load_data": load_data})
    return ref, port


def _layers(hidden, solver="sgd", **gd):
    return ([{"type": "all2all_tanh", "output_sample_shape": h,
              "learning_rate": 0.05, "solver": solver, **gd}
             for h in hidden]
            + [{"type": "softmax", "output_sample_shape": 3,
                "learning_rate": 0.05, "solver": solver, **gd}])


def _build(port, data="blobs", hidden=(8,), mb=20, epochs=4, h=2,
           fused=False, schedule=None, seed=777, solver="sgd", **gd):
    """A StandardWorkflow of the reference (port=False) or the port from
    the same config and seed, built but not initialised."""
    ref_cls, port_cls = _loader_classes(data)
    if port:
        mod, cfg, wf_cls, loader_cls = prng, root, StandardWorkflow, \
            port_cls
        sched = exp_decay(schedule) if schedule else None
    else:
        mod, cfg, wf_cls, loader_cls = ref_prng, ref_root, \
            ref_nn.StandardWorkflow, ref_cls
        sched = ref_nn.exp_decay(schedule) if schedule else None
    cfg.common.engine.fused_fc_scan = fused
    mod.seed_all(seed)
    return wf_cls(
        name="parity", layers=_layers(hidden, solver, **gd),
        loader_unit=loader_cls(None, minibatch_size=mb, name="bl"),
        loss_function="softmax",
        decision_config=dict(max_epochs=epochs, fail_iterations=100),
        lr_schedule=sched, epochs_per_dispatch=h)


@pytest.fixture(autouse=True)
def _fused_flags():
    prev = (root.common.engine.get("fused_fc_scan", False),
            ref_root.common.engine.get("fused_fc_scan", False))
    yield
    root.common.engine.fused_fc_scan = prev[0]
    ref_root.common.engine.fused_fc_scan = prev[1]


def _init(wf, port):
    if port:
        wf.initialize(device="cpu")
    else:
        wf.initialize(device=vt.XLADevice(mesh_axes={"data": 1}))
    return wf


def _run_pair(**kw):
    ref = _init(_build(False, **kw), False)
    ref.run()
    port = _init(_build(True, **kw), True)
    port.run()
    return ref, port


def _ref_tree(tree):
    return {n: {k: numpy.asarray(jax.device_get(v)) for k, v in p.items()}
            for n, p in tree.items()}


def test_initial_weights_bitwise_equal():
    ref = _init(_build(False, hidden=(12, 8), seed=41), False)
    port = _init(_build(True, hidden=(12, 8), seed=41), True)
    want = _ref_tree(ref.train_step.params)
    assert sorted(want) == sorted(port.train_step.params)
    for name, params in want.items():
        for k, v in params.items():
            got = port.train_step.params[name][k].numpy()
            assert got.dtype == v.dtype
            numpy.testing.assert_array_equal(got, v, err_msg=name + k)


@pytest.mark.parametrize("case,kw", [
    ("classic_h1", dict(data="blobs3", hidden=(16,), mb=50, epochs=4,
                        h=1)),
    ("block_h4_exp_decay", dict(data="blobs3", hidden=(16,), mb=50,
                                epochs=8, h=4, schedule=0.95)),
    ("fused_momentum_decay", dict(fused=True, momentum=0.9,
                                  weights_decay=1e-3)),
    ("fused_three_layer", dict(fused=True, hidden=(12, 8), epochs=6,
                               seed=5)),
])
def test_workflow_matches_reference(case, kw):
    ref, port = _run_pair(**kw)
    fused = bool(kw.get("fused"))
    assert port.train_step._fused_fc_active is fused
    # the reference sets the flag in epoch blocks only
    assert bool(getattr(ref.train_step, "_fused_fc_active", False)) is fused
    assert port.decision.epoch_number == ref.decision.epoch_number \
        == kw.get("epochs", 4)
    for cls in (TRAIN, VALID, TEST):
        numpy.testing.assert_allclose(
            port.decision.epoch_metrics[cls],
            ref.decision.epoch_metrics[cls], atol=METRIC_ATOL,
            err_msg="%s set %d" % (case, cls))
    assert port.decision.best_epoch == ref.decision.best_epoch
    for attr in ("params", "opt_state"):
        want = _ref_tree(getattr(ref.train_step, attr))
        got = getattr(port.train_step, attr)
        assert sorted(want) == sorted(got)
        for name, params in want.items():
            for k, v in params.items():
                numpy.testing.assert_allclose(
                    got[name][k].numpy(), v, rtol=RTOL, atol=ATOL,
                    err_msg="%s %s %s.%s" % (case, attr, name, k))
    # the trained params reach the forwards' host arrays at stop
    for f in port.forwards:
        numpy.testing.assert_array_equal(
            f.weights.map_read(), port.train_step.params[f.name][
                "weights"].numpy())


def _rejections(caplog):
    return [r.getMessage() for r in caplog.records
            if "ineligible" in r.getMessage()]


@pytest.mark.parametrize("case,kw,engaged,why", [
    ("partial_batches", dict(mb=25), True, None),
    ("over_budget", dict(hidden=(2048, 2048)), False,
     "shared-memory budget"),
    ("per_layer_act_scales", dict(hidden=(12, 8)), False, "(A, B)"),
])
def test_eligibility_mirrors_reference(caplog, case, kw, engaged, why):
    wfs = [_build(port, fused=True, epochs=1, **kw) for port in (False,
                                                                 True)]
    if case == "per_layer_act_scales":
        for wf in wfs:
            wf.forwards[1].A = 1.0   # an instance override on one layer
    with caplog.at_level(logging.INFO):
        ref = _init(wfs[0], False)
        port = _init(wfs[1], True)
    assert (ref.train_step._fused_fc is not None) is engaged
    assert (port.train_step._fused_fc is not None) is engaged
    if why:
        assert any(why in m for m in _rejections(caplog))
    if case == "partial_batches":
        # 120 % 25 != 0: the padded tail batch keeps the general path
        ref.run()
        port.run()
        assert not ref.train_step._fused_fc_active
        assert not port.train_step._fused_fc_active
        numpy.testing.assert_allclose(
            port.decision.epoch_metrics[VALID],
            ref.decision.epoch_metrics[VALID], atol=METRIC_ATOL)


def test_fused_fc_without_an_epoch_block_says_why(caplog):
    """At epochs_per_dispatch 1 the chain is eligible, but no epoch block
    runs the kernel: the log says the general path trains."""
    with caplog.at_level(logging.INFO):
        wf = _init(_build(True, fused=True, epochs=1, h=1), True)
        wf.run()
    assert wf.train_step._fused_fc is not None
    assert not wf.train_step._fused_fc_active
    assert any("general path trains every epoch" in r.getMessage()
               for r in caplog.records)


@pytest.mark.parametrize("per_dispatch", ["1", "0"])
def test_mnist_main_refuses_fused_fc_without_a_block(per_dispatch):
    with pytest.raises(SystemExit):
        mnist.main(["--fused-fc", "--epochs-per-dispatch", per_dispatch,
                    "--device", "cpu"])


def test_eligibility_rejects_non_sgd_solver(caplog):
    ref = _init(_build(False, fused=True, epochs=1, solver="adam"), False)
    assert ref.train_step._fused_fc is None
    with caplog.at_level(logging.INFO):
        # the port rejects the fused path as the reference does, and
        # trains on the general path with adam
        port = _init(_build(True, fused=True, epochs=1, solver="adam"),
                     True)
    assert port.train_step._fused_fc is None
    assert any("Znicz SGD only" in m for m in _rejections(caplog))


def test_params_from_jax_round_trip():
    ref = _init(_build(False, epochs=2, momentum=0.9), False)
    ref.run()
    params = _ref_tree(ref.train_step.params)
    opt = _ref_tree(ref.train_step.opt_state)
    port = _init(_build(True, epochs=2, momentum=0.9, seed=1), True)
    assert params_from_jax(port, params, opt) is port
    for tree, want in ((port.train_step.params, params),
                       (port.train_step.opt_state, opt)):
        for name, p in want.items():
            for k, v in p.items():
                numpy.testing.assert_array_equal(tree[name][k].numpy(), v)
    for f in port.forwards:
        numpy.testing.assert_array_equal(f.weights.map_read(),
                                         params[f.name]["weights"])


@pytest.mark.parametrize("bad", ["unit", "param", "shape", "opt_shape"])
def test_params_from_jax_checks_before_writing(bad):
    port = _init(_build(True, epochs=1), True)
    before = {n: {k: v.clone() for k, v in p.items()}
              for n, p in port.train_step.params.items()}
    tree = {n: {k: v.numpy() + 1 for k, v in p.items()}
            for n, p in before.items()}
    opt = {n: {k: v.copy() for k, v in p.items()} for n, p in tree.items()}
    first = sorted(tree)[0]
    if bad == "unit":
        tree["nope"] = tree.pop(first)
    elif bad == "param":
        tree[first]["scale"] = tree[first].pop("bias")
    elif bad == "shape":
        tree[first]["weights"] = tree[first]["weights"][:, :-1]
    else:
        opt[first]["bias"] = opt[first]["bias"][:-1]
    with pytest.raises(VelesError):
        params_from_jax(port, tree, opt)
    for n, p in before.items():
        for k, v in p.items():
            assert torch.equal(port.train_step.params[n][k], v)


def test_params_from_jax_needs_an_initialised_workflow():
    with pytest.raises(VelesError, match="initialize"):
        params_from_jax(_build(True), {})


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(VelesError):
        _build(True).initialize()
    with pytest.raises(VelesError):
        mnist.main(["--epochs", "1"])


def test_mnist_workflow_is_baseline_one():
    """models/mnist.py's graph: 784 → 100 tanh → 10 softmax, mb 100,
    exp_decay(0.98), the fused kernel eligible."""
    root.common.engine.fused_fc_scan = True
    wf = mnist.build_workflow(epochs=1, epochs_per_dispatch=4)
    assert [type(f).__name__ for f in wf.forwards] == ["All2AllTanh",
                                                       "All2AllSoftmax"]
    assert [f.neurons_number for f in wf.forwards] == [100, 10]
    assert wf.loader.max_minibatch_size == 100
    assert wf.lr_adjust.schedule(1) == pytest.approx(0.98)
    assert wf.train_step.epochs_per_dispatch == 4

"""The port's training-library knobs against the reference's, on the CPU:
LoRA (nn/nn_units.py ``lora_rank``/``lora_alpha``/``freeze_base``,
``merged_params``, ``export_param_arrays``, the frozen GD update, the
optimiser state grown on resume), label smoothing and the confusion
matrix (nn/evaluator.py, ``StandardWorkflow(evaluator_config=)``, the
decision's array metrics) and the fused epilogue
(``engine.fused_epilogue``, ops/fused_fc.py):

- LoRA init is the identity (B = 0; A drawn from the unit's keyed
  stream, bitwise the reference's); the base stays bit for bit while
  the adapters move; adam training with ``lora_rank`` follows the
  reference's trajectory (errors within 1e-5, the adapters within
  rtol 2e-4 / atol 2e-5); ``export_param_arrays`` of the same trained
  tree within 1e-6 of the reference's; a unit without LoRA targets
  refuses; a base snapshot resumed into a ``lora_rank`` config keeps
  the snapshot's base exactly and grows zero adapter state;
- the smoothed loss and ``numpy_loss`` within 1e-6 relative of the
  reference's; the confusion matrix equal to the reference's exactly,
  and through training its sum is n_samples and its off-diagonal n_err
  for every set and epoch; smoothing through ``evaluator_config`` trains
  on the reference's trajectory;
- the epilogue on against off: the same bits, on a chain with
  standalone activation units; its plan and ``install_epilogues`` equal
  the reference's;
- the fused-FC kernel refuses tensormon, smoothing, confusion, LoRA and
  ``freeze_base`` with the reference's reasons.
"""
import logging

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

import veles_tpu as vt
from veles_tpu import nn as ref_nn
from veles_tpu import prng as ref_prng
from veles_tpu.config import root as ref_root
from veles_tpu.loader import FullBatchLoader as RefFullBatchLoader
from veles_tpu.memory import Array as RefArray
from veles_tpu.nn import evaluator as ref_evaluator
from veles_tpu.ops import fused_fc as ref_ff
from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.convert import params_from_jax
from veles_tpu_torch.error import VelesError
from veles_tpu_torch.loader import FullBatchLoader
from veles_tpu_torch.memory import Array
from veles_tpu_torch.nn import all2all, evaluator
from veles_tpu_torch.nn.standard_workflow import StandardWorkflow
from veles_tpu_torch.ops import fused_fc as ff
from veles_tpu_torch.snapshotter import Snapshotter, resume
from veles_tpu_torch.workflow import Workflow

METRIC_ATOL = 1e-5
RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(autouse=True)
def _engine():
    keys = ("fused_fc_scan", "fused_epilogue")
    prev = [(c, k, c.common.engine.get(k, False))
            for c in (root, ref_root) for k in keys]
    yield
    for cfg, k, v in prev:
        setattr(cfg.common.engine, k, v)
    root.common.telemetry.tensormon.enabled = False


def _blobs(self):
    """tests/test_lora.py's BlobsLoader."""
    rng = numpy.random.RandomState(3)
    n_per, d, k = 100, 12, 3
    centers = rng.randn(k, d) * 2.5
    data = numpy.concatenate(
        [centers[c] + rng.randn(n_per, d) for c in range(k)])
    labels = numpy.concatenate([numpy.full(n_per, c) for c in range(k)])
    perm = rng.permutation(len(data))
    self.create_originals(data[perm].astype(numpy.float32),
                          labels[perm].astype(numpy.int32))
    self.class_lengths = [0, 75, 225]


def _wf(port, epochs=3, name="lora", seed=41, layers=None,
        evaluator_config=None, h=1, snapshotter=None, **layer_extra):
    base = FullBatchLoader if port else RefFullBatchLoader
    loader = type("Blobs", (base,), {"hide_from_registry": True,
                                     "load_data": _blobs})(
        None, minibatch_size=25, name=name + "-l")
    (prng if port else ref_prng).seed_all(seed)
    if layers is None:
        layers = [{"type": "all2all_tanh", "output_sample_shape": 16,
                   "solver": "adam", "learning_rate": 0.01, "name": "fc0",
                   **layer_extra},
                  {"type": "softmax", "output_sample_shape": 3,
                   "solver": "adam", "learning_rate": 0.01, "name": "head",
                   **layer_extra}]
    cls = StandardWorkflow if port else ref_nn.StandardWorkflow
    wf = cls(name=name, layers=layers, loader_unit=loader,
             loss_function="softmax",
             decision_config=dict(max_epochs=epochs, fail_iterations=100),
             evaluator_config=evaluator_config, epochs_per_dispatch=h,
             snapshotter_unit=snapshotter)
    wf.initialize(device="cpu" if port
                  else vt.XLADevice(mesh_axes={"data": 1}))
    return wf


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return numpy.asarray(jax.device_get(tree))


def _close(got, want, what):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _close(got[k], want[k], "%s/%s" % (what, k))
    elif numpy.issubdtype(numpy.asarray(want).dtype, numpy.integer):
        numpy.testing.assert_array_equal(got, want, err_msg=what)
    else:
        numpy.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                      err_msg=what)


def test_lora_init_is_the_identity_and_draws_the_reference_adapters():
    x = numpy.random.RandomState(0).randn(5, 12).astype("float32")
    prng.seed_all(77)
    u = all2all.All2All(Workflow(name="id"), output_sample_shape=8,
                        name="fc")
    u.input = Array(x)
    u.initialize(device="cpu")
    prng.seed_all(77)
    u2 = all2all.All2All(Workflow(name="id2"), output_sample_shape=8,
                         name="fc", lora_rank=4)
    u2.input = Array(x)
    u2.initialize(device="cpu")
    assert u2.freeze_base and u2.lora_alpha == 4.0
    p = {k: torch.from_numpy(v.mem) for k, v in u.param_arrays().items()}
    p2 = {k: torch.from_numpy(v.mem) for k, v in u2.param_arrays().items()}
    assert sorted(p2) == ["bias", "weights", "weights_lora_a",
                          "weights_lora_b"]
    assert float(p2["weights_lora_b"].abs().max()) == 0.0
    xt = torch.from_numpy(x)
    assert torch.equal(u2.apply(p2, xt), u.apply(p, xt))
    ref_prng.seed_all(77)
    r = ref_nn.All2All(vt.Workflow(name="rid"), output_sample_shape=8,
                       name="fc", lora_rank=4)
    r.input = RefArray(x)
    r.initialize(device=vt.XLADevice(mesh_axes={"data": 1}))
    for k, v in r.params_np().items():
        numpy.testing.assert_array_equal(p2[k].numpy(), v, err_msg=k)


def test_lora_training_freezes_the_base_and_follows_the_reference():
    ref = _wf(False, lora_rank=4)
    port = _wf(True, lora_rank=4)
    before = _np(port.train_step.params)
    numpy.testing.assert_array_equal(
        before["fc0"]["weights_lora_a"],
        _np(ref.train_step.params)["fc0"]["weights_lora_a"])
    ref.run()
    port.run()
    after = _np(port.train_step.params)
    for n, tree in after.items():
        for k, v in tree.items():
            same = numpy.array_equal(v, before[n][k])
            if k.endswith("_lora_b"):
                assert not same, (n, k)
            elif not k.endswith("_lora_a"):
                assert same, (n, k)
    for cls in (1, 2):
        numpy.testing.assert_allclose(port.decision.epoch_metrics[cls],
                                      ref.decision.epoch_metrics[cls],
                                      atol=METRIC_ATOL)
    _close(after, _np(ref.train_step.params), "params")
    _close(_np(port.train_step.opt_state), _np(ref.train_step.opt_state),
           "opt_state")


def test_export_param_arrays_equals_the_reference():
    ref = _wf(False, epochs=2, lora_rank=4, lora_alpha=8)
    ref.run()
    port = _wf(True, epochs=2, lora_rank=4, lora_alpha=8)
    params_from_jax(port, _np(ref.train_step.params))
    for f, rf in zip(port.forwards, ref.forwards):
        got = {k: v.mem for k, v in f.export_param_arrays().items()}
        want = {k: numpy.asarray(v.map_read())
                for k, v in rf.export_param_arrays().items()}
        assert sorted(got) == sorted(want) == ["bias", "weights"]
        for k in want:
            numpy.testing.assert_allclose(got[k], want[k], rtol=0,
                                          atol=1e-6, err_msg=k)
        assert not numpy.array_equal(got["weights"], f.weights.mem)


def test_a_unit_without_lora_targets_refuses():
    layers = [{"type": "all2all_tanh", "output_sample_shape": 4},
              {"type": "ssm_block", "n_heads": 2, "lora_rank": 4},
              {"type": "softmax", "output_sample_shape": 3}]
    with pytest.raises(VelesError, match="LORA_TARGET"):
        _wf(True, layers=[dict(layers[0], output_sample_shape=12)]
            + layers[1:2] + layers[2:], name="badlora")


def test_base_snapshot_resumed_into_lora(tmp_path):
    base = _wf(True, epochs=2, name="base",
               snapshotter=Snapshotter(None, prefix="lorab",
                                       directory=str(tmp_path)))
    base.run()
    path = base.snapshotter.destination
    base_w = _np(base.train_step.params)
    ft = _wf(True, epochs=4, name="base", seed=10, lora_rank=4)
    resume(ft, path)
    ft.decision.complete <<= False
    opt = ft.train_step.opt_state["fc0"]
    assert sorted(opt["m"]) == ["bias", "weights", "weights_lora_a",
                                "weights_lora_b"]
    assert float(opt["m"]["weights_lora_a"].abs().max()) == 0.0
    numpy.testing.assert_array_equal(_np(opt["m"]["weights"]),
                                     _np(base.train_step.opt_state)[
                                         "fc0"]["m"]["weights"])
    ft.run()
    after = _np(ft.train_step.params)
    for n in ("fc0", "head"):
        for k in ("weights", "bias"):
            numpy.testing.assert_array_equal(after[n][k], base_w[n][k])
        assert float(numpy.abs(after[n]["weights_lora_b"]).max()) > 0


@pytest.mark.parametrize("eps", [0.0, 0.1, 0.35])
def test_smoothed_loss_and_numpy_loss_equal_the_reference(eps):
    rng = numpy.random.RandomState(4)
    logits = (rng.randn(32, 5) * 3).astype(numpy.float32)
    labels = rng.randint(0, 5, 32).astype(numpy.int32)
    mask = numpy.ones(32, numpy.float32)
    mask[-5:] = 0
    ev = evaluator.EvaluatorSoftmax(None, n_classes=5, label_smoothing=eps,
                                    compute_confusion=True)
    rev = ref_evaluator.EvaluatorSoftmax(None, n_classes=5,
                                         label_smoothing=eps,
                                         compute_confusion=True)
    got = float(ev.loss(torch.from_numpy(logits), torch.from_numpy(labels),
                        torch.from_numpy(mask)))
    want = float(rev.loss(jnp.asarray(logits), jnp.asarray(labels),
                          jnp.asarray(mask)))
    assert got == pytest.approx(want, rel=1e-6)
    assert ev.numpy_loss(logits, labels, mask) == pytest.approx(
        rev.numpy_loss(logits, labels, mask), rel=1e-6)
    assert ev.numpy_loss(logits, labels, mask) == pytest.approx(got,
                                                                rel=1e-6)
    m = ev.metrics_fn(torch.from_numpy(logits), torch.from_numpy(labels),
                      torch.from_numpy(mask))
    rm = jax.device_get(rev.metrics_fn(jnp.asarray(logits),
                                       jnp.asarray(labels),
                                       jnp.asarray(mask)))
    numpy.testing.assert_array_equal(m["confusion"].numpy(),
                                     numpy.asarray(rm["confusion"]))
    assert float(m["n_err"]) == float(rm["n_err"])
    with pytest.raises(ValueError):
        evaluator.EvaluatorSoftmax(None, label_smoothing=1.0)


def test_smoothing_and_confusion_through_training():
    cfg = dict(label_smoothing=0.1, compute_confusion=True)
    ref = _wf(False, evaluator_config=cfg, layers=[
        {"type": "all2all_tanh", "output_sample_shape": 16,
         "learning_rate": 0.05},
        {"type": "softmax", "output_sample_shape": 3,
         "learning_rate": 0.05}])
    port = _wf(True, evaluator_config=cfg, h=3, layers=[
        {"type": "all2all_tanh", "output_sample_shape": 16,
         "learning_rate": 0.05},
        {"type": "softmax", "output_sample_shape": 3,
         "learning_rate": 0.05}])
    assert port.evaluator.label_smoothing == 0.1
    ref.run()
    port.run()
    for cls in (1, 2):
        numpy.testing.assert_allclose(port.decision.epoch_metrics[cls],
                                      ref.decision.epoch_metrics[cls],
                                      atol=METRIC_ATOL)
        cms = port.decision.epoch_confusion[cls]
        assert len(cms) == 3
        for cm, (n, err) in zip(cms, port.decision.epoch_counts[cls]):
            assert cm.shape == (3, 3)
            assert cm.sum() == n
            assert cm.sum() - numpy.trace(cm) == err
    _close(_np(port.train_step.params), _np(ref.train_step.params),
           "params")


def _act_chain(port, epochs=2):
    layers = [{"type": "all2all", "output_sample_shape": 16,
               "learning_rate": 0.05, "name": "fc0"},
              {"type": "activation_mul", "factor": 0.5},
              {"type": "activation_tanh"},
              {"type": "all2all", "output_sample_shape": 8,
               "learning_rate": 0.05, "name": "fc1"},
              {"type": "activation_str"},
              {"type": "softmax", "output_sample_shape": 3,
               "learning_rate": 0.05, "name": "head"}]
    return _wf(port, epochs=epochs, layers=layers, h=2)


def test_fused_epilogue_on_equals_off_bit_for_bit():
    root.common.engine.fused_epilogue = False
    off = _act_chain(True)
    off.run()
    root.common.engine.fused_epilogue = True
    root.common.telemetry.tensormon.enabled = True
    on = _act_chain(True)
    assert [(p.name, [t.name for t in ts])
            for p, ts in on.train_step._epilogue] == \
        [("fc0", ["activation_mul1", "activation_tanh2"]),
         ("fc1", ["activation_str4"])]
    on.run()
    for n in off.train_step.params:
        for k in off.train_step.params[n]:
            assert torch.equal(on.train_step.params[n][k],
                               off.train_step.params[n][k])
    assert on.decision.epoch_metrics == off.decision.epoch_metrics
    ref_root.common.engine.fused_epilogue = True
    ref = _act_chain(False)
    assert [(p.name, [t.name for t in ts])
            for p, ts in ref_ff.plan_epilogues(ref.forwards)] == \
        [(p.name, [t.name for t in ts])
         for p, ts in ff.plan_epilogues(on.forwards)]


def test_install_epilogues_runs_a_standalone_chain_in_fewer_runs():
    root.common.engine.fused_epilogue = True
    wf = _act_chain(True, epochs=1)
    wf.run()
    wf.train_step.sync_params_to_arrays()
    x = torch.from_numpy(wf.loader.original_data.mem[:6].copy())
    expect = x
    for f in wf.forwards[:-1]:
        p = {k: torch.from_numpy(v.mem) for k, v in
             f.param_arrays().items()}
        expect = f.apply(p, expect)
    plan = ff.install_epilogues(wf.forwards)
    assert plan == {"fc0": ["activation_mul1", "activation_tanh2"],
                    "fc1": ["activation_str4"]}
    wf.forwards[0].input = Array(x.numpy())
    for f in wf.forwards[:-1]:
        if f is not wf.forwards[0]:
            f.input = wf.forwards[wf.forwards.index(f) - 1].output
        f.torch_run()
    assert torch.equal(torch.as_tensor(wf.forwards[-2].output.map_read()),
                       expect)
    root.common.engine.fused_epilogue = False
    assert ff.install_epilogues(wf.forwards) == {}
    assert not any(getattr(f, "_epilogue_folded", False)
                   for f in wf.forwards)


@pytest.mark.parametrize("knob", ["tensormon", "label_smoothing",
                                  "compute_confusion", "lora_rank",
                                  "freeze_base"])
def test_fused_fc_refuses_each_knob_with_the_reference_reason(knob,
                                                              caplog):
    root.common.engine.fused_fc_scan = True
    ref_root.common.engine.fused_fc_scan = True
    extra, cfg = {}, None
    if knob == "tensormon":
        root.common.telemetry.tensormon.enabled = True
        ref_root.common.telemetry.tensormon.enabled = True
    elif knob in ("label_smoothing", "compute_confusion"):
        cfg = {knob: 0.1 if knob == "label_smoothing" else True}
    elif knob == "lora_rank":
        extra = dict(lora_rank=2)
    else:
        extra = dict(freeze_base=True)
    layers = [{"type": "all2all_tanh", "output_sample_shape": 16,
               "learning_rate": 0.05, **extra},
              {"type": "softmax", "output_sample_shape": 3,
               "learning_rate": 0.05, **extra}]
    try:
        with caplog.at_level(logging.INFO):
            port = _wf(True, layers=layers, evaluator_config=cfg, h=2)
            ref = _wf(False, layers=layers, evaluator_config=cfg, h=2)
    finally:
        ref_root.common.telemetry.tensormon.enabled = False
    assert port.train_step._fused_fc is None
    assert ref.train_step._fused_fc is None
    reasons = [r.getMessage() for r in caplog.records
               if "fused_fc_scan requested but ineligible" in r.getMessage()]
    assert len(reasons) == 2 and reasons[0] == reasons[1], reasons

"""The port's model-health taps (telemetry/tensormon.py, the train step's
taps, the counters, ``--tensormon``/``--nan-policy``) against the
reference's, on the CPU:

- ``step_stats`` on the same parameters, updates, gradients, loss and
  head output: every statistic within 1e-5 relative of the reference's;
  ``zero_stats`` has its keys;
- monitoring off against on: the port's parameters and optimiser state
  equal bit for bit, one sample per epoch, none when off, and the off
  run's accumulators carry no ``mon_`` key;
- the monitor's per-epoch statistics from the same blobs and seed
  (the reference's tests/test_tensormon.py load) within 1e-4 relative
  of the reference's;
- the three NaN policies on the reference's poisoned blobs behave as
  the reference's: ``warn`` counts and completes, ``halt`` raises
  ``ModelHealthError`` with ``/readyz`` 503 and ``model_health`` False,
  ``snapshot_and_halt`` leaves exactly one committed snapshot that
  ``checkpoint_chain.verify`` accepts and one black box whose reason
  starts with "nan sentinel" and which holds a ``tensormon.nan`` event;
- the gauges render on ``counters.metrics_text`` with the reference's
  HELP strings; ``every`` throttles the spans; a bad policy raises;
- the CLI's ``--tensormon`` and ``--nan-policy`` set the config.
"""
import glob

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
from veles_tpu.telemetry import monitor as ref_monitor
from veles_tpu.telemetry import tensormon as ref_tensormon
from veles_tpu.telemetry.counters import DESCRIPTIONS as REF_HELP
from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.error import VelesError
from veles_tpu_torch.loader import FullBatchLoader
from veles_tpu_torch.nn.standard_workflow import StandardWorkflow
from veles_tpu_torch.resilience import checkpoint_chain, health
from veles_tpu_torch.snapshotter import Snapshotter
from veles_tpu_torch.telemetry import counters, spans, tensormon
from veles_tpu_torch.telemetry.recorder import flight, read_blackbox

STATS_RTOL = 1e-5
SAMPLE_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _reset(tmp_path):
    flight.clear()
    tensormon.monitor.reset()
    ref_monitor.reset()
    prev = (root.common.dirs.snapshots, ref_root.common.dirs.snapshots)
    root.common.dirs.snapshots = str(tmp_path / "snapdir")
    ref_root.common.dirs.snapshots = str(tmp_path / "ref_snapdir")
    yield
    root.common.dirs.snapshots, ref_root.common.dirs.snapshots = prev
    for cfg in (root, ref_root):
        cfg.common.telemetry.tensormon.enabled = False
        cfg.common.telemetry.tensormon.nan_policy = "warn"
        cfg.common.telemetry.tensormon.every = 1
    tensormon.monitor.reset()
    ref_monitor.reset()
    health.forget("model_health")


def _blobs(self):
    rng = numpy.random.RandomState(7)
    data = rng.randn(120, 10).astype(numpy.float32)
    labels = (data.sum(axis=1) > 0).astype(numpy.int32)
    self.create_originals(data, labels)
    self.class_lengths = [0, 40, 80]


def _run(port=True, enabled=False, policy="warn", poison=False,
         snapshot_dir=None, epochs=3, every=1, h=1):
    """The reference's tests/test_tensormon.py workflow on either
    package."""
    cfg = root if port else ref_root
    cfg.common.telemetry.tensormon.enabled = enabled
    cfg.common.telemetry.tensormon.nan_policy = policy
    cfg.common.telemetry.tensormon.every = every
    base = FullBatchLoader if port else RefFullBatchLoader
    loader_cls = type("Blobs", (base,), {"hide_from_registry": True,
                                         "load_data": _blobs})
    (prng if port else ref_prng).seed_all(1234)
    snap = None
    if snapshot_dir is not None:
        snap = (Snapshotter if port else vt.Snapshotter)(
            None, prefix="mon", directory=str(snapshot_dir), interval=1)
    wf_cls = StandardWorkflow if port else ref_nn.StandardWorkflow
    wf = wf_cls(
        name="mon-wf",
        layers=[{"type": "all2all_tanh", "output_sample_shape": 8},
                {"type": "softmax", "output_sample_shape": 2}],
        loader_unit=loader_cls(None, minibatch_size=40, name="mon-blobs"),
        loss_function="softmax",
        decision_config=dict(max_epochs=epochs, fail_iterations=100),
        snapshotter_unit=snap, epochs_per_dispatch=h)
    wf.initialize(device="cpu" if port
                  else vt.XLADevice(mesh_axes={"data": 1}))
    if poison:
        wf.loader.original_data.mem[:, :] = numpy.nan
    wf.run()
    return wf


def test_step_stats_equal_the_reference():
    rng = numpy.random.RandomState(0)
    shapes = {"fc0": {"weights": (10, 8), "bias": (8,)},
              "head": {"weights": (8, 3), "bias": (3,)}}

    def tree():
        return {n: {k: rng.randn(*s).astype(numpy.float32)
                    for k, s in p.items()} for n, p in shapes.items()}
    params, new, grads = tree(), tree(), tree()
    grads["fc0"]["bias"][2] = numpy.nan
    out = (rng.randn(16, 3) * 5).astype(numpy.float32)
    out[0, 0] = numpy.inf
    loss = numpy.float32(0.75)

    def t(x):
        return {n: {k: torch.from_numpy(v) for k, v in p.items()}
                for n, p in x.items()}
    got = tensormon.step_stats(t(params), t(new), t(grads),
                               torch.tensor(loss), torch.from_numpy(out),
                               sat_threshold=4.0)
    want = jax.device_get(ref_tensormon.step_stats(
        params, new, grads, jnp.float32(loss), jnp.asarray(out),
        sat_threshold=4.0))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].dim() == 0, k
        numpy.testing.assert_allclose(float(got[k]), float(want[k]),
                                      rtol=STATS_RTOL, err_msg=k)
    assert float(got["mon_nan"]) == 2.0
    # the accumulation path: no head output, saturation reads 0
    got = tensormon.step_stats(t(params), t(new), t(grads),
                               torch.tensor(loss))
    assert float(got["mon_sat"]) == float(got["mon_act_n"]) == 0.0
    zero = tensormon.zero_stats(shapes)
    assert sorted(zero) == sorted(ref_tensormon.zero_stats(shapes))
    assert all(float(v) == 0.0 for v in zero.values())


@pytest.mark.parametrize("h", [1, 3], ids=["classic", "epoch_block"])
def test_off_and_on_train_the_same_bits(h):
    before = counters.snapshot()
    off = _run(enabled=False, h=h)
    d_off = counters.counters.delta(before)
    before = counters.snapshot()
    on = _run(enabled=True, h=h)
    d_on = counters.counters.delta(before)
    for tree in ("params", "opt_state"):
        a, b = getattr(off.train_step, tree), getattr(on.train_step, tree)
        for n in a:
            for k in a[n]:
                assert torch.equal(a[n][k], b[n][k]), (tree, n, k)
    assert off.decision.epoch_metrics == on.decision.epoch_metrics
    assert not d_off.get("veles_tensormon_samples_total")
    assert d_on.get("veles_tensormon_samples_total") == 3
    assert not any(k.startswith("mon_")
                   for k in off.train_step._zero_accum(mon=True))
    assert any(k.startswith("mon_")
               for k in on.train_step._zero_accum(mon=True))


def test_samples_equal_the_reference():
    """The last drained sample's statistics and per-layer gauges of the
    same 3-epoch run on both packages."""
    _run(port=False, enabled=True)
    _run(port=True, enabled=True)
    want, got = ref_monitor.last_sample(), tensormon.monitor.last_sample()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=SAMPLE_RTOL, abs=1e-9)
    g_want, g_got = ref_monitor.gauges(), tensormon.monitor.gauges()
    assert sorted(g_got) == sorted(g_want)
    for k, (v, help_text) in g_want.items():
        assert g_got[k][1] == help_text
        assert g_got[k][0] == pytest.approx(v, rel=SAMPLE_RTOL, abs=1e-9)


def test_gauges_render_and_every_throttles_spans():
    spans.recorder.clear()
    _run(enabled=True, epochs=4, every=2)
    assert len(spans.recorder.records("tensormon.sample")) == 2
    assert len(flight.records("tensormon")) == 2
    text = counters.metrics_text(tensormon.monitor.gauges())
    for name in ("veles_model_grad_norm", "veles_model_act_saturation",
                 "veles_model_weight_norm_all2all_tanh0",
                 "veles_model_update_ratio_softmax1",
                 "veles_tensormon_samples_total"):
        assert "\n%s " % name in text, name
    for name in ("veles_tensormon_samples_total", "veles_model_nan_total",
                 "veles_model_health_errors_total"):
        assert counters.describe_counter(name) == REF_HELP[name]


def test_bad_policy_raises():
    root.common.telemetry.tensormon.nan_policy = "explode"
    with pytest.raises(VelesError, match="nan_policy"):
        tensormon.settings()


def test_nan_warn_policy_counts_and_completes():
    before = counters.snapshot()
    wf = _run(enabled=True, poison=True, policy="warn")
    delta = counters.counters.delta(before)
    assert delta.get("veles_model_nan_total", 0) > 0
    assert not delta.get("veles_model_health_errors_total")
    assert wf.decision.epoch_number == 3
    text = counters.metrics_text(tensormon.monitor.gauges())
    line = next(ln for ln in text.splitlines()
                if ln.startswith("veles_model_nan_total "))
    assert float(line.split()[1]) > 0


def test_nan_halt_policy_raises_and_marks_health_unready():
    with pytest.raises(tensormon.ModelHealthError):
        _run(enabled=True, poison=True, policy="halt")
    code, payload = health.readyz()
    assert code == 503
    assert payload["components"]["model_health"] is False
    assert counters.get("veles_model_health_errors_total") >= 1


def test_nan_snapshot_and_halt_commits_one_snapshot_and_a_blackbox(
        tmp_path):
    root.common.dirs.snapshots = str(tmp_path)
    with pytest.raises(tensormon.ModelHealthError) as excinfo:
        _run(enabled=True, poison=True, policy="snapshot_and_halt",
             snapshot_dir=tmp_path)
    snaps = checkpoint_chain.chain(str(tmp_path), "mon")
    assert len(snaps) == 1
    assert checkpoint_chain.verify(snaps[0]) is True
    assert "forensic snapshot" in str(excinfo.value)
    dumps = glob.glob(str(tmp_path / "blackbox-*.jsonl"))
    assert len(dumps) == 1
    header, events = read_blackbox(dumps[0])
    assert header["reason"].startswith("nan sentinel")
    assert "tensormon.nan" in {e.get("kind") for e in events}


def test_cli_flags_turn_the_taps_on(tmp_path):
    from veles_tpu_torch.__main__ import main
    model = tmp_path / "model.py"
    model.write_text("def build_workflow():\n    raise SystemExit(0)\n")
    prev = root.common.telemetry.tensormon.get("enabled", False)
    try:
        for flags, policy in ((["--tensormon"], "warn"),
                              (["--nan-policy", "halt"], "halt")):
            root.common.telemetry.tensormon.enabled = False
            root.common.telemetry.tensormon.nan_policy = "warn"
            main([str(model), "--backend", "cpu", "--dump-config"]
                 + flags)
            assert root.common.telemetry.tensormon.enabled is True
            assert root.common.telemetry.tensormon.nan_policy == policy
    finally:
        root.common.telemetry.tensormon.enabled = prev

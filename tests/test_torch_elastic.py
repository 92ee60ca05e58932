"""The port's elastic plane (veles_tpu_torch/resilience/elastic.py, the
launcher's elastic hooks and ``run_elastic``) against the reference's
tests/test_elastic.py, on the CPU.

- the reference's tier-1 cases on the port: fault points and counters,
  ``check_hosts`` (injected and lapse), the barrier's failure and
  timeout, the gauges, the manifest cursor, the quarantine link, the
  scaling model (its link now NVLink's row), the Supervisor's
  classification, numbering, deadline and ``min_hosts``, the
  controller's floor and a barrier failure that ends a generation but
  not the run;
- the injected-host-loss drill: blobs 120 × 8, ``all2all_tanh`` 8 →
  softmax 3, mb 24, seed 11, host lost at the 5th dispatch. The port's
  elastic state tree equals its own straight run's bit for bit, and its
  final weights equal the reference's drill within
  tests/test_torch_train.py's limits (rtol 2e-4 / atol 2e-5, errors
  atol 1e-5): both packages start from the same weights under
  ``prng.seed_all``;
- the same bit-for-bit drill on a 2-block d 32 char LM (the bench LM's
  builder at test width) through the plain flash versions, one thread;
- a gloo world of 2 → 1 Supervisor drill (rank 1 crashes mid epoch 2,
  rank 0 exits 43, the respawned world of 1 resumes from the chain and
  ends within tests/test_dp_equivalence.py's limits of a straight run:
  errors atol 0.01 / 0.02, weights rtol 2e-3 / atol 2e-4), and a
  snapshot taken at world 2 resumed at world 1 with equal forward logits
  (rtol 1e-6 / atol 1e-7).
"""
import os
import socket
import subprocess
import sys
import textwrap
import time

import numpy
import pytest
import torch

import veles_tpu as vt
from veles_tpu import nn as ref_nn
from veles_tpu import prng as ref_prng
from veles_tpu.config import root as ref_root
from veles_tpu.launcher import Launcher as RefLauncher
from veles_tpu.loader import FullBatchLoader as RefFullBatchLoader
from veles_tpu.resilience import checkpoint_chain as ref_chain
from veles_tpu.resilience import faults as ref_faults
from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.launcher import Launcher
from veles_tpu_torch.loader import FullBatchLoader
from veles_tpu_torch.models import char_lm
from veles_tpu_torch.nn.standard_workflow import StandardWorkflow
from veles_tpu_torch.parallel import distributed
from veles_tpu_torch.resilience import checkpoint_chain, elastic, faults
from veles_tpu_torch.resilience.elastic import (
    ELASTIC_COUNTERS, GENERATION_EXIT_CODE, HostLostError, Supervisor,
    generation_barrier, predict_step_time, psum_bytes_per_step)
from veles_tpu_torch.resilience.health import HeartbeatRegistry, heartbeats
from veles_tpu_torch.snapshotter import Snapshotter
from veles_tpu_torch.telemetry import counters
from veles_tpu_torch.telemetry.counters import DESCRIPTIONS
from torch_threads import one_torch_thread  # noqa: F401,E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC_ATOL = 1e-5
RTOL, ATOL = 2e-4, 2e-5
#: tests/test_dp_equivalence.py's limits (data-parallel sums run in
#: another order)
DP_TRAIN_ATOL, DP_VALID_ATOL = 0.01, 0.02
DP_RTOL, DP_ATOL = 2e-3, 2e-4
#: seconds a spawned world may take
WORLD_TIMEOUT = 240


@pytest.fixture(autouse=True)
def _elastic_state_guard(monkeypatch):
    """Every test leaves the elastic knobs, gauges, host heartbeats and
    fault planes the way it found them."""
    monkeypatch.delenv("VELES_FAULTS", raising=False)
    faults.plane.configure()
    saved = elastic.state()
    enabled = root.common.resilience.elastic.get("enabled", False)
    yield
    root.common.resilience.elastic.enabled = enabled
    root.common.resilience.elastic.min_hosts = 1
    elastic._set_state(**saved)
    distributed.set_generation(0)
    for name in list(heartbeats.status()):
        if name.startswith(elastic.HOST_BEAT_PREFIX):
            heartbeats.unregister(name)
    os.environ.pop("VELES_FAULTS", None)
    faults.plane.configure()
    ref_faults.plane.configure()


# -- fault points + counters -------------------------------------------------

def test_fault_points_registered():
    points = faults.list_points()
    assert "distributed.host_loss" in points
    assert "distributed.generation_barrier" in points


def test_elastic_counters_registered():
    for name in ELASTIC_COUNTERS + ("veles_manifest_cursor_defaults_total",):
        assert name in DESCRIPTIONS, name


def test_check_hosts_injected_fault_raises_host_lost(monkeypatch):
    monkeypatch.setenv("VELES_FAULTS", "distributed.host_loss:raise:times=1")
    faults.plane.configure()
    with pytest.raises(HostLostError):
        elastic.check_hosts(registry=HeartbeatRegistry())
    monkeypatch.delenv("VELES_FAULTS")
    faults.plane.configure()
    elastic.check_hosts(registry=HeartbeatRegistry())     # clean: no-op


def test_check_hosts_heartbeat_lapse():
    reg = HeartbeatRegistry()
    reg.beat("host:7", timeout=0.01)
    reg.beat("not_a_host", timeout=0.01)   # non-host lapses don't trip
    time.sleep(0.03)
    with pytest.raises(HostLostError) as e:
        elastic.check_hosts(registry=reg)
    assert "host:7" in str(e.value)
    # the loss was DECLARED: the lapsed entry is dropped
    assert "host:7" not in reg.status()
    reg.unregister("not_a_host")
    elastic.check_hosts(registry=reg)
    reg.beat("host:7", timeout=60.0)       # a returning host re-joins
    elastic.check_hosts(registry=reg)


def test_generation_barrier_failure_counted(monkeypatch):
    monkeypatch.setenv("VELES_FAULTS",
                       "distributed.generation_barrier:raise:times=1")
    faults.plane.configure()
    before = counters.get("veles_elastic_barrier_timeouts_total")
    with pytest.raises(HostLostError):
        generation_barrier(3, timeout=1.0)
    assert counters.get("veles_elastic_barrier_timeouts_total") \
        == before + 1
    monkeypatch.delenv("VELES_FAULTS")
    faults.plane.configure()
    # one process, clean: the barrier agrees with itself
    assert generation_barrier(4) == 4


def test_generation_barrier_timeout_enforced(monkeypatch):
    """A dead peer never arrives at the collective: the barrier's
    watchdog thread abandons the wait after the timeout and counts it."""
    monkeypatch.setattr(distributed, "survivor_barrier",
                        lambda g: time.sleep(30))
    before = counters.get("veles_elastic_barrier_timeouts_total")
    t0 = time.time()
    with pytest.raises(HostLostError) as e:
        generation_barrier(2, timeout=0.2)
    assert time.time() - t0 < 5
    assert "timed out" in str(e.value)
    assert counters.get("veles_elastic_barrier_timeouts_total") \
        == before + 1


def test_gauges_no_rows_until_enabled():
    elastic._set_state(enabled=False)
    assert elastic.gauges() == {}
    elastic._set_state(enabled=True, generation=2, world_size=3,
                       last_reshard_s=0.25, min_hosts=1)
    g = elastic.gauges()
    assert g["veles_elastic_generation"][0] == 2
    assert g["veles_elastic_world_size"][0] == 3
    assert g["veles_elastic_last_reshard_seconds"][0] == 0.25
    assert g["veles_elastic_min_hosts"][0] == 1


# -- manifest cursor ----------------------------------------------------------

def test_cursor_roundtrip_and_legacy_defaults(tmp_path):
    snap = tmp_path / "wf_x_0001.pickle"
    snap.write_bytes(b"payload")
    checkpoint_chain.write_manifest(
        str(snap), cursor={"epoch": 5, "step": 42, "world_size": 4})
    assert checkpoint_chain.cursor_of(str(snap)) == {
        "epoch": 5, "step": 42, "world_size": 4}
    legacy = tmp_path / "wf_y_0001.pickle"
    legacy.write_bytes(b"old")
    checkpoint_chain.write_manifest(str(legacy))
    before = counters.get("veles_manifest_cursor_defaults_total")
    assert checkpoint_chain.cursor_of(str(legacy)) == \
        checkpoint_chain.CURSOR_DEFAULT
    assert counters.get("veles_manifest_cursor_defaults_total") \
        == before + 1
    partial = tmp_path / "wf_z_0001.pickle"
    partial.write_bytes(b"p")
    checkpoint_chain.write_manifest(str(partial), cursor={"epoch": 9})
    cur = checkpoint_chain.cursor_of(str(partial))
    assert cur["epoch"] == 9 and cur["world_size"] == 1
    assert counters.get("veles_manifest_cursor_defaults_total") \
        == before + 2


def test_latest_cursor_walks_newest_first(tmp_path):
    older = tmp_path / "wf_a_0001.pickle"
    older.write_bytes(b"a")
    checkpoint_chain.write_manifest(
        str(older), cursor={"epoch": 1, "step": 4, "world_size": 2})
    time.sleep(0.02)
    newer = tmp_path / "wf_a_0002.pickle"
    newer.write_bytes(b"b")
    checkpoint_chain.write_manifest(
        str(newer), cursor={"epoch": 2, "step": 8, "world_size": 2})
    path, cur = checkpoint_chain.latest_cursor(str(tmp_path), "wf")
    assert path == str(newer) and cur["epoch"] == 2
    assert checkpoint_chain.latest_cursor(str(tmp_path), "nope") is None


def _fake_chain(tmp_path, prefix="wf", n=2):
    """n fake snapshots with manifests, oldest→newest, and a _current
    link at the newest."""
    paths = []
    for i in range(1, n + 1):
        p = tmp_path / ("%s_t_%04d.pickle" % (prefix, i))
        p.write_bytes(b"state-%d" % i)
        checkpoint_chain.write_manifest(
            str(p), cursor={"epoch": i, "step": i, "world_size": 1})
        os.utime(p, (time.time() - (n - i), time.time() - (n - i)))
        paths.append(str(p))
    link = tmp_path / ("%s_current.pickle" % prefix)
    os.symlink(os.path.basename(paths[-1]), str(link))
    return paths, str(link)


def test_quarantine_link_skips_to_older_valid_entry(tmp_path):
    paths, link = _fake_chain(tmp_path, n=3)
    checkpoint_chain.quarantine(paths[-1])
    assert os.path.islink(link) and os.path.exists(link)
    assert os.readlink(link) == os.path.basename(paths[-2])
    checkpoint_chain.quarantine(paths[-2])
    assert os.readlink(link) == os.path.basename(paths[-3])
    checkpoint_chain.quarantine(paths[-3])
    assert not os.path.lexists(link)


# -- scaling model --------------------------------------------------------------

def test_psum_bytes_model():
    assert psum_bytes_per_step(1000, 1) == 0.0
    assert psum_bytes_per_step(1000, 2) == pytest.approx(1000.0)
    assert psum_bytes_per_step(1000, 4) == pytest.approx(1500.0)
    assert psum_bytes_per_step(1000, 64) < 2000.0


def test_predict_step_time_states_inputs():
    pred = predict_step_time(0.08, 1e6, 8, device_kind="NVIDIA H100 80GB")
    assert pred["predicted_step_s"] == pytest.approx(
        pred["compute_s"] + pred["comm_s"])
    assert pred["compute_s"] == pytest.approx(0.01)
    ins = pred["inputs"]
    assert ins["t1_step_s"] == 0.08
    assert ins["psum_bytes_per_step"] == pytest.approx(1.75e6)
    assert ins["ici_bw_bytes_per_s"] == pytest.approx(450e9)
    assert ins["ici_bw_source"] == "telemetry.cost.LINK_BW_BYTES[h100]"
    # another kind is priced as the data sheet's card, and says so
    from veles_tpu_torch.telemetry.cost import DEFAULT_LINK_BW
    other = predict_step_time(0.08, 1e6, 8, device_kind="weird")
    assert other["inputs"]["ici_bw_bytes_per_s"] == DEFAULT_LINK_BW
    assert "DEFAULT_LINK_BW" in other["inputs"]["ici_bw_source"]
    assert predict_step_time(0.08, 1e6, 8, ici_bw=1e9)["inputs"][
        "ici_bw_source"] == "caller"


# -- the respawn plane -----------------------------------------------------------

def _exits(codes):
    return [subprocess.Popen([sys.executable, "-S", "-c",
                              "import sys; sys.exit(%d)" % c])
            for c in codes]


def test_supervisor_classifies_loss_vs_restart():
    """A crashed worker is a lost host (world shrinks), a worker exiting
    GENERATION_EXIT_CODE a healthy survivor (world holds), a clean
    generation ends the job."""
    log = []

    def spawn(generation, world):
        assert os.environ.get(elastic.GENERATION_ENV) == str(generation)
        log.append((generation, world))
        if generation == 1:
            return _exits([42] + [GENERATION_EXIT_CODE] * (world - 1))
        if generation == 2:
            return _exits([GENERATION_EXIT_CODE] * world)
        return _exits([0] * world)

    sup = Supervisor(spawn, world_size=3, min_hosts=1, max_generations=5,
                     poll_interval=0.05, reap_timeout=5.0)
    assert sup.run() == 3
    assert log == [(1, 3), (2, 2), (3, 2)]
    assert elastic.GENERATION_ENV not in os.environ


def test_supervisor_generation_deadline_reaps_wedged_fleet():
    log = []

    def spawn(generation, world):
        log.append(generation)
        if generation == 1:
            return [subprocess.Popen(
                [sys.executable, "-S", "-c", "import time; time.sleep(60)"])
                for _ in range(world)]
        return _exits([0] * world)

    sup = Supervisor(spawn, world_size=2, min_hosts=1, max_generations=3,
                     poll_interval=0.05, reap_timeout=0.3,
                     generation_deadline=1.0)
    t0 = time.time()
    assert sup.run() == 2
    assert time.time() - t0 < 30
    assert log == [1, 2] and sup.world == 2


def test_supervisor_min_hosts_floor():
    sup = Supervisor(lambda g, w: _exits([42] * w), world_size=2,
                     min_hosts=2, max_generations=4, poll_interval=0.05,
                     reap_timeout=5.0)
    with pytest.raises(HostLostError, match="below min_hosts=2"):
        sup.run()


# -- the in-process drill ----------------------------------------------------------

def _blobs_data():
    rng = numpy.random.RandomState(3)
    centers = rng.randn(3, 8) * 3
    y = rng.randint(0, 3, 120).astype(numpy.int32)
    x = (centers[y] + rng.randn(120, 8)).astype(numpy.float32)
    return x, y


class _Blobs(FullBatchLoader):
    hide_from_registry = True

    def load_data(self):
        self.create_originals(*_blobs_data())
        self.class_lengths = [0, 24, 96]


class _RefBlobs(RefFullBatchLoader):
    hide_from_registry = True

    def load_data(self):
        self.create_originals(*_blobs_data())
        self.class_lengths = [0, 24, 96]


LAYERS = [{"type": "all2all_tanh", "output_sample_shape": 8},
          {"type": "softmax", "output_sample_shape": 3}]


def _build(snapdir, prefix, epochs=4):
    snap = Snapshotter(None, prefix=prefix, directory=str(snapdir),
                       interval=1)
    return StandardWorkflow(
        name=prefix, layers=LAYERS,
        loader_unit=_Blobs(None, minibatch_size=24, name="l"),
        loss_function="softmax",
        decision_config=dict(max_epochs=epochs, fail_iterations=100),
        snapshotter_unit=snap)


def _ref_build(snapdir, prefix, epochs=4):
    snap = vt.Snapshotter(None, prefix=prefix, directory=str(snapdir),
                          interval=1)
    return ref_nn.StandardWorkflow(
        name=prefix, layers=LAYERS,
        loader_unit=_RefBlobs(None, minibatch_size=24, name="l"),
        loss_function="softmax",
        decision_config=dict(max_epochs=epochs, fail_iterations=100),
        snapshotter_unit=snap)


def _assert_trees_equal(a, b, path="root"):
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            _assert_trees_equal(a[k], b[k], "%s.%s" % (path, k))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, "%s[%d]" % (path, i))
    elif isinstance(a, numpy.ndarray):
        numpy.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


def _port_drill(tmp_path, build, spec, name="el", seed=11):
    """(straight state, elastic state, results, counter deltas) of one
    workflow trained straight and then under the elastic plane with the
    fault ``spec`` armed."""
    clean = tmp_path / ("clean_" + name)
    chaos = tmp_path / ("chaos_" + name)
    clean.mkdir()
    chaos.mkdir()
    prng.seed_all(seed)
    wf = build(clean, name)
    launcher = Launcher(backend="cpu", random_seed=seed)
    launcher.initialize(wf)
    launcher.run()
    root.common.resilience.elastic.enabled = True
    os.environ["VELES_FAULTS"] = spec
    faults.plane.configure()
    before = counters.snapshot()
    try:
        prng.seed_all(seed)
        wf2 = build(chaos, name)
        launcher2 = Launcher(backend="cpu", random_seed=seed)
        launcher2.initialize(wf2)
        results = launcher2.run_elastic()
    finally:
        os.environ.pop("VELES_FAULTS", None)
        faults.plane.configure()
    delta = {k: counters.get(k) - before.get(k, 0) for k in ELASTIC_COUNTERS}
    return (checkpoint_chain.load_latest(str(clean), name)[1],
            checkpoint_chain.load_latest(str(chaos), name)[1],
            results, delta, chaos)


def _check_drill(clean_state, chaos_state, results, delta, chaos, name):
    assert results["elastic_generations"] == 2
    assert delta["veles_elastic_generations_total"] == 2
    assert delta["veles_elastic_preemptions_total"] == 1
    assert delta["veles_elastic_reshard_seconds_total"] > 0
    # the host beat went with the run
    assert not any(n.startswith(elastic.HOST_BEAT_PREFIX)
                   for n in heartbeats.status())
    _, cur = checkpoint_chain.latest_cursor(str(chaos), name)
    assert cur["epoch"] >= 1 and cur["world_size"] == 1 \
        and cur["step"] > 0
    _assert_trees_equal(chaos_state["__units__"], clean_state["__units__"])
    _assert_trees_equal(chaos_state["__prng__"], clean_state["__prng__"])


def _close_trees(got, want, path="root"):
    """Float arrays within the train-parity limits, the rest equal, over
    the keys both trees hold."""
    if isinstance(want, dict):
        for k in want:
            if k in got:
                _close_trees(got[k], want[k], "%s.%s" % (path, k))
    elif isinstance(want, numpy.ndarray) and want.dtype.kind == "f":
        numpy.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                      err_msg=path)


def test_injected_host_loss_resumes_and_matches_uninterrupted(tmp_path):
    """The host lost at the 5th dispatch (mid-run, epochs 1-2 on the
    chain) ends generation 1; generation 2 restores the newest valid
    checkpoint and the run ends in the straight run's state, bit for
    bit — and within the train-parity limits of the reference's own
    drill from the same initial weights."""
    spec = "distributed.host_loss:raise:after=4,times=1"
    clean, chaos, results, delta, chaos_dir = _port_drill(
        tmp_path, _build, spec)
    _check_drill(clean, chaos, results, delta, chaos_dir, "el")

    # the reference's drill: same seed, same data, same fault
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    ref_enabled = ref_root.common.resilience.elastic.get("enabled", False)
    ref_root.common.resilience.elastic.enabled = True
    os.environ["VELES_FAULTS"] = spec
    ref_faults.plane.configure()
    try:
        ref_prng.seed_all(11)
        ref_wf = _ref_build(ref_dir, "el")
        ref_launcher = RefLauncher(backend="cpu", random_seed=11)
        ref_launcher.initialize(ref_wf)
        ref_results = ref_launcher.run_elastic()
    finally:
        os.environ.pop("VELES_FAULTS", None)
        ref_faults.plane.configure()
        ref_root.common.resilience.elastic.enabled = ref_enabled
    assert ref_results["elastic_generations"] == 2
    ref_state = ref_chain.load_latest(str(ref_dir), "el")[1]
    _close_trees(chaos["__units__"], ref_state["__units__"])
    for cls in ("train", "validation"):
        numpy.testing.assert_allclose(
            results["err_history"][cls][-1],
            ref_results["err_history"][cls][-1], atol=METRIC_ATOL,
            err_msg=cls)


def _lm_build(snapdir, prefix):
    snap = Snapshotter(None, prefix=prefix, directory=str(snapdir),
                       interval=1)
    wf = char_lm.build_bench_workflow(
        seq_len=32, dim=32, n_blocks=2, ffn_hidden=64, n_heads=4, vocab=16,
        minibatch_size=4, n_train=16, n_valid=8, snapshotter_unit=snap)
    wf.decision.max_epochs = 3
    return wf


def test_injected_host_loss_on_the_char_lm(tmp_path):
    """The same drill on a 2-block d 32 char LM (adam, RoPE, the plain
    flash versions on the CPU): the loss lands at epoch 2's train
    dispatch, and the elastic run's tree — adam's moments, every random
    stream, the loader's cursor — equals the straight run's bit for
    bit."""
    spec = "distributed.host_loss:raise:after=3,times=1"
    clean, chaos, results, delta, chaos_dir = _port_drill(
        tmp_path, _lm_build, spec, name="lm", seed=77)
    _check_drill(clean, chaos, results, delta, chaos_dir, "lm")


def test_controller_refuses_start_below_min_hosts(tmp_path):
    root.common.resilience.elastic.enabled = True
    root.common.resilience.elastic.min_hosts = 2
    prng.seed_all(11)
    wf = _build(tmp_path, "fl")
    launcher = Launcher(backend="cpu", random_seed=11)
    launcher.initialize(wf)
    with pytest.raises(HostLostError) as e:
        launcher.run_elastic()
    assert "min_hosts" in str(e.value)
    assert not checkpoint_chain.chain(str(tmp_path), "fl"), \
        "a generation trained despite the floor"


def test_respawned_worker_continues_generation_numbering(tmp_path,
                                                         monkeypatch):
    assert elastic.base_generation() == 1
    monkeypatch.setenv(elastic.GENERATION_ENV, "5")
    assert elastic.base_generation() == 5
    root.common.resilience.elastic.enabled = True
    prng.seed_all(11)
    wf = _build(tmp_path, "gen")
    launcher = Launcher(backend="cpu", random_seed=11)
    launcher.initialize(wf)
    results = launcher.run_elastic()
    assert results["elastic_generations"] == 5
    assert elastic.state()["generation"] == 5
    # the manifest cursor records the job's generation
    _, cur = checkpoint_chain.latest_cursor(str(tmp_path), "gen")
    man = checkpoint_chain.read_manifest(
        checkpoint_chain.chain(str(tmp_path), "gen")[0])
    assert man["cursor"]["generation"] == 5 and cur["epoch"] == 4
    monkeypatch.setenv(elastic.GENERATION_ENV, "junk")
    assert elastic.base_generation() == 1


def test_barrier_failure_ends_generation_not_run(tmp_path, monkeypatch):
    root.common.resilience.elastic.enabled = True
    monkeypatch.setenv("VELES_FAULTS",
                       "distributed.generation_barrier:raise:times=1")
    faults.plane.configure()
    bt_before = counters.get("veles_elastic_barrier_timeouts_total")
    pre_before = counters.get("veles_elastic_preemptions_total")
    prng.seed_all(11)
    wf = _build(tmp_path, "bar")
    launcher = Launcher(backend="cpu", random_seed=11)
    launcher.initialize(wf)
    results = launcher.run_elastic()
    assert results["elastic_generations"] == 2
    assert counters.get("veles_elastic_barrier_timeouts_total") \
        == bt_before + 1
    assert counters.get("veles_elastic_preemptions_total") \
        == pre_before + 1


def test_resume_via_quarantined_current_link_falls_back(tmp_path):
    prng.seed_all(7)
    wf = _build(tmp_path, "el")
    launcher = Launcher(backend="cpu", random_seed=7)
    launcher.initialize(wf)
    launcher.run()
    chain = checkpoint_chain.chain(str(tmp_path), "el")
    assert len(chain) >= 2
    os.replace(chain[0], chain[0] + ".corrupt")
    link = os.path.join(str(tmp_path), "el_current.pickle.gz")
    assert os.path.islink(link) and not os.path.exists(link)
    prng.seed_all(7)
    wf2 = _build(tmp_path, "el")
    launcher2 = Launcher(backend="cpu", random_seed=7)
    launcher2.initialize(wf2)
    launcher2.resume(link)          # must fall back, not raise
    assert wf2.restored_from_snapshot
    assert wf2.decision.epoch_number >= 1
    # the elastic controller reads the chain the fallback found
    assert launcher2._last_restore_dir == str(tmp_path)
    assert launcher2._last_restore_prefix == "el"


# -- gloo worlds ----------------------------------------------------------------

#: one rank of the drill's world (torch and the port only): RANK WORLD
#: PORT SNAPDIR EPOCHS OUT MODE; MODE "elastic" runs under the elastic
#: plane, "save" trains straight and writes the forward logits of the
#: first 24 rows beside the final weights
CHILD = textwrap.dedent("""
    import os, sys
    import numpy, torch
    sys.path.insert(0, %(repo)r)
    torch.set_num_threads(1)
    from veles_tpu_torch.config import root
    from veles_tpu_torch.launcher import Launcher
    from veles_tpu_torch.loader import FullBatchLoader
    from veles_tpu_torch.nn.standard_workflow import StandardWorkflow
    from veles_tpu_torch.snapshotter import Snapshotter

    class Blobs(FullBatchLoader):
        hide_from_registry = True
        def load_data(self):
            rng = numpy.random.RandomState(3)
            centers = rng.randn(3, 8) * 3
            y = rng.randint(0, 3, 120).astype(numpy.int32)
            x = (centers[y] + rng.randn(120, 8)).astype(numpy.float32)
            self.create_originals(x, y)
            self.class_lengths = [0, 24, 96]

    rank, world, port = (int(a) for a in sys.argv[1:4])
    snapdir, epochs, out, mode = sys.argv[4], int(sys.argv[5]), \\
        sys.argv[6], sys.argv[7]
    root.common.resilience.elastic.enabled = mode == "elastic"
    launcher = Launcher(
        backend="cpu",
        coordinator="127.0.0.1:%%d" %% port if world > 1 else None,
        num_processes=world if world > 1 else None,
        process_id=rank if world > 1 else None,
        mesh={"data": world}, random_seed=11)
    snap = Snapshotter(None, prefix="esup", directory=snapdir, interval=1,
                       compression="")
    wf = StandardWorkflow(
        name="esup",
        layers=[{"type": "all2all_tanh", "output_sample_shape": 8},
                {"type": "softmax", "output_sample_shape": 3}],
        loader_unit=Blobs(None, minibatch_size=24, name="l"),
        loss_function="softmax",
        decision_config=dict(max_epochs=epochs, fail_iterations=100),
        snapshotter_unit=snap)
    launcher.initialize(wf)
    results = (launcher.run_elastic() if mode == "elastic"
               else launcher.run())
    step = wf.train_step
    if rank == 0:
        x = torch.as_tensor(wf.loader.original_data.mem[:24])
        with torch.no_grad():
            logits = step._forward(step.params, x).numpy()
        params = {"%%s.%%s" %% (u, k): v.detach().numpy()
                  for u, p in step.params.items() for k, v in p.items()}
        hist = results["err_history"]
        numpy.savez(out, logits=logits,
                    train_err=hist["train"][-1],
                    valid_err=hist["validation"][-1],
                    generations=results.get("elastic_generations", 0),
                    **params)
    print("RANK%%d DONE generations=%%s epoch=%%d" %% (
        rank, results.get("elastic_generations"),
        wf.decision.epoch_number), flush=True)
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_world(script, world, snapdir, epochs, out, mode, faults_of=None):
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, PYTHONPATH=REPO)
        env.pop("VELES_FAULTS", None)
        if faults_of and faults_of.get(rank):
            env["VELES_FAULTS"] = faults_of[rank]
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(rank), str(world), str(port),
             str(snapdir), str(epochs), str(out), mode],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=REPO, env=env))
    return procs


def _finish(procs, what):
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=WORLD_TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate()[0])
    for p, out in zip(procs, outs):
        assert p.returncode == 0, (what, out[-3000:])
    return outs


def _weights(doc):
    return {k: doc[k] for k in doc.files
            if k not in ("logits", "train_err", "valid_err",
                         "generations")}


def test_supervisor_respawns_a_gloo_world_at_one(tmp_path):
    """A world of 2 (``data=2``) loses rank 1 to
    ``distributed.host_loss:crash`` at its 4th dispatch (epoch 2's train
    dispatch); rank 0's next collective fails, it exits 43, the
    Supervisor counts 1 lost and 1 restart and respawns a world of 1
    with ``VELES_ELASTIC_GENERATION=2``, which resumes from the chain
    rank 0 wrote and ends within the data-parallel limits of a straight
    one-process run."""
    script = tmp_path / "child.py"
    script.write_text(CHILD % {"repo": REPO})
    snapdir = tmp_path / "esup"
    snapdir.mkdir()
    out = tmp_path / "elastic.npz"
    spawned = {}

    def spawn(generation, world):
        crash = ({1: "distributed.host_loss:crash:after=3,times=1"}
                 if generation == 1 else None)
        spawned[generation] = _spawn_world(script, world, snapdir, 4, out,
                                           "elastic", crash)
        return spawned[generation]

    sup = Supervisor(spawn, world_size=2, min_hosts=1, max_generations=3,
                     poll_interval=0.1, reap_timeout=60.0)
    t0 = time.time()
    generation = sup.run()
    seconds = time.time() - t0
    first = [p.communicate()[0] for p in spawned[1]]
    codes = [p.returncode for p in spawned[1]]
    assert codes == [GENERATION_EXIT_CODE, 42], (codes, first[0][-3000:])
    assert generation == 2 and sup.world == 1, seconds
    last = spawned[2][0].communicate()[0]
    assert "RANK0 DONE generations=2 epoch=4" in last, last[-3000:]
    _, cur = checkpoint_chain.latest_cursor(str(snapdir), "esup")
    assert cur["world_size"] == 1 and cur["epoch"] == 4

    straight_dir = tmp_path / "straight"
    straight_dir.mkdir()
    straight = tmp_path / "straight.npz"
    _finish(_spawn_world(script, 1, straight_dir, 4, straight, "plain"),
            "straight")
    got, want = numpy.load(out), numpy.load(straight)
    assert int(got["generations"]) == 2
    for k, v in _weights(want).items():
        numpy.testing.assert_allclose(got[k], v, rtol=DP_RTOL, atol=DP_ATOL,
                                      err_msg=k)
    numpy.testing.assert_allclose(got["train_err"], want["train_err"],
                                  atol=DP_TRAIN_ATOL)
    numpy.testing.assert_allclose(got["valid_err"], want["valid_err"],
                                  atol=DP_VALID_ATOL)


def test_snapshot_at_world_two_resumes_at_one(tmp_path):
    """A snapshot written by a world of 2 (``data=2``) restores in one
    process with equal forward logits: snapshots hold whole tensors,
    whatever the world that wrote them."""
    script = tmp_path / "child.py"
    script.write_text(CHILD % {"repo": REPO})
    snapdir = tmp_path / "w2"
    snapdir.mkdir()
    out = tmp_path / "w2.npz"
    _finish(_spawn_world(script, 2, snapdir, 2, out, "save"), "world 2")
    saved = numpy.load(out)
    _, cur = checkpoint_chain.latest_cursor(str(snapdir), "esup")
    assert cur["world_size"] == 2
    prng.seed_all(11)
    wf = StandardWorkflow(
        name="esup", layers=LAYERS,
        loader_unit=_Blobs(None, minibatch_size=24, name="l"),
        loss_function="softmax",
        decision_config=dict(max_epochs=2, fail_iterations=100))
    wf.initialize(device="cpu")
    assert distributed.restore_latest(wf, str(snapdir), "esup")
    step = wf.train_step
    x = torch.as_tensor(wf.loader.original_data.mem[:24])
    with torch.no_grad():
        logits = step._forward(step.params, x).numpy()
    numpy.testing.assert_allclose(logits, saved["logits"], rtol=1e-6,
                                  atol=1e-7)
    for k, v in _weights(saved).items():
        unit, key = k.split(".", 1)
        numpy.testing.assert_array_equal(
            step.params[unit][key].detach().numpy(), v, err_msg=k)

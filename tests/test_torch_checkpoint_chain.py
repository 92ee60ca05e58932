"""The port's checkpoint chain and the fault and retry planes it stands on
(veles_tpu_torch/resilience/), against the reference's, on the CPU:

- the port's counterparts of tests/test_resilience.py's chain cases:
  newest-first order, a walk past corrupt files (quarantined, counted),
  an all-corrupt chain giving None, a truncated file giving a clear
  VelesError, ``verify``'s three answers, ``prune``, the Snapshotter's
  manifest, atomic link and pruning, and an injected corrupt write
  falling back to the older snapshot;
- the retry and fault cases the chain needs, each held against the
  reference's: the backoff sequence, its cap and deadline, the spec
  grammar, a corrupt action's damage, and a seeded p=0.5 clause that
  fires on the same hits in both packages;
- a chain written by the reference is restored by the port's
  ``restore_latest``, and the reverse, past a corrupt newest file.
"""
import gzip
import os
import pickle
import time

import numpy
import pytest

import veles_tpu as vt
from veles_tpu import nn as ref_nn
from veles_tpu import prng as ref_prng
from veles_tpu.loader import FullBatchLoader as RefFullBatchLoader
from veles_tpu.resilience import checkpoint_chain as ref_chain
from veles_tpu.resilience import faults as ref_faults
from veles_tpu.resilience import retry as ref_retry
from veles_tpu_torch import prng
from veles_tpu_torch.error import VelesError
from veles_tpu_torch.loader import FullBatchLoader
from veles_tpu_torch.nn.standard_workflow import StandardWorkflow
from veles_tpu_torch.resilience import (RESILIENCE_COUNTERS,
                                        checkpoint_chain, faults, retry)
from veles_tpu_torch.snapshotter import Snapshotter, load_snapshot
from veles_tpu_torch.telemetry.counters import DESCRIPTIONS, counters
from veles_tpu_torch.workflow import Workflow


class FakeClock:
    def __init__(self):
        self.t = 0.0
        self.sleeps = []

    def time(self):
        return self.t

    def sleep(self, d):
        self.sleeps.append(d)
        self.t += d


def _failing(n, exc=OSError):
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] <= n:
            raise exc("boom %d" % calls["n"])
        return calls["n"]
    return fn


@pytest.mark.parametrize("kw,fails", [
    (dict(max_attempts=5, base_delay=0.1, max_delay=0.4), 4),
    (dict(max_attempts=3, base_delay=0.1), 10),
    (dict(max_attempts=50, base_delay=0.4, max_delay=0.4, deadline=1.0),
     100)])
def test_retry_backoff_matches_reference(kw, fails):
    """The same attempts, sleeps and outcome as the reference's policy
    on a fake clock; each retry counted."""
    outcomes = []
    for mod, reg in ((ref_retry, None), (retry, counters)):
        fc = FakeClock()
        policy = mod.RetryPolicy(jitter=False, sleep=fc.sleep,
                                 clock=fc.time, **kw)
        before = reg.get("veles_retries_total") if reg else 0
        try:
            got = policy.call(_failing(fails))
        except OSError as exc:
            got = str(exc)
        outcomes.append((got, fc.sleeps))
        if reg:
            assert reg.get("veles_retries_total") - before == len(fc.sleeps)
    assert outcomes[0] == outcomes[1]


def test_retry_filters_and_loop_forms():
    fc = FakeClock()
    policy = retry.RetryPolicy(max_attempts=4, base_delay=0.1,
                               retryable=(OSError,), jitter=False,
                               sleep=fc.sleep, clock=fc.time)
    with pytest.raises(ValueError):
        policy.call(_failing(3, exc=ValueError))
    assert fc.sleeps == []
    assert policy(_failing(2))() == 3
    state = {"n": 0}
    for attempt in policy.attempts():
        with attempt:
            state["n"] += 1
            if state["n"] <= 2:
                raise OSError("cm boom")
    assert state["n"] == 3


def test_fault_specs_parse_as_the_reference():
    spec = ("snapshot.write:crash:after=1,times=2;snapshot.load:raise:p=0.5;"
            "dispatch:delay:delay=0.01;serve.page_alloc:raise:window=5:8")
    fields = [[(f.point, f.action, f.p, f.after, f.times, f.delay, f.window)
               for f in mod.parse_spec(spec)] for mod in (ref_faults, faults)]
    assert fields[0] == fields[1]
    assert sorted(faults.list_points()) == sorted(ref_faults.list_points())
    for bad in ("nonsense", "no.such.point:raise", "dispatch:explode",
                "dispatch:raise:p=1.5", "dispatch:raise:window=3:1"):
        with pytest.raises(VelesError):
            faults.parse_spec(bad)
    blob = b"a snapshot's bytes"
    assert faults.Fault.corrupt(blob) == ref_faults.Fault.corrupt(blob)


def test_seeded_faults_fire_on_the_reference_hits(monkeypatch):
    monkeypatch.setenv("VELES_FAULTS", "snapshot.load:raise:p=0.5")
    traces = []
    for mod, rng in ((ref_faults, ref_prng), (faults, prng)):
        rng.seed_all(123)
        mod.plane.configure()
        out = []
        for _ in range(20):
            try:
                mod.fire("snapshot.load")
                out.append(0)
            except mod.FaultInjected:
                out.append(1)
        traces.append(out)
    assert traces[0] == traces[1] and 0 < sum(traces[0]) < 20
    assert "faults" in prng._ephemeral


def test_fire_counts_exhausts_and_clean_is_silent(monkeypatch):
    for name in RESILIENCE_COUNTERS:
        assert name in DESCRIPTIONS
    monkeypatch.setenv("VELES_FAULTS", "snapshot.load:raise:times=1")
    before = counters.get("veles_faults_injected_total")
    with pytest.raises(faults.FaultInjected):
        faults.fire("snapshot.load")
    assert faults.fire("snapshot.load") is None
    assert counters.get("veles_faults_injected_total") - before == 1
    monkeypatch.delenv("VELES_FAULTS")
    for point in faults.list_points():
        assert faults.fire(point) is None
    assert counters.get("veles_faults_injected_total") - before == 1


def _write_snap(directory, name, state, mtime=None):
    path = os.path.join(directory, name)
    tmp = path + ".tmp"
    with gzip.open(tmp, "wb") as fout:
        fout.write(pickle.dumps(state))
    checkpoint_chain.commit_file(tmp, path)
    checkpoint_chain.write_manifest(path)
    if mtime is not None:
        os.utime(path, (mtime, mtime))
    return path


def _flip_byte(path):
    with open(path, "rb") as fin:
        raw = bytearray(fin.read())
    raw[len(raw) // 2] ^= 0xFF
    with open(path, "wb") as fout:
        fout.write(raw)


def _three(tmp_path):
    t0 = time.time() - 100
    return [_write_snap(str(tmp_path), "wf_%d.pickle.gz" % i, {"i": i},
                        mtime=t0 + i) for i in range(3)]


def test_chain_orders_newest_first(tmp_path):
    _three(tmp_path)
    assert [os.path.basename(p) for p in checkpoint_chain.chain(
        str(tmp_path), "wf")] == ["wf_2.pickle.gz", "wf_1.pickle.gz",
                                  "wf_0.pickle.gz"]


def test_restore_walks_past_corrupt_files(tmp_path):
    newest = _three(tmp_path)[-1]
    _flip_byte(newest)
    before = counters.get("veles_snapshots_quarantined_total")
    path, state = checkpoint_chain.load_latest(str(tmp_path), "wf")
    assert os.path.basename(path) == "wf_1.pickle.gz"
    assert state == {"i": 1}
    assert os.path.exists(newest + ".corrupt") and not os.path.exists(newest)
    assert counters.get("veles_snapshots_quarantined_total") - before == 1
    assert newest not in checkpoint_chain.chain(str(tmp_path), "wf")


def test_all_corrupt_returns_none(tmp_path):
    p = _write_snap(str(tmp_path), "wf_only.pickle.gz", {"x": 1})
    _flip_byte(p)
    assert checkpoint_chain.load_latest(str(tmp_path), "wf") is None


def test_truncated_snapshot_raises_clear_veles_error(tmp_path):
    path = os.path.join(str(tmp_path), "wf_t.pickle.gz")
    with gzip.open(path, "wb") as fout:
        fout.write(pickle.dumps({"big": list(range(10000))}))
    with open(path, "rb") as fin:
        raw = fin.read()
    with open(path, "wb") as fout:
        fout.write(raw[:len(raw) // 2])
    with pytest.raises(VelesError, match="truncated or corrupt"):
        load_snapshot(path)


def test_verify_states(tmp_path):
    path = _write_snap(str(tmp_path), "wf_v.pickle.gz", {"x": 1})
    assert checkpoint_chain.verify(path) is True
    os.unlink(checkpoint_chain.manifest_path(path))
    assert checkpoint_chain.verify(path) is None    # legacy: loadable
    assert load_snapshot(path) == {"x": 1}
    assert checkpoint_chain.cursor_of(path) == checkpoint_chain.CURSOR_DEFAULT


def test_prune_bounded_retention(tmp_path):
    t0 = time.time() - 100
    for i in range(5):
        _write_snap(str(tmp_path), "wf_%d.pickle.gz" % i, {"i": i},
                    mtime=t0 + i)
    removed = checkpoint_chain.prune(str(tmp_path), "wf", keep_last=2)
    assert len(removed) == 6            # 3 snapshots + 3 manifests
    assert [os.path.basename(p) for p in checkpoint_chain.chain(
        str(tmp_path), "wf")] == ["wf_4.pickle.gz", "wf_3.pickle.gz"]


def test_snapshotter_writes_manifest_atomic_link_and_prunes(tmp_path):
    wf = Workflow(None, name="w")
    snap = Snapshotter(wf, prefix="s", directory=str(tmp_path), keep_last=2)
    paths = []
    for i in range(3):
        snap._runs = i + 1
        paths.append(snap.export())
        os.utime(paths[-1], (time.time() - 10 + i,) * 2)
    assert checkpoint_chain.verify(paths[-1]) is True
    man = checkpoint_chain.read_manifest(paths[-1])
    assert sorted(man) == ["bytes", "checksum", "created", "cursor",
                           "prefix", "runs", "sha256"]
    assert man["checksum"] == wf.checksum() and man["runs"] == 3
    link = os.path.join(str(tmp_path), "s_current.pickle.gz")
    assert os.path.islink(link)
    assert os.readlink(link) == os.path.basename(paths[-1])
    assert not os.path.exists(paths[0])
    assert os.path.exists(paths[1]) and os.path.exists(paths[2])
    assert checkpoint_chain.load_latest(str(tmp_path), "s") is not None


def test_snapshotter_corrupt_injection_falls_back(tmp_path, monkeypatch):
    wf = Workflow(None, name="w")
    snap = Snapshotter(wf, prefix="c", directory=str(tmp_path))
    snap._runs = 1
    good = snap.export()
    os.utime(good, (time.time() - 10,) * 2)
    monkeypatch.setenv("VELES_FAULTS", "snapshot.write:corrupt:times=1")
    snap._runs = 2
    bad = snap.export()
    monkeypatch.delenv("VELES_FAULTS")
    assert checkpoint_chain.verify(bad) is False
    path, _ = checkpoint_chain.load_latest(str(tmp_path), "c")
    assert path == good
    assert os.path.exists(bad + ".corrupt")
    # the _current link left the quarantined file for the survivor
    link = os.path.join(str(tmp_path), "c_current.pickle.gz")
    assert os.readlink(link) == os.path.basename(good)


def _tiny_data(self):
    rng = numpy.random.RandomState(5)
    self.create_originals(rng.rand(60, 8).astype(numpy.float32),
                          rng.randint(0, 3, 60).astype(numpy.int32))
    self.class_lengths = [0, 20, 40]


def _workflow(port, seed):
    """The TinyLoader chain of either package, initialised from
    ``seed`` (the initial weights are bitwise equal across them)."""
    base = FullBatchLoader if port else RefFullBatchLoader
    loader = type("Tiny", (base,), {"hide_from_registry": True,
                                    "load_data": _tiny_data})
    (prng if port else ref_prng).seed_all(seed)
    wf = (StandardWorkflow if port else ref_nn.StandardWorkflow)(
        name="chain", loader_unit=loader(None, minibatch_size=20,
                                         name="tiny"),
        layers=[{"type": "all2all_tanh", "output_sample_shape": 8},
                {"type": "softmax", "output_sample_shape": 3}],
        loss_function="softmax")
    wf.initialize(device="cpu" if port else vt.XLADevice(
        mesh_axes={"data": 1}))
    return wf


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_chain_crosses_packages(tmp_path, writer):
    """One package writes a chain of two snapshots (seeds 1 and 2) and
    corrupts the newest; the other's restore_latest quarantines it and
    restores the older one's weights."""
    port_writes = writer == "port"
    t0 = time.time() - 100
    written = []
    for i, seed in enumerate((1, 2)):
        wf = _workflow(port_writes, seed)
        snap = (Snapshotter if port_writes else vt.Snapshotter)(
            wf, prefix="x", directory=str(tmp_path))
        snap._runs = i + 1
        path = snap.export()
        os.utime(path, (t0 + i,) * 2)
        written.append((path, numpy.array(wf.forwards[0].weights.map_read())))
    _flip_byte(written[-1][0])
    reader = _workflow(not port_writes, 3)
    restore = (ref_chain if port_writes else checkpoint_chain).restore_latest
    assert restore(reader, str(tmp_path), "x") == written[0][0]
    assert reader.restored_from_snapshot
    assert os.path.exists(written[-1][0] + ".corrupt")
    numpy.testing.assert_array_equal(
        numpy.asarray(reader.forwards[0].weights.map_read()), written[0][1])
    assert checkpoint_chain.cursor_of(written[0][0])["world_size"] == 1

"""The port's snapshot plane (veles_tpu_torch/snapshotter.py and the
units' state_dict/load_state_dict) against the reference's, on the CPU:

- the port's counterparts of tests/test_snapshot.py on the same
  TinyLoader (240 × 8, 3 classes, mb 20): a write and its ``_current``
  link; a resume restores parameters, epoch counters, decision bests and
  the loader's position; 2 + 2 epochs across a snapshot equal 4
  straight epochs, in the classic mode (rtol 1e-6 / atol 1e-7) and in
  epoch blocks of 2 (rtol 1e-5 / atol 1e-6), both with exp_decay(0.9);
  the ``interval`` and ``skip`` gates; the sqlite sink; only rank 0
  writes; the gz, bz2, xz and plain codecs round-trip;
- across the packages, from the same seed (the initial weights are
  bitwise equal under ``prng.seed_all``, tests/test_torch_train.py):
  (i) the reference trains 2 epochs and snapshots, the port resumes that
  file and trains 2 more; (ii) the port snapshots and the reference's
  ``vt.resume`` continues. Both are held against the reference's own
  2 + 2 run within the MNIST parity limits of tests/test_torch_train.py
  (epoch errors atol 1e-5; weights and ``opt_state`` rtol 2e-4 / atol
  2e-5), for an SGD chain and an adam chain (adam's step count ``t``);
- the port's file holds numpy arrays and builtins only, and
  ``compare_snapshots.walk`` over the two packages' snapshots of one
  state gives the same paths, shapes, dtypes and values (less the
  reference's threefry counter, which the port has not);
- a snapshot whose shapes do not fit raises a VelesError naming the
  unit; an int8 record loads as ``q · s`` in its recorded dtype, while a
  record of another scheme, one without its scale, and asynchronous
  commits are refused;
- ``models/mnist.py --snapshot-dir`` then ``--resume`` through the
  fused-FC route equals the straight run.
"""
import glob
import gzip
import os
import pickle

import jax
import numpy
import pytest
import torch

import veles_tpu as vt
from veles_tpu import nn as ref_nn
from veles_tpu import prng as ref_prng
from veles_tpu.loader import TEST, TRAIN, VALID
from veles_tpu.loader import FullBatchLoader as RefFullBatchLoader
from veles_tpu.scripts import compare_snapshots as ref_compare
from veles_tpu_torch import datasets, prng, snapshotter
from veles_tpu_torch.config import root
from veles_tpu_torch.error import VelesError
from veles_tpu_torch.loader import FullBatchLoader
from veles_tpu_torch.models import mnist
from veles_tpu_torch.nn.lr_adjust import exp_decay
from veles_tpu_torch.nn.standard_workflow import StandardWorkflow
from veles_tpu_torch.scripts import compare_snapshots
from veles_tpu_torch.snapshotter import (Snapshotter, SnapshotterToDB,
                                         load_snapshot, resume)
from veles_tpu_torch.workflow import Workflow

METRIC_ATOL = 1e-5
RTOL, ATOL = 2e-4, 2e-5


def _tiny_data(self):
    rng = numpy.random.RandomState(5)
    n = 240
    self.create_originals(rng.rand(n, 8).astype(numpy.float32),
                          rng.randint(0, 3, n).astype(numpy.int32))
    self.class_lengths = [0, 40, 200]


TinyLoader = type("TinyLoader", (FullBatchLoader,),
                  {"hide_from_registry": True, "load_data": _tiny_data})
RefTinyLoader = type("RefTinyLoader", (RefFullBatchLoader,),
                     {"hide_from_registry": True, "load_data": _tiny_data})


def _layers(solver="sgd", hidden=8):
    return [{"type": "all2all_tanh", "output_sample_shape": hidden,
             "solver": solver},
            {"type": "softmax", "output_sample_shape": 3, "solver": solver}]


def build(tmpdir, max_epochs, with_snap=True, lr_schedule=None,
          epochs_per_dispatch=1, compression="gz", solver="sgd",
          hidden=8):
    """The reference test's workflow, in the port."""
    snap = Snapshotter(None, prefix="tiny", directory=str(tmpdir),
                       compression=compression) if with_snap else None
    return StandardWorkflow(
        name="snap-wf", layers=_layers(solver, hidden),
        loader_unit=TinyLoader(None, minibatch_size=20, name="tiny"),
        loss_function="softmax",
        decision_config=dict(max_epochs=max_epochs, fail_iterations=99),
        snapshotter_unit=snap, steps_per_dispatch=4,
        lr_schedule=lr_schedule, epochs_per_dispatch=epochs_per_dispatch)


def build_ref(tmpdir, max_epochs, with_snap=True, solver="sgd"):
    snap = vt.Snapshotter(None, prefix="tiny", directory=str(tmpdir),
                          compression="gz") if with_snap else None
    return ref_nn.StandardWorkflow(
        name="snap-wf", layers=_layers(solver),
        loader_unit=RefTinyLoader(None, minibatch_size=20, name="tiny"),
        loss_function="softmax",
        decision_config=dict(max_epochs=max_epochs, fail_iterations=99),
        snapshotter_unit=snap, steps_per_dispatch=4,
        lr_schedule=ref_nn.exp_decay(0.9))


def fresh_prng():
    with prng._lock:
        prng._generators.clear()
    prng.seed_all(1234)


def fresh_ref_prng():
    with ref_prng._lock:
        ref_prng._generators.clear()
    ref_prng.seed_all(1234)


def _run(wf):
    wf.initialize(device="cpu")
    wf.run()
    return wf


def _ref_init(wf):
    wf.initialize(device=vt.XLADevice(mesh_axes={"data": 1}))
    return wf


def _current(d):
    return str(d / "tiny_current.pickle.gz")


def test_snapshot_write_and_current_symlink(tmp_path):
    fresh_prng()
    _run(build(tmp_path, 3))
    assert glob.glob(str(tmp_path / "tiny_*.pickle.gz"))
    cur = tmp_path / "tiny_current.pickle.gz"
    assert cur.is_symlink() and cur.exists()
    state = load_snapshot(str(cur))
    assert sorted(state["__units__"]) == [
        "DecisionGD", "TrainStep", "all2all_tanh0", "softmax1", "tiny"]
    assert "weights" in state["__units__"]["all2all_tanh0"]


def test_resume_restores_everything(tmp_path):
    fresh_prng()
    wf = _run(build(tmp_path, 4))
    w_trained = numpy.array(wf.forwards[0].weights.map_read())
    fresh_prng()
    wf2 = build(tmp_path / "b", 4, with_snap=False)
    wf2.initialize(device="cpu")
    resume(wf2, _current(tmp_path))
    numpy.testing.assert_array_equal(
        wf2.forwards[0].weights.map_read(), w_trained)
    # the step's device tree is rebuilt from the restored forwards
    numpy.testing.assert_array_equal(
        wf2.train_step.params["all2all_tanh0"]["weights"].numpy(), w_trained)
    assert wf2.decision.epoch_number == wf.decision.epoch_number == 4
    assert wf2.decision.best_metric == wf.decision.best_metric
    assert wf2.decision.epoch_metrics == wf.decision.epoch_metrics
    assert wf2.loader.epoch_number == wf.loader.epoch_number
    assert wf2.loader.samples_served == wf.loader.samples_served
    numpy.testing.assert_array_equal(wf2.loader._shuffled_indices,
                                     wf.loader._shuffled_indices)
    assert wf2.restored_from_snapshot


@pytest.mark.parametrize("mode,h,rtol,atol", [
    ("classic", 1, 1e-6, 1e-7), ("block", 2, 1e-5, 1e-6)])
def test_resume_continuation_identical(tmp_path, mode, h, rtol, atol):
    """2 + 2 epochs across a snapshot against 4 straight classic epochs:
    the shuffle, the prng streams and the schedule come back (in block
    mode the snapshot lands between two 2-epoch blocks)."""
    fresh_prng()
    straight = _run(build(tmp_path / "a", 4, with_snap=False,
                          lr_schedule=exp_decay(0.9)))
    fresh_prng()
    first = _run(build(tmp_path / "b", 2, lr_schedule=exp_decay(0.9),
                       epochs_per_dispatch=h))
    assert first.loader.block_length == (2 if h == 2 else 0)
    fresh_prng()
    wf = build(tmp_path / "c", 4, with_snap=False,
               lr_schedule=exp_decay(0.9), epochs_per_dispatch=h)
    wf.initialize(device="cpu")
    resume(wf, _current(tmp_path / "b"))
    wf.decision.complete <<= False
    wf.run()
    for a, b in zip(straight.forwards, wf.forwards):
        numpy.testing.assert_allclose(a.weights.map_read(),
                                      b.weights.map_read(), rtol=rtol,
                                      atol=atol)
    assert wf.decision.epoch_metrics == straight.decision.epoch_metrics


def _bare_snapshotter(tmp_path, **kw):
    fresh_prng()
    wf = Workflow(name="w")
    snap = Snapshotter(wf, directory=str(tmp_path), **kw)
    wf.initialize()
    return snap


def test_snapshot_gating_interval(tmp_path):
    snap = _bare_snapshotter(tmp_path, prefix="g", interval=3)
    for _ in range(6):
        snap.run()
    assert len(glob.glob(str(tmp_path / "g_2*.pickle.gz"))) == 2


def test_snapshot_skip_bool(tmp_path):
    snap = _bare_snapshotter(tmp_path, prefix="s")
    snap.skip <<= True
    snap.run()
    assert not glob.glob(str(tmp_path / "s_*"))


def test_db_sink_roundtrip(tmp_path):
    fresh_prng()
    snap = SnapshotterToDB(None, prefix="db", directory=str(tmp_path))
    wf = StandardWorkflow(
        name="snap-db", layers=_layers(),
        loader_unit=TinyLoader(None, minibatch_size=20, name="tiny-db"),
        loss_function="softmax",
        decision_config=dict(max_epochs=2, fail_iterations=99),
        snapshotter_unit=snap, steps_per_dispatch=4)
    _run(wf)
    assert snap.destination.startswith("sqlite://")
    w_trained = numpy.array(wf.forwards[0].weights.map_read())
    fresh_prng()
    wf2 = build(tmp_path, 4, with_snap=False)
    wf2.initialize(device="cpu")
    resume(wf2, snap.destination)          # an explicit row
    numpy.testing.assert_array_equal(wf2.forwards[0].weights.map_read(),
                                     w_trained)
    assert wf2.decision.epoch_number == 2
    # a bare .sqlite3 path reads the newest row
    state = load_snapshot(str(tmp_path / "snapshots.sqlite3"))
    assert "all2all_tanh0" in state["__units__"]


def test_only_rank_zero_writes(tmp_path, monkeypatch):
    import torch.distributed as dist
    fresh_prng()
    wf = _run(build(tmp_path, 1))
    snap_file = Snapshotter(None, prefix="nonzero", directory=str(tmp_path))
    snap_db = SnapshotterToDB(None, prefix="nonzero",
                              directory=str(tmp_path / "db2"))
    snap_file.workflow = snap_db.workflow = wf
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    assert snap_file.export() == ""
    assert snap_db.export() == ""
    assert not glob.glob(str(tmp_path / "nonzero*"))
    assert not (tmp_path / "db2").exists()
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    path = snap_file.export()
    assert path and snap_db.export().startswith("sqlite://")
    from veles_tpu_torch.resilience import checkpoint_chain
    assert checkpoint_chain.cursor_of(path)["world_size"] == 2


@pytest.mark.parametrize("codec", ["gz", "bz2", "xz", ""])
def test_codec_round_trip(tmp_path, codec):
    fresh_prng()
    wf = _run(build(tmp_path, 1, compression=codec))
    ext = snapshotter.CODECS[codec][1]
    cur = str(tmp_path / ("tiny_current.pickle" + ext))
    # by extension, and by the magic bytes under a neutral name
    plain = str(tmp_path / "copy.bin")
    with open(cur, "rb") as fin, open(plain, "wb") as fout:
        fout.write(fin.read())
    for path in (cur, plain):
        state = load_snapshot(path)
        numpy.testing.assert_array_equal(
            state["__units__"]["all2all_tanh0"]["weights"],
            wf.forwards[0].weights.map_read())


def _flat(tree, prefix=""):
    return dict(compare_snapshots.walk(prefix, tree))


def _assert_trees_close(got, want, what):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want), what
    for path, v in want.items():
        g = got[path]
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert numpy.asarray(g).dtype == numpy.asarray(v).dtype, path
        numpy.testing.assert_allclose(g, v, rtol=RTOL, atol=ATOL,
                                      err_msg="%s %s" % (what, path))


def _ref_tree(tree):
    return jax.tree_util.tree_map(lambda v: numpy.asarray(
        jax.device_get(v)), tree)


@pytest.fixture(scope="module", params=["sgd", "adam"])
def reference_runs(request, tmp_path_factory):
    """The reference's 2-epoch run with its snapshot, and its own resume
    of that snapshot to 4 epochs."""
    solver = request.param
    d = tmp_path_factory.mktemp("ref_" + solver)
    fresh_ref_prng()
    first = _ref_init(build_ref(d / "a", 2, solver=solver))
    first.run()
    fresh_ref_prng()
    again = _ref_init(build_ref(d / "b", 4, with_snap=False, solver=solver))
    vt.resume(again, _current(d / "a"))
    again.decision.complete <<= False
    again.run()
    return solver, d, first, again


def _assert_matches_reference(port_dec, port_step, ref_wf, what):
    for cls in (TRAIN, VALID, TEST):
        numpy.testing.assert_allclose(
            port_dec.epoch_metrics[cls], ref_wf.decision.epoch_metrics[cls],
            atol=METRIC_ATOL, err_msg="%s set %d" % (what, cls))
    assert port_dec.epoch_number == ref_wf.decision.epoch_number == 4
    _assert_trees_close(port_step.params,
                        _ref_tree(ref_wf.train_step.params), what)
    _assert_trees_close(port_step.opt_state,
                        _ref_tree(ref_wf.train_step.opt_state), what)


def test_port_resumes_reference_snapshot(reference_runs, tmp_path):
    """(i) the reference's 2-epoch snapshot, continued by the port."""
    solver, d, _, ref_final = reference_runs
    fresh_prng()
    wf = build(tmp_path, 4, with_snap=False, solver=solver,
               lr_schedule=exp_decay(0.9))
    wf.initialize(device="cpu")
    resume(wf, _current(d / "a"))
    assert wf.decision.epoch_number == 2
    if solver == "adam":
        t = wf.train_step.opt_state["softmax1"]["t"]
        assert t.dtype == torch.int32 and t.dim() == 0 and int(t) == 20
    wf.decision.complete <<= False
    wf.run()
    _assert_matches_reference(wf.decision, wf.train_step, ref_final,
                              "port resumed " + solver)


def test_reference_resumes_port_snapshot(reference_runs, tmp_path):
    """(ii) the port's 2-epoch snapshot, continued by the reference."""
    solver, _, ref_first, ref_final = reference_runs
    fresh_prng()
    port = _run(build(tmp_path / "p", 2, solver=solver,
                      lr_schedule=exp_decay(0.9)))
    # the two 2-epoch runs agree before either crosses a file
    for cls in (TRAIN, VALID):
        numpy.testing.assert_allclose(
            port.decision.epoch_metrics[cls],
            ref_first.decision.epoch_metrics[cls], atol=METRIC_ATOL)
    fresh_ref_prng()
    ref = _ref_init(build_ref(tmp_path / "r", 4, with_snap=False,
                              solver=solver))
    vt.resume(ref, _current(tmp_path / "p"))
    assert ref.decision.epoch_number == 2
    ref.decision.complete <<= False
    ref.run()
    for cls in (TRAIN, VALID, TEST):
        numpy.testing.assert_allclose(
            ref.decision.epoch_metrics[cls],
            ref_final.decision.epoch_metrics[cls], atol=METRIC_ATOL)
    for attr in ("params", "opt_state"):
        _assert_trees_close(_ref_tree(getattr(ref.train_step, attr)),
                            _ref_tree(getattr(ref_final.train_step, attr)),
                            "reference resumed the port's " + attr)


class _StrictUnpickler(pickle.Unpickler):
    """Records every global; admits numpy's array, dtype and scalar
    reconstruction only."""

    seen = set()

    def find_class(self, module, name):
        self.seen.add((module, name))
        if module.split(".")[0] != "numpy" or name not in (
                "ndarray", "dtype", "_reconstruct", "_frombuffer",
                "scalar"):
            raise pickle.UnpicklingError("global %s.%s" % (module, name))
        return super().find_class(module, name)


def test_port_snapshot_is_the_reference_format(reference_runs, tmp_path):
    """The port's re-export of the reference's snapshot: numpy and
    builtins only, and the same tree as the reference's file."""
    solver, d, _, _ = reference_runs
    fresh_prng()
    wf = build(tmp_path / "x", 4, solver=solver, lr_schedule=exp_decay(0.9))
    wf.initialize(device="cpu")
    resume(wf, _current(d / "a"))
    path = wf.snapshotter.export()
    with gzip.open(path, "rb") as fin:
        unpickler = _StrictUnpickler(fin)
        mine = unpickler.load()
    assert not [g for g in unpickler.seen if "torch" in g[0]]
    theirs = vt.load_snapshot(_current(d / "a"))
    rows = {r["path"]: r for r in ref_compare.compare(theirs, mine)}
    # threefry's fold-in counter and root key: the reference's alone
    only_ref = sorted(p for p, r in rows.items() if r["status"] == "only_a")
    assert only_ref and all(p.rsplit("/", 1)[1] in ("_counter", "_jax_root")
                            for p in only_ref)
    differ = sorted(p for p, r in rows.items()
                    if r["status"] not in ("equal", "only_a"))
    assert differ == ["/__meta__/checksum", "/__meta__/time"]
    ref_walk = dict(ref_compare.walk("", theirs["__units__"]))
    port_walk = dict(compare_snapshots.walk("", mine["__units__"]))
    assert sorted(ref_walk) == sorted(port_walk)
    for p, v in ref_walk.items():
        assert numpy.shape(v) == numpy.shape(port_walk[p]), p
        assert numpy.asarray(v).dtype == numpy.asarray(port_walk[p]).dtype
    assert compare_snapshots.main([path, path]) == 0
    assert compare_snapshots.main([path, _current(d / "a")]) == 1


def test_unfitting_snapshot_names_the_unit(tmp_path):
    fresh_prng()
    _run(build(tmp_path / "a", 1))
    fresh_prng()
    wf = build(tmp_path / "b", 2, with_snap=False, hidden=9)
    wf.initialize(device="cpu")
    with pytest.raises(VelesError, match="all2all_tanh0.*does not fit"):
        resume(wf, _current(tmp_path / "a"))


def _write_state(state, path):
    with gzip.open(path, "wb") as fout:
        pickle.dump(state, fout)
    return path


def test_int8_and_async_snapshots_are_refused(tmp_path):
    """int8 snapshots are no longer refused: an int8 record reads back as
    ``q · s``. A record this build cannot read still is (another scheme,
    a record without its scale: the reference's ``dequantize_state``
    messages), and so is an asynchronous commit (item 11)."""
    fresh_prng()
    _run(build(tmp_path, 1))
    state = load_snapshot(_current(tmp_path))
    q = numpy.arange(-32, 32, dtype=numpy.int8).reshape(8, 8)
    scale = numpy.linspace(0.5, 4.0, 8, dtype=numpy.float32)[None]
    state["__units__"]["all2all_tanh0"]["weights"] = {
        "__quant__": "int8", "q": q, "scale": scale, "dtype": "float32",
        "granularity": "per_channel"}
    back = load_snapshot(_write_state(state, str(tmp_path / "q.pickle.gz")))
    got = back["__units__"]["all2all_tanh0"]["weights"]
    assert got.dtype == numpy.float32
    assert numpy.array_equal(got, q.astype(numpy.float32) * scale)
    state["__units__"]["all2all_tanh0"]["weights"] = {
        "__quant__": "int4", "q": q, "scale": scale}
    with pytest.raises(VelesError, match="unknown quant scheme 'int4'"):
        load_snapshot(_write_state(state, str(tmp_path / "q4.pickle.gz")))
    state["__units__"]["all2all_tanh0"]["weights"] = {
        "__quant__": "int8", "q": q}
    with pytest.raises(VelesError, match="missing its q/scale"):
        load_snapshot(_write_state(state, str(tmp_path / "qs.pickle.gz")))
    with pytest.raises(VelesError, match="item 11"):
        Snapshotter(None, directory=str(tmp_path), async_mode=True)


def test_snapshot_refuses_foreign_globals(tmp_path):
    path = str(tmp_path / "evil.pickle")
    with open(path, "wb") as fout:
        pickle.dump({"__units__": {"x": os.getcwd}}, fout)
    with pytest.raises(VelesError, match="refusing posix.getcwd"):
        load_snapshot(path)


def test_generator_states_cross_devices(caplog):
    """A torch generator's state rides the stream's snapshot; a state for
    another device type leaves this one reseeded, with a warning."""
    fresh_prng()
    gen = prng.get("drop").torch_generator("cpu")
    torch.rand(3, generator=gen)
    st = prng.get("drop").__getstate__()
    assert st["_torch_states"]["cpu"].dtype == numpy.uint8
    want = torch.rand(3, generator=gen)
    other = object.__new__(prng.RandomGenerator)
    other.__setstate__(dict(st))
    assert torch.equal(torch.rand(3, generator=other.torch_generator("cpu")),
                       want)
    card = dict(st, _torch_states={"cuda:0": numpy.zeros(16, numpy.uint8)})
    other.__setstate__(card)
    with caplog.at_level("WARNING"):
        fresh = other.torch_generator("cpu")
    assert "reseeds" in caplog.text
    assert torch.equal(torch.rand(3, generator=fresh), torch.rand(
        3, generator=torch.Generator().manual_seed(other.initial_seed)))
    assert other.__getstate__()["_torch_states"]["cuda:0"].shape == (16,)


@pytest.fixture
def small_mnist(monkeypatch):
    """A 600 / 200-row MNIST surrogate (784 wide) for the entry point."""
    monkeypatch.setattr(datasets, "load_mnist", lambda flat=True: (
        datasets.load_synthetic((28, 28), 10, 600, 200, flat,
                                key="mnist")))
    prev = root.common.engine.get("fused_fc_scan", False)
    yield
    root.common.engine.fused_fc_scan = prev


def test_mnist_entry_point_resumes(small_mnist, tmp_path, capsys):
    """``--snapshot-dir`` for 2 epochs, then ``--resume`` to 4, through
    the fused-FC route's plain version: the same epoch errors as 4
    straight epochs, and the snapshot's weights are the 2-epoch run's."""
    common = ["--fused-fc", "--epochs-per-dispatch", "2", "--device", "cpu"]
    prng.seed_all(1234)
    straight = mnist.main(["--epochs", "4"] + common)
    prng.seed_all(1234)
    first = mnist.main(["--epochs", "2", "--snapshot-dir", str(tmp_path)]
                       + common)
    cur = str(tmp_path / "mnist_current.pickle.gz")
    prng.seed_all(1234)
    resumed = mnist.main(["--epochs", "4", "--resume", cur] + common)
    out = capsys.readouterr().out
    assert "resumed from %s at epoch 2" % cur in out
    assert "fused-FC kernel: True" in out
    assert first["err_history"]["validation"] == \
        straight["err_history"]["validation"][:2]
    assert resumed["err_history"] == straight["err_history"]

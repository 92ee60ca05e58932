"""Data- and sequence-parallel training across processes
(``veles_tpu_torch/parallel/``, the train step under a mesh, the
launcher's and the CLI's multi-process flags) on the CPU.

One world of 2 gloo processes (``tests/torch_dist_child.py``, torch and
the port only) is spawned for the module and runs every scenario; the
reference and the one-process port runs happen here:

- data=2 on tests/test_dp_equivalence.py's blobs against the
  reference's ``{"data": 2}`` run from the same initial weights (the
  keyed streams give them bit for bit), at that file's limits: train
  error atol 0.01, validation 0.02, weights rtol 2e-3 / atol 2e-4;
  ``shard_dataset=True`` against the replicated run at the same limits;
  a dropout model against one process (every rank draws the whole
  minibatch's mask and keeps its rows);
- sequence=2 on the bench LM's builder at test width (RoPE at the
  block's global positions, the ring and Ulysses) against one process
  at the chip check's limits: NLL/token rel 1e-4, weights max abs 1e-3
  and 99.9th percentile 1e-5; a positional table + MHA + mean pool
  classifier against the reference's one-device run at
  tests/test_dp_equivalence.py's sequence limits (errors atol 0.02 /
  0.03, weights rtol 5e-3 / atol 5e-4);
- ``verify_checksums`` refusing a rank whose workflow differs;
- only the coordinator writing snapshots, and every rank resuming from
  its file to the uninterrupted run's weights;
- the CLI's two-process run; a recurrent unit under a sequence axis
  refused naming item 10 (the tensor/fsdp/expert axes run:
  tests/test_torch_sharding.py; the pipeline axis:
  tests/test_torch_pipeline.py; ``--elastic`` and its respawned worlds:
  tests/test_torch_elastic.py).
"""
import glob
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy
import pytest

import veles_tpu as vt
from veles_tpu import nn as ref_nn
from veles_tpu import prng as ref_prng
from veles_tpu.loader import FullBatchLoader as RefFullBatchLoader
from veles_tpu.loader import TRAIN, VALID
from veles_tpu_torch import backends
from veles_tpu_torch.backends import Mesh
from veles_tpu_torch.error import VelesError
from veles_tpu_torch.parallel.sharding import check_axes
from veles_tpu_torch.nn.standard_workflow import StandardWorkflow

import torch_dist_child as child
from torch_threads import one_torch_thread  # noqa: F401,E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIOS = ("dp_blobs", "dp_shard", "dp_dropout", "sp_lm",
             "sp_lm_ulysses", "sp_pool", "checksum", "snapshot")
#: seconds a spawned world may take (a dead rank fails its peer's next
#: collective at once)
WORLD_TIMEOUT = 300


def free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def free_ports(n):
    """``n`` distinct free ports, all held until each is known (one
    returned port is never handed out twice)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for sock in socks:
            sock.bind(("127.0.0.1", 0))
        return [sock.getsockname()[1] for sock in socks]
    finally:
        for sock in socks:
            sock.close()


def child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    return env


def start_world(world, outdir, scenarios, port=None):
    """Start ``scenarios`` in a gloo world of ``world`` child processes
    (its store at ``port``, default a free one); :func:`collect_world`
    waits for it."""
    port = port or free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_dist_child.py"),
         str(r), str(world), str(port), str(outdir), *scenarios],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=child_env()) for r in range(world)]
    return procs, str(outdir)


def collect_world(started):
    """{"<scenario>_<rank>": npz} of what a started world wrote; raises
    with the failed ranks' output."""
    procs, outdir = started
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORLD_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r in range(len(procs))
              if not os.path.exists(os.path.join(outdir, "done_%d" % r))]
    assert not failed, "ranks %s failed:\n%s" % (
        failed, "\n".join(logs[r][-3000:] for r in failed))
    return {os.path.basename(f)[:-4]: dict(numpy.load(f))
            for f in glob.glob(os.path.join(outdir, "*.npz"))}


def spawn_world(world, outdir, scenarios):
    return collect_world(start_world(world, outdir, scenarios))


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The module's processes, started together: the world of 2 running
    every scenario, and the CLI's two-process run
    (:func:`start_cli_pair`)."""
    cli_dir = tmp_path_factory.mktemp("cli")
    cli = start_cli_pair(cli_dir)
    try:
        world = spawn_world(2, tmp_path_factory.mktemp("world2"), SCENARIOS)
    finally:
        outs = [p.communicate(timeout=WORLD_TIMEOUT)[0] for p in cli]
    return {"world2": world, "cli": (cli, outs, cli_dir)}


@pytest.fixture(scope="module")
def world2(spawned):
    return spawned["world2"]


def ranks(results, name, world=2):
    """The scenario's per-rank results, checked identical across ranks
    (every rank applies the same update to the same weights)."""
    out = [results["%s_%d" % (name, r)] for r in range(world)]
    for key, value in out[0].items():
        if key.startswith("p_"):
            for other in out[1:]:
                numpy.testing.assert_array_equal(other[key], value,
                                                 err_msg=key)
    return out[0]


def params(res):
    return {k: v for k, v in res.items() if k.startswith("p_")}


def one_process(make, **kw):
    """The child's workflow builder run here, in one process."""
    wf = make(**kw)
    wf.initialize(device="cpu")
    wf.run()
    return child.result(wf)


# -- the reference's runs --------------------------------------------------
def _ref_loader(make, **kw):
    def load_data(self):
        x, y, lengths = make()
        self.create_originals(x, y)
        self.class_lengths = lengths
    cls = type("RefArrays", (RefFullBatchLoader,),
               {"hide_from_registry": True, "load_data": load_data})
    return cls(None, **kw)


def ref_run(make, layers, seed, mb, epochs, mesh_axes, name):
    """The reference's run of the child's workflow: the same names, so
    the same keyed streams (initial weights, shuffles)."""
    ref_prng.seed_all(seed)
    wf = ref_nn.StandardWorkflow(
        name="ref", layers=layers,
        loader_unit=_ref_loader(make, minibatch_size=mb, name=name),
        loss_function="softmax",
        decision_config=dict(max_epochs=epochs, fail_iterations=100))
    wf.initialize(device=vt.XLADevice(mesh_axes=mesh_axes))
    wf.run()
    import jax
    out = {"train_err": numpy.asarray(wf.decision.epoch_metrics[TRAIN]),
           "valid_err": numpy.asarray(wf.decision.epoch_metrics[VALID])}
    for i, f in enumerate(wf.forwards):
        for k, v in wf.train_step.params.get(f.name, {}).items():
            out["p_%d.%s" % (i, k)] = numpy.asarray(jax.device_get(v))
    return out


def assert_dp_limits(got, want, err_atol=0.01, valid_atol=0.02,
                     rtol=2e-3, atol=2e-4):
    numpy.testing.assert_allclose(got["train_err"], want["train_err"],
                                  atol=err_atol)
    numpy.testing.assert_allclose(got["valid_err"], want["valid_err"],
                                  atol=valid_atol)
    assert params(got).keys() == params(want).keys()
    for k in params(want):
        numpy.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                      err_msg=k)


def assert_lm_limits(got, want):
    """The chip check's limits: NLL/token rel 1e-4 per epoch, weights max
    abs 1e-3 and 99.9th percentile 1e-5."""
    for key in ("train_loss", "valid_loss"):
        numpy.testing.assert_allclose(got[key], want[key], rtol=1e-4)
    diff = numpy.sort(numpy.concatenate(
        [numpy.abs(got[k] - want[k]).ravel() for k in params(want)]))
    assert diff[-1] <= 1e-3
    assert diff[int(0.999 * (diff.size - 1))] <= 1e-5


# -- data parallelism ------------------------------------------------------
def test_data_parallel_matches_reference_data_mesh(world2):
    got = ranks(world2, "dp_blobs")
    want = ref_run(child.blobs, child.BLOBS_LAYERS, 1234, 40, 6,
                   {"data": 2}, "blobs-eq")
    assert got["train_err"].shape == (6,)
    assert_dp_limits(got, want)


def test_sharded_dataset_matches_replicated(world2):
    got = ranks(world2, "dp_shard")
    assert int(got["rows"]) == 480 // 2
    assert_dp_limits(got, ranks(world2, "dp_blobs"))


def test_data_parallel_dropout_draws_one_process_masks(world2):
    """Rank r draws what rows r·mb/2… draw in one process: the same
    trajectory. A mask drawn per rank would part it."""
    got = ranks(world2, "dp_dropout")
    want = one_process(child.blobs_workflow, layers=child.DROPOUT_LAYERS,
                       epochs=3)
    assert_dp_limits(got, want)


# -- sequence parallelism --------------------------------------------------
@pytest.mark.parametrize("scheme", ["ring", "ulysses"])
def test_sequence_parallel_lm_matches_one_process(world2, scheme):
    got = ranks(world2, "sp_lm_" + scheme)
    assert_lm_limits(got, one_process(child.lm_workflow))


def test_sequence_parallel_pool_matches_reference(world2):
    """Learned positions at each block's offset, MHA over the ring and
    the mean pool summed over the ranks, against the reference's one
    device."""
    got = ranks(world2, "sp_pool")
    assert int(got["engaged"]) == 1
    want = ref_run(child.sequences, child.POOL_LAYERS, 777, 32, 4,
                   {"data": 1}, "seq-eq")
    assert_dp_limits(got, want, err_atol=0.02, valid_atol=0.03, rtol=5e-3,
                     atol=5e-4)


# -- agreement, snapshots ---------------------------------------------------
def test_verify_checksums_refuses_a_differing_workflow(world2):
    for r in range(2):
        refused = str(world2["checksum_%d" % r]["refused"])
        assert "checksum mismatch" in refused and "rank(s) [1]" in refused


def test_only_the_coordinator_writes_and_every_rank_resumes(world2):
    paths = [json.loads(str(world2["snapshot_%d" % r]["paths"]))
             for r in range(2)]
    assert paths[0] and all(paths[0]) and not any(paths[1])
    assert len(paths[1]) == len(paths[0])
    written = [f for f in glob.glob(os.path.join(
        os.path.dirname(paths[0][0]), "dist_*.pickle.gz"))
        if "_current" not in f]
    assert sorted(written) == sorted(set(paths[0]))
    got = ranks(world2, "snapshot")
    want = ranks(world2, "dp_blobs")
    for k in params(want):
        numpy.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                      err_msg=k)
    assert got["train_err"][-1] == pytest.approx(want["train_err"][-1],
                                                 abs=1e-6)


# -- the CLI and the refusals ----------------------------------------------
CLI_MODEL = textwrap.dedent('''
    import sys
    sys.path.insert(0, %r)
    from torch_dist_child import blobs_workflow

    def build_workflow():
        return blobs_workflow(epochs=2)
''')


def start_cli_pair(tmp_path):
    """``python -m veles_tpu_torch --mesh data=2 --coordinator ...`` in two
    processes on a two-epoch blobs model file, each with a result
    file."""
    model = tmp_path / "blobs_model.py"
    model.write_text(CLI_MODEL % os.path.join(REPO, "tests"))
    port = free_port()
    return [subprocess.Popen(
        [sys.executable, "-m", "veles_tpu_torch", str(model), "--backend",
         "cpu", "--mesh", "data=2", "--coordinator", "127.0.0.1:%d" % port,
         "--num-processes", "2", "--process-id", str(r), "--result-file",
         str(tmp_path / ("results_%d.json" % r))],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=child_env()) for r in range(2)]


def test_cli_two_process_run(spawned):
    """The CLI's two processes both finish, only the coordinator writes
    the results, and its errors are the one-process run's."""
    procs, outs, tmp_path = spawned["cli"]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert (tmp_path / "results_0.json").exists()
    assert not (tmp_path / "results_1.json").exists()
    res = json.loads((tmp_path / "results_0.json").read_text())
    assert res["epochs"] == 2
    want = one_process(child.blobs_workflow, epochs=2)
    history = next(v for k, v in res.items() if k.endswith("_history"))
    numpy.testing.assert_allclose(history["train"], want["train_err"],
                                  atol=0.01)
    numpy.testing.assert_allclose(history["validation"], want["valid_err"],
                                  atol=0.02)


@pytest.mark.parametrize("axis", ["tensor", "fsdp", "expert", "pipeline"])
def test_unported_axis_names_item_10(axis):
    """Every axis of item 10 is ported (``pipeline`` by item 10.2):
    ``check_axes`` accepts each, and each meets make_mesh's size check
    like any other axis."""
    check_axes({"data": 1, axis: 2})
    with pytest.raises(VelesError, match="needs 2 processes"):
        backends.make_mesh({"data": 1, axis: 2})
    assert backends.current_mesh() is None


def test_recurrent_unit_under_a_sequence_axis_names_item_10():
    wf = StandardWorkflow(
        name="lstm-sp", layers=[{"type": "lstm", "hidden": 4},
                                {"type": "mean_pool"},
                                {"type": "softmax",
                                 "output_sample_shape": 2}],
        loader_unit=child.ArrayLoader(None, make=child.sequences,
                                      minibatch_size=32, name="seq"),
        loss_function="softmax",
        decision_config=dict(max_epochs=1, fail_iterations=100))
    backends.set_current_mesh(Mesh({"sequence": 2}, rank=0, world=1))
    try:
        with pytest.raises(VelesError, match="recurrent.*item 10"):
            wf.initialize(device="cpu")
    finally:
        backends.set_current_mesh(None)


def test_mesh_layout_and_validation():
    """Row-major coordinates, one -1 axis, the size checks (the
    reference's make_mesh)."""
    mesh = Mesh({"data": 2, "sequence": 3}, rank=4, world=1)
    assert mesh.coords == {"data": 1, "sequence": 1} and mesh.size == 6
    assert Mesh({"data": 2}, rank=3, world=1).member is False
    with pytest.raises(VelesError, match="at most one"):
        backends.make_mesh({"data": -1, "sequence": -1})
    with pytest.raises(VelesError, match="needs 2 processes"):
        backends.make_mesh({"data": 2})
    with pytest.raises(VelesError, match="unknown mesh axis"):
        backends.make_mesh({"rows": 2})
    try:
        mesh = backends.make_mesh({"sequence": -1})
        assert mesh.shape == {"sequence": 1} and mesh.group is None
    finally:
        backends.set_current_mesh(None)


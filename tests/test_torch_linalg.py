"""The port's blocked linear-algebra family (veles_tpu_torch/linalg/,
``python -m veles_tpu_torch linalg``) against the reference's
(veles_tpu/linalg/, tests/test_linalg.py) on the same numpy inputs, on
the CPU.

- ``cyclic_permutation`` equal to the reference's; the one-card matmul,
  the blocked Cholesky and both triangular solves within
  ``default_tolerance`` (100·eps of the dtype: 1.19e-5 in float32,
  2.2e-14 in float64) of float64 numpy and of the reference's results;
- SUMMA over gloo worlds of 2 (1×2, 2×1) and 4 (2×2) processes, cyclic
  and not, against the reference's ``blocked_matmul`` on the same grid
  of its 8 virtual CPU devices, each within ``default_tolerance`` of
  float64 numpy; every rank returns the whole C, the same on every rank;
  the Cholesky's trailing updates over the same meshes;
- CG on the Poisson problem: the reference's iteration count, residual
  histories within 1e-4 relative; preconditioned CG beats plain CG; a
  dense operator routes through ``blocked_matmul``;
- the refusals (not SPD, odd n, a non-SPD operator), the three chaos
  cases of ``linalg.block_op``, the counters and
  ``predict_summa_time``'s stated inputs;
- ``linalg bench`` and ``linalg solve`` as subprocesses: the reference's
  JSON keys and exit codes.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy
import pytest
import torch

from veles_tpu import linalg as ref_linalg
from veles_tpu_torch.linalg import (LINALG_COUNTERS, LinalgError,
                                    TwoLevelPoisson, blocked_cholesky,
                                    blocked_matmul,
                                    blocked_triangular_solve,
                                    build_cg_workflow, cholesky_solve,
                                    cyclic_permutation, default_tolerance,
                                    linalg_mesh, poisson2d_dense,
                                    poisson2d_matvec, predict_summa_time,
                                    verify_residual)
from veles_tpu_torch.models import poisson_solver
from veles_tpu_torch.resilience.faults import FaultInjected
from veles_tpu_torch.telemetry import counters
from veles_tpu_torch.telemetry.counters import DESCRIPTIONS
from torch_threads import one_torch_thread  # noqa: F401,E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = default_tolerance(numpy.float32)
F64_TOL = default_tolerance(numpy.float64)
#: CG residual histories: the dot products sum in another order
HISTORY_RTOL = 1e-4
CPU = "cpu"


def _spd(n, seed=3, dtype=numpy.float32):
    g = numpy.random.RandomState(seed).standard_normal((n, n))
    return (g @ g.T + n * numpy.eye(n)).astype(dtype)


def _rel(x, ref):
    x = numpy.asarray(x, numpy.float64)
    return float(numpy.linalg.norm(x - ref) / numpy.linalg.norm(ref))


def _delta(before):
    now = counters.snapshot()
    return {k: now.get(k, 0) - before.get(k, 0) for k in now}


# -- layout helpers ----------------------------------------------------------

@pytest.mark.parametrize("n_pad,slabs,p", [(24, 4, 2), (48, 8, 4),
                                           (16, 4, 4)])
def test_cyclic_permutation_equals_reference(n_pad, slabs, p):
    perm, inv = cyclic_permutation(n_pad, slabs, p)
    ref_perm, ref_inv = ref_linalg.cyclic_permutation(n_pad, slabs, p)
    numpy.testing.assert_array_equal(perm, ref_perm)
    numpy.testing.assert_array_equal(inv, ref_inv)
    x = numpy.arange(n_pad)
    assert (x[perm][inv] == x).all()
    with pytest.raises(LinalgError):
        cyclic_permutation(10, 4, 2)


def test_linalg_mesh_squarest_and_refusals():
    mesh = linalg_mesh()
    assert mesh.shape == {"rows": 1, "cols": 1} and mesh.member
    assert mesh.axis_names == ("rows", "cols")
    with pytest.raises(LinalgError, match="needs 2 processes, have 1"):
        linalg_mesh((1, 2))
    with pytest.raises(LinalgError, match="must be positive"):
        linalg_mesh((0, 1))


# -- blocked kernels vs numpy and the reference ------------------------------

@pytest.mark.parametrize("m,k,n,block", [(37, 23, 41, 8), (16, 16, 16, 64),
                                         (5, 7, 3, 4)])
def test_blocked_matmul_single_matches_dense_and_reference(m, k, n, block):
    rng = numpy.random.RandomState(0)
    a = rng.standard_normal((m, k)).astype(numpy.float32)
    b = rng.standard_normal((k, n)).astype(numpy.float32)
    ref = a.astype(numpy.float64) @ b.astype(numpy.float64)
    c = blocked_matmul(a, b, block=block, device=CPU)
    assert c.dtype == torch.float32 and c.device.type == "cpu"
    assert _rel(c, ref) < F32_TOL
    theirs = numpy.asarray(ref_linalg.blocked_matmul(a, b, block=block))
    assert _rel(c, theirs.astype(numpy.float64)) < F32_TOL


def test_blocked_matmul_keeps_float64():
    rng = numpy.random.RandomState(4)
    a = rng.standard_normal((33, 20))
    b = rng.standard_normal((20, 17))
    c = blocked_matmul(a, b, block=8, mesh=linalg_mesh(), device=CPU)
    assert c.dtype == torch.float64
    assert _rel(c, a @ b) < F64_TOL


def test_blocked_cholesky_matches_dense_and_reference():
    spd = _spd(45)
    ref = numpy.linalg.cholesky(spd.astype(numpy.float64))
    theirs = numpy.asarray(ref_linalg.blocked_cholesky(spd, block=16))
    for mesh in (None, linalg_mesh()):
        l = blocked_cholesky(spd, block=16, mesh=mesh, mesh_min=8,
                             device=CPU).numpy()
        assert _rel(l, ref) < F32_TOL
        assert _rel(l, theirs.astype(numpy.float64)) < F32_TOL
        assert numpy.array_equal(l, numpy.tril(l))


def test_blocked_cholesky_rejects_indefinite():
    bad = numpy.eye(12, dtype=numpy.float32)
    bad[5, 5] = -1.0
    before = counters.snapshot()
    with pytest.raises(LinalgError, match="not positive definite"):
        blocked_cholesky(bad, block=4, device=CPU)
    assert _delta(before).get("veles_linalg_residual_failures_total") == 1
    with pytest.raises(ref_linalg.LinalgError,
                       match="not positive definite"):
        ref_linalg.blocked_cholesky(bad, block=4)


def test_triangular_and_cholesky_solve():
    rng = numpy.random.RandomState(5)
    spd = _spd(33)
    b = rng.standard_normal((33, 2)).astype(numpy.float32)
    l = blocked_cholesky(spd, block=8, device=CPU).numpy()
    y = blocked_triangular_solve(l, b, lower=True, block=8,
                                 device=CPU).numpy()
    assert numpy.linalg.norm(l @ y - b) / numpy.linalg.norm(b) < F32_TOL
    ref_y = numpy.asarray(ref_linalg.blocked_triangular_solve(
        l, b, lower=True, block=8))
    assert _rel(y, ref_y.astype(numpy.float64)) < F32_TOL
    u = blocked_triangular_solve(l.T, b, lower=False, block=8,
                                 device=CPU).numpy()
    assert numpy.linalg.norm(l.T @ u - b) / numpy.linalg.norm(b) < F32_TOL
    x = cholesky_solve(spd, b, block=8, check=True, device=CPU).numpy()
    ref = numpy.linalg.solve(spd.astype(numpy.float64),
                             b.astype(numpy.float64))
    assert _rel(x, ref) < F32_TOL
    theirs = numpy.asarray(ref_linalg.cholesky_solve(spd, b, block=8))
    assert _rel(x, theirs.astype(numpy.float64)) < F32_TOL
    # a vector right-hand side comes back a vector
    assert blocked_triangular_solve(l, b[:, 0], block=8,
                                    device=CPU).shape == (33,)


def test_verify_residual_fails_loud():
    spd = _spd(16)
    b = numpy.ones((16,), dtype=numpy.float32)
    x = numpy.linalg.solve(spd, b)
    before = counters.snapshot()
    verify_residual(spd, x, b)
    verify_residual(torch.as_tensor(spd), torch.as_tensor(x), b)
    with pytest.raises(LinalgError, match="residual check FAILED"):
        verify_residual(spd, x + 1.0, b)
    delta = _delta(before)
    assert delta.get("veles_linalg_residual_checks_total") == 3
    assert delta.get("veles_linalg_residual_failures_total") == 1


# -- SUMMA over gloo worlds --------------------------------------------------

#: one rank: RANK WORLD PORT OUTDIR GRID... (each grid "PRxPC"); writes
#: OUTDIR/<grid>_<rank>.npz with the cyclic and plain SUMMA products and
#: the Cholesky factor over that grid
CHILD = textwrap.dedent("""
    import os, sys
    import numpy, torch
    sys.path.insert(0, %(repo)r)
    torch.set_num_threads(1)
    from veles_tpu_torch.linalg import (blocked_cholesky, blocked_matmul,
                                        linalg_mesh)
    from veles_tpu_torch.parallel import distributed

    rank, world, port = (int(a) for a in sys.argv[1:4])
    outdir = sys.argv[4]
    distributed.initialize_multihost("127.0.0.1:%%d" %% port, world, rank,
                                     device=torch.device("cpu"))
    rng = numpy.random.RandomState(1)
    a = rng.standard_normal((50, 30)).astype(numpy.float32)
    b = rng.standard_normal((30, 70)).astype(numpy.float32)
    g = numpy.random.RandomState(3).standard_normal((45, 45))
    spd = (g @ g.T + 45 * numpy.eye(45)).astype(numpy.float32)
    for grid in sys.argv[5:]:
        pr, pc = (int(v) for v in grid.split("x"))
        mesh = linalg_mesh((pr, pc))
        if not mesh.member:
            continue
        out = {}
        for cyclic in (True, False):
            out["c_%%d" %% cyclic] = blocked_matmul(
                a, b, block=16, mesh=mesh, cyclic=cyclic,
                device="cpu").numpy()
        out["chol"] = blocked_cholesky(spd, block=16, mesh=mesh,
                                       mesh_min=8, device="cpu").numpy()
        numpy.savez(os.path.join(outdir, "%%s_%%d.npz" %% (grid, rank)),
                    **out)
    distributed.shutdown()
    open(os.path.join(outdir, "done_%%d" %% rank), "w").close()
""")

WORLDS = {2: ("1x2", "2x1"), 4: ("2x2", "1x2")}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def summa_worlds(tmp_path_factory):
    """Both worlds, started together, once for the module."""
    tmp = tmp_path_factory.mktemp("summa")
    script = tmp / "child.py"
    script.write_text(CHILD % {"repo": REPO})
    procs = []
    for world, grids in WORLDS.items():
        outdir = tmp / ("w%d" % world)
        outdir.mkdir()
        port = _free_port()
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, str(script), str(rank), str(world),
                 str(port), str(outdir)] + list(grids),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=dict(os.environ, PYTHONPATH=REPO)))
    for p in procs:
        out = p.communicate(timeout=240)[0]
        assert p.returncode == 0, out[-3000:]
    return tmp


@pytest.mark.parametrize("world,grid", [(2, "1x2"), (2, "2x1"), (4, "2x2"),
                                        (4, "1x2")])
def test_summa_over_gloo_matches_reference_and_dense(summa_worlds, world,
                                                     grid):
    pr, pc = (int(v) for v in grid.split("x"))
    outdir = summa_worlds / ("w%d" % world)
    ranks = [numpy.load(outdir / ("%s_%d.npz" % (grid, r)))
             for r in range(pr * pc)]
    # ranks past a smaller grid idle
    assert not (outdir / ("%s_%d.npz" % (grid, pr * pc))).exists()
    rng = numpy.random.RandomState(1)
    a = rng.standard_normal((50, 30)).astype(numpy.float32)
    b = rng.standard_normal((30, 70)).astype(numpy.float32)
    ref = a.astype(numpy.float64) @ b.astype(numpy.float64)
    single = blocked_matmul(a, b, block=16, device=CPU).numpy()
    mesh = ref_linalg.linalg_mesh((pr, pc))
    for cyclic in (True, False):
        theirs = numpy.asarray(ref_linalg.blocked_matmul(
            a, b, block=16, mesh=mesh, cyclic=cyclic)).astype(numpy.float64)
        got = ranks[0]["c_%d" % cyclic]
        for other in ranks[1:]:
            numpy.testing.assert_array_equal(other["c_%d" % cyclic], got)
        assert _rel(got, ref) < F32_TOL, cyclic
        assert _rel(got, theirs) < F32_TOL, cyclic
        assert _rel(got, single.astype(numpy.float64)) < F32_TOL, cyclic
    g = numpy.random.RandomState(3).standard_normal((45, 45))
    spd = (g @ g.T + 45 * numpy.eye(45)).astype(numpy.float32)
    chol = numpy.linalg.cholesky(spd.astype(numpy.float64))
    assert _rel(ranks[0]["chol"], chol) < F32_TOL


# -- solvers on the Workflow graph -------------------------------------------

def _cg(package, n, rhs, precondition=False, **kw):
    if package == "port":
        pre = TwoLevelPoisson(n, block=16, device=CPU) if precondition \
            else None
        wf = build_cg_workflow(poisson2d_matvec(n), rhs,
                               preconditioner=pre, device=CPU, **kw)
    else:
        pre = ref_linalg.TwoLevelPoisson(n, block=16) if precondition \
            else None
        wf = ref_linalg.build_cg_workflow(ref_linalg.poisson2d_matvec(n),
                                          rhs, preconditioner=pre, **kw)
    wf.initialize()
    wf.run()
    return wf.cg_decision.get_metric_values()


@pytest.mark.parametrize("precondition", [False, True],
                         ids=["cg", "pcg"])
def test_cg_poisson_matches_reference(precondition):
    n = 12
    rhs = numpy.random.RandomState(7).standard_normal(
        n * n).astype(numpy.float32)
    before = counters.snapshot()
    res = _cg("port", n, rhs, precondition, tol=1e-6, max_iters=400)
    ref = _cg("ref", n, rhs, precondition, tol=1e-6, max_iters=400)
    assert res["converged"] and ref["converged"]
    assert res["residual"] < 1e-5
    assert res["true_residual"] is not None and res["true_residual"] < 1e-4
    if res["iterations"] != ref["iterations"]:
        print("port history", res["residual_history"])
        print("reference history", ref["residual_history"])
    assert res["iterations"] == ref["iterations"]
    numpy.testing.assert_allclose(res["residual_history"],
                                  ref["residual_history"],
                                  rtol=HISTORY_RTOL)
    assert len(res["residual_history"]) == res["iterations"] + 1
    delta = _delta(before)
    assert delta.get("veles_linalg_iterations_total") == res["iterations"]
    assert delta.get("veles_linalg_solves_total") == 1


def test_pcg_multigrid_beats_plain_cg():
    n = 12
    rhs = numpy.random.RandomState(9).standard_normal(
        n * n).astype(numpy.float32)
    cg = _cg("port", n, rhs, False, tol=1e-6, max_iters=400)
    pcg = _cg("port", n, rhs, True, tol=1e-6, max_iters=400)
    assert cg["converged"] and pcg["converged"]
    assert pcg["iterations"] < cg["iterations"]


def test_cg_dense_operator_routes_through_blocked_matmul():
    n = 8
    dense = poisson2d_dense(n)
    numpy.testing.assert_array_equal(dense, ref_linalg.poisson2d_dense(n))
    rhs = numpy.random.RandomState(8).standard_normal(
        n * n).astype(numpy.float32)
    before = counters.snapshot()
    wf = build_cg_workflow(dense, rhs, tol=1e-6, max_iters=200,
                           mesh=linalg_mesh(), block=16, device=CPU)
    wf.initialize()
    wf.run()
    res = wf.cg_decision.get_metric_values()
    assert res["converged"] and res["residual"] < 1e-5
    assert _delta(before).get("veles_linalg_matmuls_total") \
        == res["iterations"] + 1


def test_cg_rejects_non_spd_operator():
    wf = build_cg_workflow(lambda v: -v, numpy.ones(4, numpy.float32),
                           tol=1e-6, max_iters=10, device=CPU)
    wf.initialize()
    with pytest.raises(LinalgError, match="not SPD"):
        wf.run()


def test_twolevel_poisson_needs_even_n():
    with pytest.raises(LinalgError, match="even n"):
        TwoLevelPoisson(7, device=CPU)


def test_poisson_solver_model():
    wf = poisson_solver.build_workflow(n=8, tol=1e-6, max_iters=200,
                                       device=CPU)
    wf.initialize()
    wf.run()
    res = wf.cg_decision.get_metric_values()
    assert res["converged"] and res["residual"] < 1e-5
    assert poisson_solver.main(["--n", "8", "--precondition",
                                "--device", "cpu"]) == 0


# -- chaos: linalg.block_op --------------------------------------------------

def test_chaos_corrupt_block_fails_loud_never_silent(monkeypatch):
    """A corrupted block surfaces as a LinalgError from the residual
    check — never as a returned silently-wrong x."""
    spd = _spd(24)
    b = numpy.ones((24, 1), dtype=numpy.float32)
    monkeypatch.setenv("VELES_FAULTS", "linalg.block_op:corrupt")
    with pytest.raises(LinalgError):
        cholesky_solve(spd, b, block=8, check=True, device=CPU)
    monkeypatch.setenv("VELES_FAULTS", "")


def test_chaos_corrupt_cg_reports_nonconvergence(monkeypatch):
    n = 6
    rhs = numpy.ones(n * n, dtype=numpy.float32)
    monkeypatch.setenv("VELES_FAULTS", "linalg.block_op:corrupt")
    wf = build_cg_workflow(poisson2d_dense(n), rhs, tol=1e-8, max_iters=25,
                           block=8, device=CPU)
    wf.initialize()
    try:
        wf.run()
        res = wf.cg_decision.get_metric_values()
        assert not res["converged"] or res["true_residual"] < 1e-6
    except LinalgError:
        pass                     # a loud failure is as good
    finally:
        monkeypatch.setenv("VELES_FAULTS", "")


def test_chaos_raise_propagates(monkeypatch):
    a = numpy.random.RandomState(2).standard_normal((8, 8)).astype(
        numpy.float32)
    monkeypatch.setenv("VELES_FAULTS", "linalg.block_op:raise:times=1")
    with pytest.raises(FaultInjected):
        blocked_matmul(a, a, block=8, device=CPU)
    monkeypatch.setenv("VELES_FAULTS", "")
    blocked_matmul(a, a, block=8, device=CPU)           # healed


def test_clean_dispatch_returns_the_block_itself():
    a = torch.randn(4, 4)
    from veles_tpu_torch.linalg.blocked import _dispatch_block
    assert _dispatch_block(a, op="x") is a


# -- telemetry + the scaling model -------------------------------------------

def test_linalg_counters_registered():
    for name in LINALG_COUNTERS:
        assert name in DESCRIPTIONS, name
        assert DESCRIPTIONS[name] == __import__(
            "veles_tpu.telemetry.counters",
            fromlist=["DESCRIPTIONS"]).DESCRIPTIONS[name]
    assert LINALG_COUNTERS == ref_linalg.LINALG_COUNTERS
    before = counters.snapshot()
    a = numpy.eye(4, dtype=numpy.float32)
    blocked_matmul(a, a, block=4, device=CPU)
    delta = _delta(before)
    assert delta.get("veles_linalg_matmuls_total") == 1
    assert delta.get("veles_linalg_block_ops_total") == 1


def test_predict_summa_time_states_every_input():
    pred = predict_summa_time(384, 384, 384, (2, 4), t1_step_s=1.0,
                              device_kind="NVIDIA H100 80GB HBM3")
    inputs = pred["inputs"]
    for field in ("t1_step_s", "grid", "panels", "block_bytes_a_panel",
                  "block_bytes_b_panel", "psum_bytes_per_device",
                  "ici_bw_assumed_bytes_per_s", "ici_bw_source"):
        assert field in inputs, field
    assert inputs["ici_bw_source"] == "telemetry.cost.LINK_BW_BYTES[h100]"
    assert inputs["ici_bw_assumed_bytes_per_s"] == 450e9
    theirs = ref_linalg.predict_summa_time(384, 384, 384, (2, 4),
                                           t1_step_s=1.0, ici_bw=450e9)
    for field in ("panels", "block_bytes_a_panel", "block_bytes_b_panel",
                  "psum_bytes_per_device"):
        assert inputs[field] == theirs["inputs"][field], field
    assert pred["predicted_step_s"] == pytest.approx(
        theirs["predicted_step_s"])
    solo = predict_summa_time(384, 384, 384, (1, 1), t1_step_s=1.0)
    assert solo["comm_s"] == 0
    assert solo["predicted_step_s"] == pytest.approx(1.0)


# -- the CLI -------------------------------------------------------------------

def _cli(*argv):
    return subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch", "linalg"] + list(argv),
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, VELES_BACKEND="cpu", PYTHONPATH=REPO))


def test_linalg_cli_bench_and_solve_match_reference(tmp_path, capsys):
    from veles_tpu import __main__ as ref_main
    assert ref_main._linalg_cli(["bench", "--m", "40", "--k", "24", "--n",
                                 "32", "--cholesky", "24", "--block",
                                 "8"]) == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    r = _cli("bench", "--m", "40", "--k", "24", "--n", "32", "--cholesky",
             "24", "--block", "8")
    assert r.returncode == 0, r.stderr[-3000:]
    mine = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(theirs) <= set(mine)
    for key in ("matmul", "predicted", "cholesky"):
        assert set(theirs[key]) <= set(mine[key]), key
    assert set(theirs["predicted"]["inputs"]) <= set(
        mine["predicted"]["inputs"])
    assert mine["grid"] == "1x1" and mine["dtype"] == "float32"
    assert mine["matmul"]["rel_err"] < F32_TOL
    assert mine["cholesky"]["rel_err"] < F32_TOL

    report = tmp_path / "solve.json"
    r = _cli("solve", "--n", "8", "--precondition", "--json", str(report))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "converged" in r.stdout and "multigrid V-cycle" in r.stdout
    doc = json.load(open(report))
    assert ref_main._linalg_cli(["solve", "--n", "8", "--precondition",
                                 "--json", str(tmp_path / "ref.json")]) == 0
    ref_doc = json.load(open(tmp_path / "ref.json"))
    assert set(ref_doc) <= set(doc)
    assert doc["iterations"] == ref_doc["iterations"]
    # a solve that runs out of iterations exits 1, as the reference's
    r = _cli("solve", "--n", "16", "--max-iters", "2")
    assert r.returncode == 1 and "DID NOT CONVERGE" in r.stdout
    capsys.readouterr()
    assert ref_main._linalg_cli(["solve", "--n", "16", "--max-iters",
                                 "2"]) == 1


def test_linalg_cli_two_processes(tmp_path):
    """``--grid 1x2`` over a world of 2: only rank 0 prints the report,
    and both exit 0."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "veles_tpu_torch", "linalg", "bench",
         "--m", "40", "--k", "24", "--n", "32", "--cholesky", "24",
         "--block", "8", "--grid", "1x2", "--coordinator",
         "127.0.0.1:%d" % port, "--num-processes", "2", "--process-id",
         str(rank)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=REPO,
        env=dict(os.environ, VELES_BACKEND="cpu", PYTHONPATH=REPO))
        for rank in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    doc = json.loads(outs[0][0].strip().splitlines()[-1])
    assert doc["grid"] == "1x2" and doc["matmul"]["rel_err"] < F32_TOL
    assert doc["predicted"]["comm_s"] > 0
    assert outs[1][0].strip() == ""

"""Iterative solvers as Workflow graphs of Units (counterpart of
``veles_tpu/linalg/solvers.py``).

Conjugate gradient runs on the SAME dataflow engine every training
workflow runs on — a ``Repeater`` loop head, a step unit, a decision
unit gating the back edge against the EndPoint — so the control plane
(gates, spans, the flight recorder) applies to a linear solve exactly as
to an SGD loop.

Residual telemetry is per iteration: :class:`CGStep` appends to the
state's ``residual_history``, stamps a ``linalg.cg_iteration`` span and
counts ``veles_linalg_iterations_total``. When the workflow finishes
*claiming convergence*, :class:`CGWorkflow` re-verifies the answer
through ``blocked.verify_residual`` (the trusted host path, outside the
faultable block dispatch) and raises instead of returning a
silently-wrong x.

:class:`TwoLevelPoisson` is the 2-level multigrid V-cycle
preconditioner: damped-Jacobi smoothing around a Galerkin coarse-grid
correction whose coarse operator is factored ONCE with
``blocked_cholesky``. Plug it into :func:`build_cg_workflow` through
``preconditioner=`` for PCG.

The state's tensors live on the workflow's device: ``device=`` at
construction, else the one ``initialize(device=...)`` gives, else the
card (``backends.device_for``).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy
import torch

from ..backends import device_for
from ..mutable import Bool
from ..plumbing import Repeater
from ..telemetry.counters import inc
from ..telemetry.spans import span
from ..units import Unit
from ..workflow import Workflow
from .blocked import (DEFAULT_BLOCK, LinalgError, _tensor,
                      blocked_cholesky, blocked_matmul,
                      blocked_triangular_solve, residual_tolerance,
                      verify_residual)


class CGState:
    """The solve's mutable state, shared by the CG units through
    ``link_attrs`` (one object, no copies across the loop)."""

    def __init__(self):
        self.x = None
        self.r = None
        self.p = None
        self.z = None
        self.rz = 0.0
        self.bnorm = 1.0
        self.iteration = 0
        self.residual_history = []
        self.converged = False
        self.true_residual = None

    @property
    def residual(self) -> float:
        return (self.residual_history[-1] if self.residual_history
                else float("inf"))


class CGSetup(Unit):
    """Prepares the Krylov state: r₀ = b − A x₀, the first
    (preconditioned) direction, the residual norm baseline. Re-running
    the workflow re-seeds the state, so a solve is repeatable."""

    MAPPING = "cg_setup"

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("name", "CGSetup")
        super().__init__(workflow, **kwargs)
        self.operator: Optional[Callable] = None   # matvec callable
        self.rhs = None
        self.x0 = None
        self.preconditioner: Optional[Callable] = None
        self.device: Optional[torch.device] = None
        self.state = CGState()
        self.demand("operator", "rhs")

    def run(self):
        st = self.state
        b = _tensor(self.rhs, self.device)
        st.x = (torch.zeros_like(b) if self.x0 is None
                else _tensor(self.x0, self.device))
        st.r = b - self.operator(st.x)
        st.z = (self.preconditioner(st.r) if self.preconditioner
                else st.r)
        st.p = st.z
        st.rz = float(st.r @ st.z)
        st.bnorm = float(torch.linalg.vector_norm(b)) or 1.0
        st.iteration = 0
        st.residual_history = [
            float(torch.linalg.vector_norm(st.r)) / st.bnorm]
        st.converged = False
        st.true_residual = None


class CGStep(Unit):
    """One conjugate-gradient iteration over the linked :class:`CGState`
    — the loop body between Repeater and decision. Appends the
    recurrence residual to ``residual_history`` and stamps the
    per-iteration telemetry (``linalg.cg_iteration`` span,
    ``veles_linalg_iterations_total``)."""

    MAPPING = "cg_step"

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("name", "CGStep")
        super().__init__(workflow, **kwargs)
        self.operator: Optional[Callable] = None
        self.preconditioner: Optional[Callable] = None
        self.state: Optional[CGState] = None
        self.demand("operator", "state")

    def run(self):
        st = self.state
        q = self.operator(st.p)
        pq = float(st.p @ q)
        if pq <= 0:
            raise LinalgError(
                "cg: direction curvature p·Ap = %.3e <= 0 — operator "
                "is not SPD (or a corrupt block op broke it)" % pq)
        alpha = st.rz / pq
        st.x = st.x + alpha * st.p
        st.r = st.r - alpha * q
        st.z = (self.preconditioner(st.r) if self.preconditioner
                else st.r)
        rz_new = float(st.r @ st.z)
        beta = rz_new / st.rz if st.rz else 0.0
        st.p = st.z + beta * st.p
        st.rz = rz_new
        st.iteration += 1
        resid = float(torch.linalg.vector_norm(st.r)) / st.bnorm
        st.residual_history.append(resid)
        inc("veles_linalg_iterations_total")
        with span("linalg.cg_iteration", iteration=st.iteration,
                  resid=resid):
            pass


class CGDecision(Unit):
    """Convergence gate of the solve loop: latches ``complete`` when the
    recurrence residual reaches ``tol`` or ``max_iters`` runs out (the
    workflow wires ``repeater.gate_block = complete`` and
    ``end_point.gate_block = ~complete``, the training Decision's back
    edge)."""

    MAPPING = "cg_decision"

    def __init__(self, workflow, **kwargs):
        self.tol = float(kwargs.pop("tol", 1e-6))
        self.max_iters = int(kwargs.pop("max_iters", 500))
        kwargs.setdefault("name", "CGDecision")
        super().__init__(workflow, **kwargs)
        self.state: Optional[CGState] = None
        self.complete = Bool(False)
        self.demand("state")

    def run(self):
        st = self.state
        st.converged = st.residual <= self.tol
        self.complete <<= (st.converged
                           or st.iteration >= self.max_iters)

    def get_metric_values(self):
        st = self.state
        return {
            "iterations": st.iteration,
            "residual": st.residual,
            "residual_history": list(st.residual_history),
            "converged": bool(st.converged),
            "true_residual": st.true_residual,
        }


class CGWorkflow(Workflow):
    """Conjugate gradient on the dataflow graph:
    ``Start → CGSetup → Repeater → CGStep → CGDecision`` with the
    decision gating the back edge and the EndPoint.

    ``operator`` may be a dense (n, n) matrix — the matvec then runs
    through :func:`blocked_matmul` over ``mesh``, and the final
    verification applies the matrix with a plain dense product on the
    host — or any SPD matvec callable (verified against itself: the
    callable is the caller's trusted problem definition). On a finish
    that *claims* convergence the answer must pass ``verify_residual``
    within ``verify_tol`` (default ``max(100·tol, dtype residual
    floor)``) or the run raises: never a silently-wrong x."""

    def __init__(self, workflow=None, operator=None, rhs=None, x0=None,
                 tol: float = 1e-6, max_iters: int = 500,
                 preconditioner: Optional[Callable] = None,
                 mesh=None, block: int = DEFAULT_BLOCK,
                 verify_tol: Optional[float] = None, device=None,
                 **kwargs):
        kwargs.setdefault("name", "cg")
        super().__init__(workflow, **kwargs)
        if operator is None or rhs is None:
            raise LinalgError("CGWorkflow needs operator= and rhs=")
        self._dense = None if callable(operator) else operator
        if self._dense is not None:
            matvec = _blocked_matvec(self._dense, mesh, block)
        else:
            matvec = operator
        self.rhs = rhs
        self.verify_tol = verify_tol
        self.tol = float(tol)
        self._device = device

        self.cg_setup = CGSetup(self)
        self.cg_setup.operator = matvec
        self.cg_setup.rhs = rhs
        self.cg_setup.x0 = x0
        self.cg_setup.preconditioner = preconditioner
        self.repeater = Repeater(self)
        self.cg_step = CGStep(self)
        self.cg_step.operator = matvec
        self.cg_step.preconditioner = preconditioner
        self.cg_step.link_attrs(self.cg_setup, "state")
        self.cg_decision = CGDecision(self, tol=tol, max_iters=max_iters)
        self.cg_decision.link_attrs(self.cg_setup, "state")

        self.cg_setup.link_from(self.start_point)
        self.repeater.link_from(self.cg_setup)
        self.cg_step.link_from(self.repeater)
        self.cg_decision.link_from(self.cg_step)
        self.repeater.link_from(self.cg_decision)
        self.repeater.gate_block = self.cg_decision.complete
        self.end_point.link_from(self.cg_decision)
        self.end_point.gate_block = ~self.cg_decision.complete

    def initialize(self, **kwargs):
        """Resolves the solve's device (the constructor's, else
        ``device=`` here, else the card) before the units initialise."""
        self.cg_setup.device = device_for(
            self._device if self._device is not None
            else kwargs.get("device"))
        return super().initialize(**kwargs)

    @property
    def solution(self):
        return self.cg_setup.state.x

    def on_workflow_finished(self):
        st = self.cg_setup.state
        if st.converged:
            bound = (self.verify_tol if self.verify_tol is not None
                     else max(100.0 * self.tol,
                              residual_tolerance(st.x.dtype)))
            target = (self._dense if self._dense is not None
                      else self.cg_setup.operator)
            st.true_residual = verify_residual(
                target, st.x, self.rhs, tol=bound, what="linalg.cg")
        inc("veles_linalg_solves_total")
        super().on_workflow_finished()


def _blocked_matvec(a, mesh, block: int) -> Callable:
    """Dense matvec routed through the blocked (and, given a mesh,
    SUMMA-sharded) matmul — the faultable path CG iterates through. The
    matrix is put on a vector's device once."""
    placed = {}

    def matvec(v):
        if v.device not in placed:
            placed[v.device] = _tensor(a, v.device)
        return blocked_matmul(placed[v.device], v[:, None], block=block,
                              mesh=mesh)[:, 0]
    return matvec


def build_cg_workflow(operator, rhs, **kwargs) -> CGWorkflow:
    """Convenience constructor mirroring the models' public
    ``build_workflow`` shape; see :class:`CGWorkflow` for knobs."""
    return CGWorkflow(operator=operator, rhs=rhs, **kwargs)


# ---------------------------------------------------------------------------
# the SPD Poisson model problem + 2-level multigrid preconditioner
# ---------------------------------------------------------------------------

def poisson2d_matvec(n: int) -> Callable:
    """The 5-point 2D Dirichlet Laplacian on an n×n interior grid as a
    matvec over flattened (n²,) vectors: (Au)ᵢⱼ = 4uᵢⱼ − u_{i±1,j} −
    u_{i,j±1} (zero outside). SPD — the family's model problem."""
    pad = torch.nn.functional.pad

    def apply(v):
        u = torch.as_tensor(v).reshape(n, n)
        out = 4.0 * u
        out = out - pad(u[1:, :], (0, 0, 0, 1))
        out = out - pad(u[:-1, :], (0, 0, 1, 0))
        out = out - pad(u[:, 1:], (0, 1, 0, 0))
        out = out - pad(u[:, :-1], (1, 0, 0, 0))
        return out.reshape(-1)
    return apply


def poisson2d_dense(n: int, dtype=numpy.float32) -> numpy.ndarray:
    """The same operator as an explicit dense (n², n²) numpy matrix —
    the reference for small equality tests."""
    size = n * n
    a = numpy.zeros((size, size), dtype=dtype)
    for i in range(n):
        for j in range(n):
            k = i * n + j
            a[k, k] = 4.0
            if i > 0:
                a[k, k - n] = -1.0
            if i < n - 1:
                a[k, k + n] = -1.0
            if j > 0:
                a[k, k - 1] = -1.0
            if j < n - 1:
                a[k, k + 1] = -1.0
    return a


class TwoLevelPoisson:
    """Symmetric 2-level multigrid V-cycle preconditioner for
    :func:`poisson2d_matvec` (n even): damped-Jacobi pre-smooth, a
    Galerkin coarse-grid correction (restriction = 2×2 aggregation,
    prolongation its transpose, coarse operator A_c = PᵀAP factored ONCE
    with ``blocked_cholesky``), damped-Jacobi post-smooth. The same
    smoother on both sides keeps M⁻¹ symmetric positive definite, so it
    drops straight into PCG through ``preconditioner=``.

    The set-up applies the fine operator once for each of the nc² coarse
    unknowns (4,096 at n 128), each column written on the device, and
    factors the coarse operator; ``setup_s`` is its wall time."""

    def __init__(self, n: int, omega: float = 0.8,
                 block: int = DEFAULT_BLOCK, mesh=None,
                 dtype=numpy.float32, device=None):
        if n % 2:
            raise LinalgError("TwoLevelPoisson needs even n, got %d" % n)
        t0 = time.perf_counter()
        self.n = n
        self.nc = n // 2
        self.omega = float(omega)
        self.device = device_for(device)
        self._apply = poisson2d_matvec(n)
        size_c = self.nc * self.nc
        tdtype = torch.from_numpy(numpy.zeros(0, dtype=dtype)).dtype
        a_c = torch.zeros((size_c, size_c), dtype=tdtype,
                          device=self.device)
        e = torch.zeros(size_c, dtype=tdtype, device=self.device)
        for i in range(size_c):
            e.zero_()
            e[i] = 1.0
            a_c[:, i] = self._restrict(self._apply(self._prolong(e)))
        self._chol_c = blocked_cholesky(a_c, block=block, mesh=mesh)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_s = time.perf_counter() - t0

    def _prolong(self, zc):
        u = zc.reshape(self.nc, self.nc)
        return u.repeat_interleave(2, dim=0).repeat_interleave(
            2, dim=1).reshape(-1)

    def _restrict(self, r):
        u = r.reshape(self.nc, 2, self.nc, 2)
        return u.sum(dim=(1, 3)).reshape(-1)

    def _coarse_solve(self, rc):
        y = blocked_triangular_solve(self._chol_c, rc, lower=True)
        return blocked_triangular_solve(self._chol_c.T, y, lower=False)

    def __call__(self, r):
        r = _tensor(r, self.device)
        z = self.omega * r / 4.0                       # pre-smooth
        d = r - self._apply(z)
        z = z + self._prolong(self._coarse_solve(self._restrict(d)))
        z = z + self.omega * (r - self._apply(z)) / 4.0  # post-smooth
        return z

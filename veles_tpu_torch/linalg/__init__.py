"""The blocked linear-algebra workload family (counterpart of
``veles_tpu/linalg/``).

Blocked, mesh-sharded dense kernels (:mod:`blocked`: SUMMA over a 2D
mesh of processes, the right-looking Cholesky and its solves) and
iterative solvers hosted on the Workflow/Unit graph (:mod:`solvers`: CG
and multigrid-preconditioned CG on the Poisson model problem) — the
first non-NN workloads of the port, instrumented through the same
telemetry, cost and fault planes as training. ``python -m
veles_tpu_torch linalg bench|solve`` drives them.
"""

#: every counter this package increments (telemetry/counters.py
#: DESCRIPTIONS)
LINALG_COUNTERS = (
    "veles_linalg_block_ops_total",
    "veles_linalg_matmuls_total",
    "veles_linalg_factorizations_total",
    "veles_linalg_solves_total",
    "veles_linalg_iterations_total",
    "veles_linalg_residual_checks_total",
    "veles_linalg_residual_failures_total",
)

from .blocked import (DEFAULT_BLOCK, LinalgError,  # noqa: E402
                      blocked_cholesky, blocked_matmul,
                      blocked_triangular_solve, cholesky_solve,
                      cyclic_permutation, default_tolerance, linalg_mesh,
                      matmul_cost, cholesky_cost, predict_summa_time,
                      residual_tolerance, verify_residual)
from .solvers import (CGDecision, CGSetup, CGState,  # noqa: E402
                      CGStep, CGWorkflow, TwoLevelPoisson,
                      build_cg_workflow, poisson2d_dense,
                      poisson2d_matvec)

__all__ = [
    "LINALG_COUNTERS",
    "DEFAULT_BLOCK", "LinalgError", "blocked_cholesky",
    "blocked_matmul", "blocked_triangular_solve", "cholesky_solve",
    "cyclic_permutation", "default_tolerance", "linalg_mesh",
    "matmul_cost", "cholesky_cost", "predict_summa_time",
    "residual_tolerance", "verify_residual", "CGDecision", "CGSetup",
    "CGState", "CGStep", "CGWorkflow", "TwoLevelPoisson",
    "build_cg_workflow", "poisson2d_dense", "poisson2d_matvec",
]

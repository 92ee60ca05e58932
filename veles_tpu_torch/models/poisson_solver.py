"""Poisson solver — the first non-NN model of the port (counterpart of
``models/poisson_solver.py``).

Conjugate gradient on the 5-point 2D Dirichlet Laplacian (n×n interior
grid, n² unknowns) as a Workflow graph of Units
(``veles_tpu_torch/linalg/solvers.py``): Repeater loop head, CGStep
body, CGDecision gating the back edge. ``--precondition`` arms the
2-level multigrid V-cycle (damped-Jacobi smoothing around a Galerkin
coarse grid factored once with the blocked Cholesky), cutting the
iteration count severalfold.

A finish that claims convergence is re-verified on the host against the
operator (``verify_residual``): the run raises rather than return a
silently-wrong answer.

    python -m veles_tpu_torch.models.poisson_solver [--n N] [--tol T] \\
        [--precondition] [--device cpu]

runs on the card unless ``--device cpu`` is given
(``build_workflow``'s default device follows ``VELES_BACKEND``, so the
main CLI's ``python -m veles_tpu_torch veles_tpu_torch/models/
poisson_solver.py`` takes it too).
"""

import argparse
import sys

import numpy

from ..backends import device_for, device_for_backend
from ..linalg import TwoLevelPoisson, build_cg_workflow, poisson2d_matvec


def build_workflow(n=64, tol=1e-6, max_iters=500, precondition=False,
                   rhs=None, seed=0, block=None, mesh=None, device=None):
    """CGWorkflow over the n×n Poisson operator. ``rhs=None`` draws a
    seeded random right-hand side (the model-problem default)."""
    if rhs is None:
        rhs = numpy.random.RandomState(seed).standard_normal(
            n * n).astype(numpy.float32)
    device = (device_for(device) if device is not None
              else device_for_backend(None))
    kwargs = {}
    if block is not None:
        kwargs["block"] = block
    precond = None
    if precondition:
        precond = TwoLevelPoisson(n, mesh=mesh, device=device, **kwargs)
    return build_cg_workflow(poisson2d_matvec(n), rhs, tol=tol,
                             max_iters=max_iters, mesh=mesh,
                             preconditioner=precond, device=device,
                             **kwargs)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--n", type=int, default=64,
                        help="interior grid side (n^2 unknowns)")
    parser.add_argument("--tol", type=float, default=1e-6)
    parser.add_argument("--max-iters", type=int, default=500)
    parser.add_argument("--precondition", action="store_true",
                        help="2-level multigrid V-cycle (even --n)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="cpu, or the card (default)")
    args = parser.parse_args(argv)
    wf = build_workflow(n=args.n, tol=args.tol,
                        max_iters=args.max_iters,
                        precondition=args.precondition, seed=args.seed,
                        device=args.device or "cuda")
    wf.initialize()
    wf.run()
    res = wf.cg_decision.get_metric_values()
    print("poisson %dx%d%s: %s in %d iteration(s), residual %.3e, "
          "true residual %s"
          % (args.n, args.n,
             " + multigrid" if args.precondition else "",
             "converged" if res["converged"] else "DID NOT CONVERGE",
             res["iterations"], res["residual"],
             "%.3e" % res["true_residual"]
             if res["true_residual"] is not None else "(unverified)"))
    return 0 if res["converged"] else 1


if __name__ == "__main__":
    sys.exit(main())

"""Blocked, mesh-sharded dense linear algebra (counterpart of
``veles_tpu/linalg/blocked.py``).

The first non-NN workload family of the port. Dense matrices are tiled
into blocks, the block grid is laid out block-cyclically over a 2D
``("rows", "cols")`` mesh of processes (:func:`linalg_mesh`, a
``backends.Mesh`` over the ``torch.distributed`` world), and every
distributed operation is local block products plus all-reduces.

Three layers, each held against the one below:

- :func:`blocked_matmul` — SUMMA: for each of the ``G = lcm(pr, pc)``
  k-panels, the owner column's A panel reaches its mesh row by a masked
  ``all_reduce`` (the other ranks add zeros, so the sum is the panel
  itself, bit for bit), the owner row's B panel reaches its mesh column
  the same way, and every rank adds one local product. The blocks of C
  are gathered once, at the end, so every rank returns the whole C. The
  one-card path runs the same k-panel loop without the mesh.
- :func:`blocked_cholesky` / :func:`blocked_triangular_solve` —
  right-looking blocked factorization: ``torch.linalg.cholesky_ex`` of
  the diagonal block, a triangular solve for the panel, and the
  trailing update ``A22 -= L21 @ L21.T`` through :func:`blocked_matmul`
  (where the mesh enters).
- :func:`verify_residual` — the trusted check every solver passes
  before it returns an answer: the operator applied on the host in
  float64, never through the faultable block dispatch, so an injected
  corruption cannot vouch for itself.

Every tensor lives on the device :func:`backends.device_for` resolves
(the card unless the caller asks for the CPU), which also applies the
port's float32 policy: no TF32 anywhere, so float32 products round as
float32 (a TF32 product misses the stated tolerance by ~100×). Inputs
keep their dtype: float64 stays float64.

Fault surface: every block dispatch calls
``resilience.faults.fire("linalg.block_op")`` — ``raise`` aborts the
dispatch, ``corrupt`` flips a byte of the block. Costs are recorded in
``telemetry.cost.model`` as analytic entries (2mnk for a product, n³/3
for a factorization) keyed ``linalg.*``; MFU is priced against the
computation dtype's peak.

Tolerances: blocked results match the dense reference within
``rtol = 100·eps(dtype)`` of the result's scale (f32 ≈ 1.2e-5, f64 ≈
2.2e-14), and solver residuals must pass :func:`verify_residual`'s
bound (:data:`RESIDUAL_TOL` by dtype).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple, Union

import numpy
import torch

from ..backends import Mesh, device_for
from ..error import VelesError
from ..resilience import faults
from ..telemetry import cost as cost_mod
from ..telemetry.counters import inc
from ..telemetry.spans import span


class LinalgError(VelesError):
    """A linear-algebra kernel produced (or was asked to produce) an
    answer it cannot stand behind: residual check failure, non-SPD input
    to Cholesky, malformed mesh or shape."""


#: default k-panel width of the one-card blocked paths
DEFAULT_BLOCK = 128

#: default relative residual bound of :func:`verify_residual`, keyed by
#: the result dtype's item size (4 → f32, 8 → f64)
RESIDUAL_TOL = {4: 1e-4, 8: 1e-10}


def _np_dtype(dtype) -> numpy.dtype:
    """The numpy dtype of a numpy or torch dtype (or a name)."""
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return numpy.dtype(dtype)


def default_tolerance(dtype) -> float:
    """The stated blocked-vs-dense equality tolerance for ``dtype``:
    100·eps, relative to the result's scale."""
    return 100.0 * float(numpy.finfo(_np_dtype(dtype)).eps)


def residual_tolerance(dtype) -> float:
    """Default :func:`verify_residual` bound for ``dtype``."""
    return RESIDUAL_TOL.get(_np_dtype(dtype).itemsize, 1e-4)


def _device(device, *tensors) -> torch.device:
    """The computation's device: ``device``, else that of the first
    tensor among ``tensors``, else the default (the card) — always
    through ``device_for``, which applies the float32 policy."""
    if device is None:
        device = next((t.device for t in tensors
                       if isinstance(t, torch.Tensor)), None)
    return device_for(device)


def _tensor(x, device: torch.device) -> torch.Tensor:
    """``x`` (numpy or torch) as a tensor on ``device``, its dtype
    kept."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(numpy.asarray(x), device=device)


def _host64(x) -> numpy.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().double().numpy()
    return numpy.asarray(x, dtype=numpy.float64)


# ---------------------------------------------------------------------------
# fault surface: one chokepoint every blocked dispatch goes through
# ---------------------------------------------------------------------------

def _dispatch_block(block: torch.Tensor, **ctx) -> torch.Tensor:
    """The ``linalg.block_op`` injection chokepoint: counts the dispatch,
    then lets the fault plane raise, or corrupt the block's bytes. With
    no fault armed the block comes back untouched and nothing waits for
    the device. A corrupted block goes through a host copy framed
    big-endian and padded so ``Fault.corrupt``'s middle-byte flip lands
    on the sign/exponent byte of one element — real damage the residual
    check MUST catch (a little-endian middle byte would be a mantissa
    LSB: a 1-ulp change inside every stated tolerance)."""
    inc("veles_linalg_block_ops_total")
    fault = faults.fire("linalg.block_op", **ctx)
    if fault is None or block.numel() == 0:
        return block
    arr = block.detach().cpu().numpy()
    be = arr.dtype.newbyteorder(">")
    raw = arr.astype(be).tobytes()
    item = arr.dtype.itemsize
    pad = next(q for q in range(0, 2 * item + 1)
               if ((len(raw) + q) // 2 - q) % item == 0
               and (len(raw) + q) // 2 >= q)
    damaged = fault.corrupt(b"\x00" * pad + raw)[pad:]
    out = numpy.frombuffer(damaged, dtype=be).reshape(arr.shape)
    return torch.from_numpy(out.astype(arr.dtype)).to(block.device)


# ---------------------------------------------------------------------------
# mesh + block-cyclic layout helpers
# ---------------------------------------------------------------------------

def linalg_mesh(grid: Optional[Tuple[int, int]] = None) -> Mesh:
    """A 2D ``("rows", "cols")`` mesh of the process world for the
    blocked kernels: one rank a mesh point, row-major (rank ``r·pc + c``
    sits at row r, column c).

    ``grid=None`` picks the squarest (pr, pc) factorization of the world
    (1 process → 1×1, 2 → 1×2, 4 → 2×2). A mesh smaller than the world
    is allowed; the ranks past it are not members and idle. Every rank
    of the world calls it, in the same order (it creates process
    groups). It does not become the process's training mesh."""
    from ..parallel import distributed
    world = distributed.process_count()
    if grid is None:
        pr = int(math.sqrt(world))
        while pr > 1 and world % pr:
            pr -= 1
        grid = (pr, world // pr)
    pr, pc = int(grid[0]), int(grid[1])
    if pr < 1 or pc < 1:
        raise LinalgError("linalg mesh grid must be positive, got %r"
                          % (grid,))
    need = pr * pc
    if need > world:
        raise LinalgError("linalg mesh %dx%d needs %d processes, have %d"
                          % (pr, pc, need, world))
    return Mesh({"rows": pr, "cols": pc}, distributed.process_index(),
                world)


def _grid(mesh: Mesh) -> Tuple[int, int]:
    if tuple(mesh.axis_names) != ("rows", "cols"):
        raise LinalgError("linalg needs a 2D (rows, cols) mesh, got %r"
                          % (mesh.shape,))
    return mesh.axis_size("rows"), mesh.axis_size("cols")


def _pad_to(a: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Zero-pad a 2D tensor up to (rows, cols)."""
    r, c = a.shape
    if r == rows and c == cols:
        return a
    return torch.nn.functional.pad(a, (0, cols - c, 0, rows - r))


def cyclic_permutation(n_pad: int, slabs: int, p: int):
    """Block-cyclic layout as a row permutation.

    Splitting the (padded) axis into ``slabs`` equal slabs and dealing
    them round-robin over ``p`` shards is the classic block-cyclic
    distribution; with *contiguous* shards the same layout is obtained
    by permuting slab ``s`` into the contiguous range of shard
    ``s mod p`` first. Returns ``(perm, inv)`` index vectors
    (``a[perm][inv] == a``)."""
    if n_pad % slabs:
        raise LinalgError("cyclic layout: %d not divisible into %d slabs"
                          % (n_pad, slabs))
    w = n_pad // slabs
    order = [s for d in range(p) for s in range(d, slabs, p)]
    perm = numpy.concatenate(
        [numpy.arange(s * w, (s + 1) * w) for s in order])
    inv = numpy.empty_like(perm)
    inv[perm] = numpy.arange(n_pad)
    return perm, inv


# ---------------------------------------------------------------------------
# SUMMA matmul
# ---------------------------------------------------------------------------

def blocked_matmul(a, b, block: int = DEFAULT_BLOCK,
                   mesh: Optional[Mesh] = None, cyclic: bool = True,
                   device=None) -> torch.Tensor:
    """``a @ b`` by blocked panels — SUMMA over a 2D mesh of processes,
    or the same panel loop on one device when ``mesh is None``.

    ``cyclic=True`` (the default, mesh path only) lays the block grid
    out block-cyclically: the matrix axes are slab-permuted before the
    blocks are taken and the result is un-permuted, so rank (i, j)
    holds a round-robin set of blocks instead of one contiguous tile —
    the same product (it commutes with a shared row/column permutation),
    better balanced for the triangular updates built on it. Every rank
    of the mesh calls it with the same operands and gets the whole C.
    Records an analytic 2mnk-FLOP cost under ``linalg.matmul``."""
    dev = _device(device, a, b)
    a = _tensor(a, dev)
    b = _tensor(b, dev)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise LinalgError("blocked_matmul shapes %r @ %r"
                          % (tuple(a.shape), tuple(b.shape)))
    m, k = a.shape
    n = b.shape[1]
    with span("linalg.matmul", m=m, k=k, n=n,
              mesh=_grid(mesh) if mesh is not None else None):
        if mesh is None:
            out = _matmul_single(a, b, block)
        else:
            out = _matmul_summa(a, b, mesh, cyclic)
    cost_mod.model.record("linalg.matmul", matmul_cost(m, k, n, a.dtype))
    inc("veles_linalg_matmuls_total")
    return out


def _matmul_single(a: torch.Tensor, b: torch.Tensor,
                   block: int) -> torch.Tensor:
    """The one-device path: the k-panel loop, one block dispatch a
    panel."""
    m, k = a.shape
    acc = torch.zeros((m, b.shape[1]), dtype=a.dtype, device=a.device)
    for s in range(0, k, block):
        e = min(k, s + block)
        a_sub = _dispatch_block(a[:, s:e], op="matmul", panel=s // block)
        acc.add_(a_sub @ b[s:e, :])
    return acc


def _matmul_summa(a: torch.Tensor, b: torch.Tensor, mesh: Mesh,
                  cyclic: bool) -> torch.Tensor:
    from ..parallel import distributed
    pr, pc = _grid(mesh)
    if not mesh.member:
        raise LinalgError("rank %d is outside the linalg mesh %dx%d"
                          % (mesh.rank, pr, pc))
    G = pr * pc // math.gcd(pr, pc)          # lcm: k-panel count
    m, k = a.shape
    n = b.shape[1]
    mp = G * -(-m // G)
    kp = G * -(-k // G)
    np_ = G * -(-n // G)
    a_p = _pad_to(a, mp, kp)
    b_p = _pad_to(b, kp, np_)
    if cyclic:
        def index(perm):
            return torch.as_tensor(perm, device=a.device)
        pm, pm_inv = cyclic_permutation(mp, G, pr)
        pk, _ = cyclic_permutation(kp, G, pc)
        pn, pn_inv = cyclic_permutation(np_, G, pc)
        # the SAME k-permutation on A's columns and B's rows cancels in
        # the contraction; the row/column permutations are undone on C
        a_p = a_p[index(pm)][:, index(pk)]
        b_p = b_p[index(pk)][:, index(pn)]
    a_p = _dispatch_block(a_p, op="summa", grid=(pr, pc))
    r, c = mesh.coord("rows"), mesh.coord("cols")
    ml, nl = mp // pr, np_ // pc
    ka, kb = kp // pc, kp // pr
    a_loc = a_p[r * ml:(r + 1) * ml, c * ka:(c + 1) * ka]
    b_loc = b_p[r * kb:(r + 1) * kb, c * nl:(c + 1) * nl]
    w = kp // G
    acc = torch.zeros((ml, nl), dtype=a.dtype, device=a.device)
    for g in range(G):
        # A's k axis is split over the columns: column shard oc holds
        # G/pc consecutive panels, and panel g is its la-th
        oc, la = divmod(g, G // pc)
        orow, lb = divmod(g, G // pr)
        a_sub = a_loc[:, la * w:(la + 1) * w]
        b_sub = b_loc[lb * w:(lb + 1) * w, :]
        if pc > 1:
            a_sub = (a_sub.clone() if c == oc else torch.zeros_like(a_sub))
            distributed.all_reduce(a_sub, group=mesh.groups["cols"])
        if pr > 1:
            b_sub = (b_sub.clone() if r == orow
                     else torch.zeros_like(b_sub))
            distributed.all_reduce(b_sub, group=mesh.groups["rows"])
        acc.add_(a_sub @ b_sub)
    if mesh.size > 1:
        # (pr·pc, ml, nl) in rank order = row-major over (row, column)
        blocks = distributed.all_gather(acc, group=mesh.group)
        c_p = blocks.reshape(pr, pc, ml, nl).permute(0, 2, 1, 3).reshape(
            mp, np_)
    else:
        c_p = acc
    if cyclic:
        c_p = c_p[torch.as_tensor(pm_inv, device=a.device)][
            :, torch.as_tensor(pn_inv, device=a.device)]
    return c_p[:m, :n]


def _itemsize(dtype) -> int:
    return int(_np_dtype(dtype).itemsize)


def matmul_cost(m: int, k: int, n: int, dtype) -> "cost_mod.Cost":
    """Analytic matmul cost: 2mnk FLOPs, one read of each operand and one
    write of the result."""
    return cost_mod.Cost(
        flops=2.0 * m * n * k,
        bytes_accessed=float((m * k + k * n + m * n) * _itemsize(dtype)),
        source="analytic")


# ---------------------------------------------------------------------------
# right-looking blocked Cholesky + blocked triangular solve
# ---------------------------------------------------------------------------

def blocked_cholesky(a, block: int = DEFAULT_BLOCK,
                     mesh: Optional[Mesh] = None, mesh_min: int = 64,
                     device=None) -> torch.Tensor:
    """Lower-triangular L with ``L @ L.T == a`` by right-looking blocked
    panels.

    Per panel: ``cholesky_ex`` of the diagonal block, a triangular solve
    for the sub-diagonal panel, then the trailing update
    ``A22 -= L21 @ L21.T`` through :func:`blocked_matmul` — over
    ``mesh`` whenever the trailing size is at least ``mesh_min`` (the
    panel factorization is small and stays on each rank, the usual
    distributed-Cholesky split). ``cholesky_ex`` reports a block that is
    not positive definite in its ``info`` instead of raising, so the
    panels run without a host sync; the infos and the result are checked
    once at the end, and a failure raises :class:`LinalgError`. Records
    n³/3 FLOPs under ``linalg.cholesky``."""
    dev = _device(device, a)
    a = _tensor(a, dev)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise LinalgError("cholesky needs a square matrix, got %r"
                          % (tuple(a.shape),))
    n = a.shape[0]
    infos = []
    with span("linalg.cholesky", n=n, block=block,
              mesh=_grid(mesh) if mesh is not None else None):
        work = a.clone()
        for s in range(0, n, block):
            e = min(n, s + block)
            diag = _dispatch_block(work[s:e, s:e], op="potrf",
                                   panel=s // block)
            l_kk, info = torch.linalg.cholesky_ex(diag)
            infos.append(info)
            work[s:e, s:e] = l_kk
            if e < n:
                # L21 = A21 @ L11^{-T}: one triangular solve a panel
                panel = torch.linalg.solve_triangular(
                    l_kk, work[e:, s:e].T, upper=False).T
                work[e:, s:e] = panel
                upd = blocked_matmul(
                    panel, panel.T, block=block,
                    mesh=(mesh if mesh is not None and (n - e) >= mesh_min
                          else None))
                work[e:, e:] -= upd
        out = torch.tril(work)
        if bool(torch.stack(infos).any() | torch.isnan(out).any()):
            inc("veles_linalg_residual_failures_total")
            raise LinalgError(
                "cholesky: matrix is not positive definite (NaN panel)")
    cost_mod.model.record("linalg.cholesky", cholesky_cost(n, a.dtype))
    inc("veles_linalg_factorizations_total")
    return out


def cholesky_cost(n: int, dtype) -> "cost_mod.Cost":
    """Analytic potrf cost: n³/3 FLOPs, read+write of the matrix."""
    return cost_mod.Cost(flops=n ** 3 / 3.0,
                         bytes_accessed=float(2 * n * n * _itemsize(dtype)),
                         source="analytic")


def blocked_triangular_solve(l, b, lower: bool = True,
                             block: int = DEFAULT_BLOCK,
                             device=None) -> torch.Tensor:
    """Solve ``l @ x = b`` (or upper-triangular back-substitution when
    ``lower=False``) by blocked forward/backward substitution: per block
    row, subtract the already-solved block products, then one small
    dense triangular solve."""
    dev = _device(device, l, b)
    l = _tensor(l, dev)
    b = _tensor(b, dev)
    vector = b.ndim == 1
    if vector:
        b = b[:, None]
    n = l.shape[0]
    x = torch.zeros_like(b)
    ranges = list(range(0, n, block))
    if not lower:
        ranges = ranges[::-1]
    for s in ranges:
        e = min(n, s + block)
        if lower:
            rhs = b[s:e] - _dispatch_block(l[s:e, :s], op="trsm") @ x[:s]
        else:
            rhs = b[s:e] - _dispatch_block(l[s:e, e:], op="trsm") @ x[e:]
        x[s:e] = torch.linalg.solve_triangular(l[s:e, s:e], rhs,
                                               upper=not lower)
    return x[:, 0] if vector else x


def cholesky_solve(a, b, block: int = DEFAULT_BLOCK,
                   mesh: Optional[Mesh] = None, check: bool = True,
                   tol: Optional[float] = None,
                   device=None) -> torch.Tensor:
    """Solve SPD ``a @ x = b`` through the blocked Cholesky and two
    blocked triangular solves. With ``check=True`` (default) the answer
    must pass :func:`verify_residual` before it is returned — a corrupt
    block op can never produce a silently-wrong x."""
    dev = _device(device, a, b)
    l = blocked_cholesky(a, block=block, mesh=mesh, device=dev)
    y = blocked_triangular_solve(l, b, lower=True, block=block, device=dev)
    x = blocked_triangular_solve(l.T, y, lower=False, block=block,
                                 device=dev)
    if check:
        verify_residual(a, x, b, tol=tol, what="linalg.cholesky_solve")
    inc("veles_linalg_solves_total")
    return x


# ---------------------------------------------------------------------------
# the trusted residual check
# ---------------------------------------------------------------------------

def verify_residual(operator: Union[Callable, object], x, b,
                    tol: Optional[float] = None,
                    what: str = "linalg.solve") -> float:
    """Relative residual ``|b - A x| / |b|`` of a proposed solution,
    raising :class:`LinalgError` when it exceeds ``tol``.

    THE trusted path of the family: a matrix operator is applied with a
    plain dense product on the host in float64 — never through the
    faultable ``linalg.block_op`` dispatch — so a corruption injected
    into the solve cannot also corrupt its own acceptance check.
    Callable operators are applied as given (they are the caller's
    trusted definition of the problem). Returns the residual; every call
    is counted (``veles_linalg_residual_checks_total`` /
    ``_failures_total``)."""
    xv = _host64(x)
    bv = _host64(b)
    x_dtype = x.dtype if isinstance(x, torch.Tensor) \
        else numpy.asarray(x).dtype
    if callable(operator):
        ax = _host64(operator(x))
        dtype = x_dtype
    else:
        av = _host64(operator)
        ax = av @ xv
        dtype = (operator.dtype if isinstance(operator, torch.Tensor)
                 else numpy.asarray(operator).dtype)
    bound = residual_tolerance(dtype) if tol is None else float(tol)
    denom = float(numpy.linalg.norm(bv))
    resid = float(numpy.linalg.norm(bv - ax)) / (denom or 1.0)
    inc("veles_linalg_residual_checks_total")
    with span("linalg.residual_check", what=what, resid=resid,
              tol=bound):
        if not numpy.isfinite(resid) or resid > bound:
            inc("veles_linalg_residual_failures_total")
            raise LinalgError(
                "%s: residual check FAILED: |b-Ax|/|b| = %.3e > %.3e "
                "(corrupt block or ill-posed system; refusing to "
                "return x)" % (what, resid, bound))
    return resid


# ---------------------------------------------------------------------------
# the falsifiable SUMMA step-time model
# ---------------------------------------------------------------------------

def predict_summa_time(m: int, k: int, n: int, grid: Tuple[int, int],
                       t1_step_s: float, dtype=numpy.float32,
                       ici_bw: Optional[float] = None,
                       device_kind: Optional[str] = None) -> dict:
    """Predicted SUMMA step time on a (pr, pc) mesh, every input stated:

    ``t_pred = t1_step/N + psum_bytes/link_bw`` where a rank's all-reduce
    traffic sums, over the G = lcm(pr, pc) panel steps, one ring
    all-reduce of the A panel along the row (2·(pc-1)/pc of its bytes)
    and one of the B panel along the column. ``link_bw`` defaults to the
    card's ``telemetry.cost.LINK_BW_BYTES`` row (NVLink 4), named in
    ``ici_bw_source`` — ranks that share one card under gloo move their
    panels through host memory instead, and the record says which link
    the prediction assumed."""
    pr, pc = int(grid[0]), int(grid[1])
    n_dev = pr * pc
    G = pr * pc // math.gcd(pr, pc)
    itemsize = _itemsize(dtype)
    mp = G * -(-m // G)
    kp = G * -(-k // G)
    np_ = G * -(-n // G)
    w = kp // G
    a_panel_bytes = (mp // pr) * w * itemsize
    b_panel_bytes = w * (np_ // pc) * itemsize
    if ici_bw is None:
        ici_bw_source, ici_bw = cost_mod.ici_bandwidth_entry(device_kind)
    else:
        ici_bw_source = "caller"
    psum_bytes = G * (2.0 * (pc - 1) / pc * a_panel_bytes
                      + 2.0 * (pr - 1) / pr * b_panel_bytes)
    compute_s = t1_step_s / n_dev
    comm_s = psum_bytes / ici_bw
    return {
        "predicted_step_s": compute_s + comm_s,
        "compute_s": compute_s,
        "comm_s": comm_s,
        "inputs": {
            "t1_step_s": t1_step_s,
            "grid": [pr, pc],
            "panels": G,
            "block_bytes_a_panel": a_panel_bytes,
            "block_bytes_b_panel": b_panel_bytes,
            "psum_bytes_per_device": psum_bytes,
            "ici_bw_assumed_bytes_per_s": ici_bw,
            "ici_bw_source": ici_bw_source,
        },
    }

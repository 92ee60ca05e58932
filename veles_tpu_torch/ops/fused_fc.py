"""Whole-epoch fused FC SGD: a hand-written Hopper kernel and its plain
torch version (counterpart of ``veles_tpu/ops/fused_fc.py``).

One call runs a whole SGD epoch of an L-layer chain of
``A·tanh(B·(h@W+b))`` layers ending in a softmax cross-entropy head,
with the Znicz update ``delta = lr·(g + wd·p) + mu·delta_prev;
p -= delta`` (bias: ``lr·lr_bias_ratio`` and ``wd_bias``), over the
``(K, mb)`` plan of minibatch indices into the device dataset.

The kernel (``csrc/fused_fc_sgd.cu``) replaces the TPU kernel
``veles_tpu/ops/fused_fc.py::_kernel``: one thread-block cluster keeps
the weights and both delta recurrences in its shared memory for all K
steps and gathers each minibatch's rows by plan index. It has two
decompositions (:data:`LAYOUTS`): "rows" splits layer 0 over its input
rows on a 16-CTA cluster and replicates the later layers (3xTF32
products on the tensor cores); "columns" splits every layer over its
output columns, for the chains the rows layout cannot hold.
:func:`choose_geometry` picks the first (layout, cluster) whose
:func:`smem_bytes` fits :data:`SMEM_BUDGET`.

:func:`fused_fc_sgd_epoch` is the wrapper: on CUDA tensors it launches
the kernel or raises; on CPU tensors it runs
:func:`fused_fc_sgd_epoch_reference`, the plain version that the CPU
tests and ``chip_smoke.py`` hold the kernel against. Both return
``(weights, biases, vel_w, vel_b, loss_sum, err_count)``; the inputs are
not modified. ``loss_sum`` is summed per step in float32 and over the
epoch in float64, then returned as float32, like ``err_count``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..telemetry import cost as _cost
from ..telemetry.counters import inc

_SOURCE = "fused_fc_sgd"

#: layers one launch takes (``MAXL`` in the kernel)
MAX_LAYERS = 8
#: threads per CTA (``NT``); input columns per streamed tile of the
#: columns layout (``TI``)
THREADS = 256
TILE = 32
#: rows layout: layer-0 input rows per chunk (``KC``)
CHUNK = 8
#: dynamic shared memory one CTA may use on an H100 (227 KB)
SMEM_BUDGET = 232448
#: the kernel's decompositions, in the order preferred (``layout`` 0, 1)
LAYOUTS = ("rows", "columns")
#: each layout's cluster sizes, in the order preferred: 16 (all of a
#: GPC's SMs the launch may take; the non-portable cluster attribute)
#: before 8. The rows layout runs at 16 only (``NCTA``)
CLUSTERS = {"rows": (16,), "columns": (16, 8)}


def analytic_cost(layer_shapes: Sequence, mb: int, steps: int
                  ) -> Tuple[float, float]:
    """(FLOPs, bytes) of one fused epoch, the reference's model: per SGD
    step the forward 2·mb·Σ(in·out), the backward twice that, plus ~4
    per parameter for the update; bytes are the minibatch stream
    (f32 rows + int32 labels) plus the weights and delta recurrences
    read once and written once. It charges a ``d_h`` product to layer
    0 as well, which neither kernel computes: :func:`epoch_work` is the
    work the function needs, and the bound is taken from it."""
    mm = sum(int(i) * int(o) for i, o in layer_shapes)
    params = mm + sum(int(o) for _, o in layer_shapes)
    flops = steps * (3 * 2 * mb * mm + 4 * params)
    d0 = int(layer_shapes[0][0])
    stream = steps * mb * (d0 + 1) * 4
    return float(flops), float(stream + 2 * 2 * params * 4)


def epoch_work(layer_shapes: Sequence, mb: int, steps: int
               ) -> Tuple[float, float]:
    """(FLOPs, bytes) the epoch needs: per step the forward and ``dW``
    products, 2·mb·Σ(in·out) each, the ``d_h`` products of layers 1..L-1
    only, 2·mb·Σ_{l>0}(in·out), and 4 per parameter for the update;
    bytes are each input read once (the plan's rows and labels, the
    plan, the weights and delta recurrences) and each output written
    once."""
    mm = [int(i) * int(o) for i, o in layer_shapes]
    params = sum(mm) + sum(int(o) for _, o in layer_shapes)
    flops = steps * (2 * 2 * mb * sum(mm) + 2 * mb * sum(mm[1:])
                     + 4 * params)
    d0 = int(layer_shapes[0][0])
    reads = steps * mb * ((d0 + 1) * 4 + 4)
    return float(flops), float(reads + 2 * 2 * params * 4)


def epoch_bounds(layer_shapes: Sequence, mb: int, steps: int,
                 cluster: int) -> Dict[str, object]:
    """The epoch's least time on the card, in ms, from :func:`epoch_work`:
    ``bound_ms`` at the card-wide float32 FMA rate, ``bound_tc_ms`` with
    the products in 3xTF32 on the tensor cores (a third of the TF32
    rate), each at least the bytes over the memory rate; and the 3xTF32
    and float32 ceilings of the ``cluster`` SMs one launch runs on."""
    flops, nbytes = epoch_work(layer_shapes, mb, steps)
    t_f32 = flops / _cost.peak_flops("float32", "H100") * 1e3
    t_tc = 3 * flops / _cost.peak_flops("tf32", "H100") * 1e3
    t_bytes = nbytes / _cost.hbm_bandwidth("H100") * 1e3
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": max(t_f32, t_bytes), "bound_tc_ms": max(t_tc, t_bytes),
            "bound_by": "operations" if t_tc >= t_bytes else "bytes",
            "cluster_ceiling_ms": t_tc * N_SMS / cluster,
            "cluster_ceiling_f32_ms": t_f32 * N_SMS / cluster}


#: streaming multiprocessors of an H100 SXM
N_SMS = 132


def _dims(layer_shapes: Sequence) -> List[int]:
    return [int(layer_shapes[0][0])] + [int(o) for _, o in layer_shapes]


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def _ld_b(w: int) -> int:
    """``ld_b``: the row stride of a width-``w`` B operand."""
    ld = -(-w // 8) * 8
    return ld + 8 if ld % 32 in (0, 16) else ld


def _ld_a(w: int) -> int:
    """``ld_a``: the row stride of the x tile, an odd multiple of 4."""
    ld = _pad4(w)
    return ld + 4 if ld % 8 == 0 else ld


def cta_rows(d0: int) -> List[Tuple[int, int]]:
    """(first row, row count) of layer 0's ``d0`` inputs that each CTA of
    the rows layout owns (``cta_row``): whole chunks of :data:`CHUNK`
    rows, CTA r's from chunk ``r * n_chunks // 16``, in rank order."""
    n = CLUSTERS["rows"][0]
    n_ch = -(-d0 // CHUNK)
    bounds = [min(CHUNK * (r * n_ch // n), d0) for r in range(n + 1)]
    return [(a, b - a) for a, b in zip(bounds, bounds[1:])]


def smem_bytes(layer_shapes: Sequence, mb: int, cluster: int,
               layout: str = "rows") -> int:
    """Shared-memory bytes one CTA of a ``cluster``-CTA launch in
    ``layout`` needs: the kernel's ``make_layout``, float for float (the
    rows layout's at its one cluster size)."""
    dims = _dims(layer_shapes)
    n = len(dims) - 1
    if layout == "columns":
        own = [-(-dims[i + 1] // cluster) for i in range(n)]
        floats = sum(2 * dims[i] * own[i] + 2 * own[i] + 2 * mb * own[i]
                     for i in range(n))
        floats += mb * (TILE + 1) + TILE * max([1] + own[:-1]) + 2 * THREADS
        return 4 * floats
    if layout != "rows" or cluster not in CLUSTERS["rows"]:
        raise ValueError("the layouts are rows at %s CTAs and columns, got "
                         "%r at %s" % (CLUSTERS["rows"], layout, cluster))
    rows = max(n for _, n in cta_rows(dims[0]))
    ld = [0] + [_ld_b(w) for w in dims[1:]]
    floats = 2 * rows * ld[1]
    floats += sum(2 * _pad4(w) for w in dims[1:])
    mbp = -(-mb // 16) * 16
    floats += sum(3 * -(-dims[i] // 8) * 8 * ld[i + 1] for i in range(1, n))
    floats += sum(mbp * ld[i] for i in range(1, n + 1))
    floats += 2 * mbp * _ld_a(rows) + 2 * _pad4(mb)
    floats += _pad4(-(-mb * ld[1] // cluster)) + 2 * (THREADS // 32)
    return 4 * floats


def geometries(layer_shapes: Sequence, mb: int) -> List[Tuple[str, int]]:
    """Every (layout, cluster) the wrapper may launch the chain at, the
    default first. The layout is the chain's alone: "rows" when it fits
    (at 16 CTAs), else "columns" at each cluster size, 16 before 8, that
    fits one CTA's shared memory. Every entry gives the same bits (the
    kernel's sums run in an order fixed by the shapes)."""
    if not 1 <= len(layer_shapes) <= MAX_LAYERS:
        return []
    for lay in LAYOUTS:
        fits = [(lay, c) for c in CLUSTERS[lay]
                if smem_bytes(layer_shapes, mb, c, lay) <= SMEM_BUDGET]
        if fits:
            return fits
    return []


def choose_geometry(layer_shapes: Sequence, mb: int,
                    cluster: Optional[int] = None
                    ) -> Optional[Tuple[str, int]]:
    """The launch's (layout, cluster): the first of :func:`geometries`
    (at ``cluster`` when one is given), or None when there is none (the
    chain is then ineligible, or does not fit at that cluster)."""
    for lay, c in geometries(layer_shapes, mb):
        if cluster is None or c == int(cluster):
            return lay, c
    return None


def fused_fc_sgd_epoch_reference(weights, biases, vel_w, vel_b, dataset,
                                 labels, plan, lr, act_a: float = 1.0,
                                 act_b: float = 1.0,
                                 lr_bias_ratio: float = 1.0,
                                 wd: float = 0.0, wd_bias: float = 0.0,
                                 momentum: float = 0.0):
    """Plain torch version: a loop over the plan's K steps, each the
    forward, the mean-CE backward (``d_h`` from the pre-update weights)
    and the update of every layer."""
    n = len(weights)
    ws = [w.float().clone() for w in weights]
    bs = [b.float().clone() for b in biases]
    vws = [v.float().clone() for v in vel_w]
    vbs = [v.float().clone() for v in vel_b]
    mb = plan.shape[1]
    lr = float(torch.tensor(lr, dtype=torch.float32))
    lr_b = float(torch.tensor(lr, dtype=torch.float32)
                 * torch.tensor(lr_bias_ratio, dtype=torch.float32))
    loss = torch.zeros((), dtype=torch.float64, device=dataset.device)
    err = torch.zeros((), dtype=torch.int64, device=dataset.device)
    ab, ba = act_a * act_b, act_b / act_a
    for k in range(plan.shape[0]):
        idx = plan[k].long()
        x = dataset[idx].float()
        lab = labels[idx].long()
        acts = [x]
        h = x
        for li in range(n - 1):
            h = act_a * torch.tanh(act_b * (h @ ws[li] + bs[li]))
            acts.append(h)
        logits = h @ ws[n - 1] + bs[n - 1]
        logp = torch.log_softmax(logits, dim=1)
        loss = loss + (-logp.gather(1, lab[:, None]).sum()).double()
        err = err + (torch.argmax(logits, 1) != lab).sum()
        y = torch.nn.functional.one_hot(lab, logits.shape[1]).float()
        d_out = (torch.exp(logp) - y) / mb
        for li in range(n - 1, -1, -1):
            dw = acts[li].T @ d_out
            db = d_out.sum(0)
            if li > 0:
                hh = acts[li]
                d_out = (d_out @ ws[li].T) * (ab - ba * hh * hh)
            dlt_w = lr * (dw + wd * ws[li]) + momentum * vws[li]
            dlt_b = lr_b * (db + wd_bias * bs[li]) + momentum * vbs[li]
            ws[li] = ws[li] - dlt_w
            bs[li] = bs[li] - dlt_b
            vws[li] = dlt_w
            vbs[li] = dlt_b
    return ws, bs, vws, vbs, loss.float(), err.float()


class _Args(ctypes.Structure):
    """``FusedFcArgs`` of the kernel, field for field."""
    _fields_ = ([("dataset", ctypes.c_void_p), ("labels", ctypes.c_void_p),
                 ("plan", ctypes.c_void_p)]
                + [(name, ctypes.c_void_p * MAX_LAYERS)
                   for name in ("w_in", "b_in", "vw_in", "vb_in",
                                "w_out", "b_out", "vw_out", "vb_out")]
                + [("acc", ctypes.c_void_p),
                   ("dims", ctypes.c_int * (MAX_LAYERS + 1)),
                   ("n_layers", ctypes.c_int), ("steps", ctypes.c_int),
                   ("mb", ctypes.c_int)]
                + [(name, ctypes.c_float)
                   for name in ("lr", "act_a", "act_b", "lr_bias_ratio",
                                "wd", "wd_bias", "momentum")])


@functools.cache
def _library():
    """The kernel's C entry points, built and typed at first use."""
    from . import _build
    lib = _build.load(_SOURCE)
    lib.veles_fused_fc_sgd_epoch_f32.restype = ctypes.c_int
    lib.veles_fused_fc_sgd_epoch_f32.argtypes = [
        ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


def _launch(weights, biases, vel_w, vel_b, dataset, labels, plan, lr,
            act_a, act_b, lr_bias_ratio, wd, wd_bias, momentum, cluster):
    tensors = (list(weights) + list(biases) + list(vel_w) + list(vel_b)
               + [dataset])
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("the fused-FC kernel takes float32 weights, "
                        "velocities and dataset")
    if labels.dtype != torch.int32 or plan.dtype != torch.int32:
        raise TypeError("labels and plan must be int32")
    dev = dataset.device
    if any(t.device != dev for t in tensors + [labels, plan]):
        raise ValueError("every fused-FC input must lie on one device")
    n = len(weights)
    shapes = [tuple(w.shape) for w in weights]
    mb = int(plan.shape[1])
    geometry = choose_geometry(shapes, mb, cluster)
    if geometry is None:
        raise ValueError("chain %s at mb %d runs at %s, not at cluster %s "
                         "(%d bytes a CTA in the columns layout at 16)"
                         % (shapes, mb, geometries(shapes, mb) or "none",
                            cluster, smem_bytes(shapes, mb, 16, "columns")))
    layout, cluster = geometry
    ins = [t.contiguous() for t in tensors]
    dataset = ins[-1]
    labels, plan = labels.contiguous(), plan.contiguous()
    outs = [torch.empty_like(t) for t in ins[:-1]]
    acc = torch.zeros(2, dtype=torch.float64, device=dev)
    args = _Args()
    args.dataset, args.labels, args.plan = (dataset.data_ptr(),
                                            labels.data_ptr(),
                                            plan.data_ptr())
    groups = ("w", "b", "vw", "vb")
    for g, name in enumerate(groups):
        for i in range(n):
            getattr(args, name + "_in")[i] = ins[g * n + i].data_ptr()
            getattr(args, name + "_out")[i] = outs[g * n + i].data_ptr()
    args.acc = acc.data_ptr()
    for i, d in enumerate(_dims(shapes)):
        args.dims[i] = d
    args.n_layers, args.steps, args.mb = n, int(plan.shape[0]), mb
    args.lr, args.act_a, args.act_b = float(lr), act_a, act_b
    args.lr_bias_ratio, args.wd, args.wd_bias = lr_bias_ratio, wd, wd_bias
    args.momentum = momentum
    fn = _library().veles_fused_fc_sgd_epoch_f32
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ctypes.byref(args), cluster, LAYOUTS.index(layout), stream)
    if err != 0:
        raise RuntimeError("fused_fc_sgd_epoch kernel launch failed (%s "
                           "layout, cluster %d): CUDA error %d"
                           % (layout, cluster, err))
    inc("veles_fused_fc_launches_total")
    # the kernel is opaque to the FLOP counter: publish the epoch's
    # analytic cost to the active collectors (telemetry/cost.py)
    _cost.note_kernel_cost(_cost.Cost(*analytic_cost(shapes, mb,
                                                     args.steps)))
    f32 = acc.float()
    return (outs[:n], outs[n:2 * n], outs[2 * n:3 * n], outs[3 * n:],
            f32[0], f32[1])


def fused_fc_sgd_epoch(weights: Sequence, biases: Sequence,
                       vel_w: Sequence, vel_b: Sequence, dataset, labels,
                       plan, lr, n_classes: Optional[int] = None,
                       act_a: float = 1.0, act_b: float = 1.0,
                       lr_bias_ratio: float = 1.0, wd: float = 0.0,
                       wd_bias: float = 0.0, momentum: float = 0.0,
                       cluster: Optional[int] = None):
    """One SGD epoch of the chain (the reference's signature):

    - weights[i] (d_i, d_{i+1}), biases[i] (d_{i+1},), float32;
    - vel_w/vel_b: the delta recurrences (zeros for a fresh run);
    - dataset (N, d_0) float32, labels (N,) int32, plan (K, mb) int32;
    - lr: the weights' learning rate, already scaled by the schedule;
    - cluster: the kernel's cluster size, one of :func:`geometries`
      (default: the first, :func:`choose_geometry`); ignored on the CPU.

    CUDA tensors go through the kernel — or raise; CPU tensors through
    the plain version. Each kernel launch adds one to
    ``veles_fused_fc_launches_total``."""
    n = len(weights)
    if not (len(biases) == len(vel_w) == len(vel_b) == n
            and 1 <= n <= MAX_LAYERS):
        raise ValueError("fused_fc_sgd_epoch takes 1..%d layers with a "
                         "bias and two velocities each" % MAX_LAYERS)
    if n_classes is not None and int(n_classes) != weights[-1].shape[1]:
        raise ValueError("n_classes %s differs from the head width %d "
                         "(padded heads are not ported)"
                         % (n_classes, weights[-1].shape[1]))
    kw = dict(act_a=float(act_a), act_b=float(act_b),
              lr_bias_ratio=float(lr_bias_ratio), wd=float(wd),
              wd_bias=float(wd_bias), momentum=float(momentum))
    if dataset.device.type == "cpu":
        return fused_fc_sgd_epoch_reference(
            weights, biases, vel_w, vel_b, dataset, labels, plan, lr, **kw)
    if dataset.device.type != "cuda":
        raise ValueError("fused_fc_sgd_epoch runs on cuda or cpu tensors, "
                         "got %s" % dataset.device)
    return _launch(weights, biases, vel_w, vel_b, dataset, labels, plan,
                   lr, cluster=cluster, **kw)

"""The port's whole-epoch fused-FC SGD (veles_tpu_torch/ops/fused_fc.py)
against the reference's on the same numpy-seeded inputs: its plain
version vs the Pallas kernel (interpret mode on the CPU, as
tests/test_fused_fc.py runs it) and vs ``fused_fc_oracle``, within
rtol 2e-5 / atol 2e-6 (float32; only the summation order differs),
including a second epoch that continues from the returned state; the
analytic cost model; the shared-memory budget; and the wrapper's
routing (a CPU tensor never builds the kernel)."""
import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu.ops import fused_fc as ref_ff
from veles_tpu_torch.ops import _build
from veles_tpu_torch.ops import fused_fc as ff
from veles_tpu_torch.telemetry import counters

RTOL, ATOL = 2e-5, 2e-6

#: tests/test_fused_fc.py::test_kernel_matches_oracle's cases
CASES = [
    ((20, 12, 3), dict(act_a=1.0, act_b=1.0)),
    ((20, 12, 3), dict(act_a=1.7159, act_b=0.6666)),
    ((20, 12, 3), dict(momentum=0.9, wd=1e-3, wd_bias=1e-4,
                       lr_bias_ratio=0.5)),
    ((20, 16, 8, 3), dict(act_a=1.7159, act_b=0.6666, momentum=0.5)),
]


def _inputs(dims, seed=0, n=60, mb=10):
    rng = numpy.random.RandomState(seed)
    ds = rng.rand(n, dims[0]).astype(numpy.float32)
    lb = rng.randint(0, dims[-1], n).astype(numpy.int32)
    plan = rng.permutation(n).reshape(-1, mb).astype(numpy.int32)
    ws = [(rng.randn(a, b) * 0.1).astype(numpy.float32)
          for a, b in zip(dims, dims[1:])]
    bs = [(rng.randn(b) * 0.01).astype(numpy.float32) for b in dims[1:]]
    zw = [numpy.zeros_like(w) for w in ws]
    zb = [numpy.zeros_like(b) for b in bs]
    return ws, bs, zw, zb, ds, lb, plan


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


def _port(state, ds, lb, plan, kw):
    ws, bs, vws, vbs = state
    return ff.fused_fc_sgd_epoch(_torch(ws), _torch(bs), _torch(vws),
                                 _torch(vbs), torch.from_numpy(ds),
                                 torch.from_numpy(lb),
                                 torch.from_numpy(plan), 0.05, **kw)


def _assert_close(port, ref, what):
    for name, pp, rr in zip(("w", "b", "vw", "vb"), port[:4], ref[:4]):
        for li, (p1, r1) in enumerate(zip(pp, rr)):
            numpy.testing.assert_allclose(
                p1.numpy(), numpy.asarray(r1), rtol=RTOL, atol=ATOL,
                err_msg="%s %s[%d]" % (what, name, li))
    for name, p1, r1 in zip(("loss", "err"), port[4:], ref[4:]):
        numpy.testing.assert_allclose(float(p1), float(r1), rtol=RTOL,
                                      atol=ATOL, err_msg="%s %s"
                                      % (what, name))


@pytest.mark.parametrize("dims,kw", CASES,
                         ids=["unit_ab", "lecun", "momentum_decay",
                              "three_layer"])
def test_plain_matches_pallas_kernel_and_oracle(dims, kw):
    ws, bs, zw, zb, ds, lb, plan = _inputs(dims)
    port = _port((ws, bs, zw, zb), ds, lb, plan, kw)
    jargs = (_jax(ws), _jax(bs), _jax(zw), _jax(zb), jnp.asarray(ds),
             jnp.asarray(lb), jnp.asarray(plan), 0.05)
    kernel = ref_ff.fused_fc_sgd_epoch(*jargs, **kw)
    oracle = ref_ff.fused_fc_oracle(*jargs, **kw)
    _assert_close(port, kernel, "vs Pallas kernel")
    _assert_close(port, oracle, "vs oracle")
    # a second epoch continues from the returned state
    port2 = _port([[t.numpy() for t in group] for group in port[:4]],
                  ds, lb, plan, kw)
    kernel2 = ref_ff.fused_fc_sgd_epoch(*kernel[:4], *jargs[4:], **kw)
    _assert_close(port2, kernel2, "second epoch")


def test_inputs_are_not_modified():
    ws, bs, zw, zb, ds, lb, plan = _inputs((20, 12, 3), seed=3)
    tw = _torch(ws)
    before = [t.clone() for t in tw]
    ff.fused_fc_sgd_epoch(tw, _torch(bs), _torch(zw), _torch(zb),
                          torch.from_numpy(ds), torch.from_numpy(lb),
                          torch.from_numpy(plan), 0.05, momentum=0.9)
    assert all(torch.equal(a, b) for a, b in zip(tw, before))


@pytest.mark.parametrize("shapes,mb,steps", [
    ([(784, 100), (100, 10)], 100, 600),
    ([(20, 12), (12, 3)], 10, 6),
    ([(784, 256), (256, 64), (64, 10)], 37, 12),
])
def test_analytic_cost_matches_reference(shapes, mb, steps):
    cost = ref_ff.analytic_cost(shapes, mb, steps)
    assert ff.analytic_cost(shapes, mb, steps) == (cost.flops,
                                                   cost.bytes_accessed)


def test_mnist_epoch_cost():
    """One MNIST epoch: 28.77 GFLOP, 189.7 MB → 0.429 ms at 67 TFLOP/s."""
    flops, nbytes = ff.analytic_cost([(784, 100), (100, 10)], 100, 600)
    assert round(flops / 1e9, 2) == 28.77
    assert round(nbytes / 1e6, 1) == 189.7
    assert round(flops / 67e12 * 1e3, 3) == 0.429


def test_mnist_epoch_work():
    """The work one MNIST epoch needs: no d_h product for layer 0, so
    19.37 GFLOP (not the reference model's 28.77) → 0.289 ms at 67
    TFLOP/s; 189.9 MB of reads and writes → 0.0567 ms at 3.35 TB/s."""
    flops, nbytes = ff.epoch_work([(784, 100), (100, 10)], 100, 600)
    assert flops == 600 * (4 * 100 * 79400 + 2 * 100 * 1000 + 4 * 79510)
    assert round(flops / 1e9, 2) == 19.37
    assert round(nbytes / 1e6, 1) == 189.9
    assert round(flops / 67e12 * 1e3, 3) == 0.289
    assert round(nbytes / 3.35e12 * 1e3, 4) == 0.0567


@pytest.mark.parametrize("shapes,mb,steps", [
    ([(784, 100), (100, 10)], 100, 600),
    ([(20, 12), (12, 3)], 10, 6),
    ([(784, 256), (256, 64), (64, 10)], 37, 12),
])
def test_epoch_work_drops_only_layer_zero_d_h(shapes, mb, steps):
    """The reference model less the layer-0 ``d_h`` product it charges;
    the bytes add the plan's int32 indices."""
    flops, nbytes = ff.epoch_work(shapes, mb, steps)
    model_flops, model_bytes = ff.analytic_cost(shapes, mb, steps)
    assert model_flops - flops == steps * 2 * mb * shapes[0][0] * shapes[0][1]
    assert nbytes - model_bytes == steps * mb * 4


@pytest.mark.parametrize("shapes,mb,cluster,expect", [
    ([(784, 100), (100, 10)], 100, 16, ("rows", 16)),
    ([(20, 12), (12, 3)], 10, 16, ("rows", 16)),
    ([(784, 256), (256, 64), (64, 10)], 100, 16, ("columns", 16)),
    ([(16, 2048), (2048, 2048), (2048, 3)], 20, None, None),
])
def test_shared_memory_budget(shapes, mb, cluster, expect):
    """MNIST fits one CTA's 227 KB in the rows layout (16 CTAs); the
    3-layer chain of the chip check only in the columns layout at 16;
    the reference's oversized chain in neither. The rows layout has no
    other cluster size, and a larger cluster never needs more in the
    columns layout."""
    assert ff.choose_geometry(shapes, mb) == expect
    if cluster is not None:
        assert ff.smem_bytes(shapes, mb, cluster, expect[0]) \
            <= ff.SMEM_BUDGET
    with pytest.raises(ValueError):
        ff.smem_bytes(shapes, mb, 8, "rows")
    assert ff.smem_bytes(shapes, mb, 16, "columns") \
        <= ff.smem_bytes(shapes, mb, 8, "columns")


def test_mnist_footprint():
    """The rows layout at 16 CTAs: W_0 and V_0 for 56 rows of 104
    floats, the replicated 100 x 10 layer in two buffers and its V (104
    rows of 24), the activations and two x tiles at 112 rows, two label
    rows, a 650-float stripe; the columns layout at 8 is unchanged."""
    shapes = [(784, 100), (100, 10)]
    assert ff.smem_bytes(shapes, 100, 16, "rows") == 192016
    assert ff.smem_bytes(shapes, 100, 16, "rows") == 4 * (
        2 * 56 * 104 + 2 * (100 + 12) + 3 * 104 * 24 + 112 * (104 + 24)
        + 2 * 112 * 60 + 2 * 100 + 652 + 16)
    assert ff.smem_bytes(shapes, 100, 8, "columns") == 112168


@pytest.mark.parametrize("d0", [784, 20, 33, 8, 1, 1000, 100, 129, 7, 16,
                                17, 2048])
def test_row_groups_partition_layer_zero(d0):
    """The 16 CTAs' rows are whole 8-row chunks, in rank order, covering
    every input row once; the chunk counts differ by at most one, and
    only the last CTA's may end in a part chunk."""
    rows = ff.cta_rows(d0)
    assert len(rows) == ff.CLUSTERS["rows"][0]
    assert rows[0][0] == 0 and sum(n for _, n in rows) == d0
    assert all(i0 + n == j0 for (i0, n), (j0, _) in zip(rows, rows[1:]))
    assert all(i0 % ff.CHUNK == 0 and n % ff.CHUNK == 0
               for i0, n in rows[:-1])
    chunks = [-(-n // ff.CHUNK) for _, n in rows]
    assert max(chunks) - min(chunks) <= 1


def test_mnist_row_groups():
    """784 inputs: 98 chunks over 16 CTAs, 6 or 7 each; the busiest
    CTA holds 56 rows, what the footprint reserves."""
    rows = ff.cta_rows(784)
    assert sorted({n for _, n in rows}) == [48, 56]
    assert [n for _, n in rows].count(56) == 98 - 16 * 6


@pytest.mark.parametrize("shapes,mb,expect", [
    ([(784, 100), (100, 10)], 100, [("rows", 16)]),
    ([(784, 100), (100, 10)], 37, [("rows", 16)]),
    ([(20, 12), (12, 3)], 10, [("rows", 16)]),
    ([(784, 256), (256, 64), (64, 10)], 100, [("columns", 16)]),
    ([(784, 200), (200, 10)], 100, [("columns", 16), ("columns", 8)]),
    ([(16, 2048), (2048, 2048), (2048, 3)], 20, []),
])
def test_geometries_keep_one_layout(shapes, mb, expect):
    """The wrapper may launch a chain in its one layout: rows at 16 CTAs
    when it fits, else columns at every cluster size that fits (so every
    geometry gives the same bits); a cluster with no geometry is
    refused, not swapped for the other layout."""
    assert ff.geometries(shapes, mb) == expect
    assert ff.choose_geometry(shapes, mb, 8) == (
        expect[-1] if expect and expect[-1][1] == 8 else None)


def test_mnist_epoch_bounds():
    """3xTF32 runs at a third of the 495 TFLOP/s TF32 rate: 0.117 ms for
    the epoch's 19.37 GFLOP; 16 of the 132 SMs make 0.968 ms."""
    b = ff.epoch_bounds([(784, 100), (100, 10)], 100, 600, 16)
    assert round(b["bound_ms"], 3) == 0.289
    assert round(b["bound_tc_ms"], 4) == 0.1174
    assert round(b["cluster_ceiling_ms"], 3) == 0.968
    assert round(b["cluster_ceiling_f32_ms"], 3) == 2.385
    assert b["bound_by"] == "operations"


def test_cpu_tensors_never_build_the_kernel(monkeypatch):
    def no_build(name):
        raise AssertionError("built %s for a CPU tensor" % name)

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    ws, bs, zw, zb, ds, lb, plan = _inputs((20, 12, 3), seed=4)
    before = counters.get("veles_fused_fc_launches_total")
    out = _port((ws, bs, zw, zb), ds, lb, plan, {})
    plain = ff.fused_fc_sgd_epoch_reference(
        _torch(ws), _torch(bs), _torch(zw), _torch(zb),
        torch.from_numpy(ds), torch.from_numpy(lb), torch.from_numpy(plan),
        0.05)
    for xs, ys in zip(out[:4], plain[:4]):
        assert all(torch.equal(a, b) for a, b in zip(xs, ys))
    assert counters.get("veles_fused_fc_launches_total") == before


@pytest.mark.parametrize("bad", ["layers", "n_classes", "device"])
def test_wrapper_rejects(bad):
    ws, bs, zw, zb, ds, lb, plan = _inputs((20, 12, 3), seed=5)
    args = [_torch(ws), _torch(bs), _torch(zw), _torch(zb),
            torch.from_numpy(ds), torch.from_numpy(lb),
            torch.from_numpy(plan), 0.05]
    kw = {}
    if bad == "layers":
        args[1] = args[1][:1]
    elif bad == "n_classes":
        kw["n_classes"] = 5
    else:
        args[4] = args[4].to("meta")
    with pytest.raises(ValueError):
        ff.fused_fc_sgd_epoch(*args, **kw)

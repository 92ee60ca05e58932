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
    ([(784, 100), (100, 10)], 100, 8, 8),
    ([(20, 12), (12, 3)], 10, 8, 8),
    ([(784, 256), (256, 64), (64, 10)], 100, 16, 16),
    ([(16, 2048), (2048, 2048), (2048, 3)], 20, None, None),
])
def test_shared_memory_budget(shapes, mb, cluster, expect):
    """MNIST fits one CTA's 227 KB at cluster 8; the 3-layer chain of the
    chip check needs 16; the reference's oversized chain fits neither."""
    assert ff.choose_cluster(shapes, mb) == expect
    if cluster is not None:
        assert ff.smem_bytes(shapes, mb, cluster) <= ff.SMEM_BUDGET
    assert ff.smem_bytes(shapes, mb, 16) <= ff.smem_bytes(shapes, mb, 8)


def test_mnist_footprint():
    assert ff.smem_bytes([(784, 100), (100, 10)], 100, 8) == 112168


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

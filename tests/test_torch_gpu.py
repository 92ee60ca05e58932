"""Tests of the PyTorch port that need the CUDA card: the hand-written
flash-attention forward and backward kernels and the fused-FC SGD kernel
against their plain torch versions, their builds for ``sm_90a``, the
serving path (the window plane and the continuous engine) and LM
training through the flash kernels, the MNIST
training workflow through the fused-FC kernel, the conv-family units
(cuDNN: no hand-written kernel) against the port on the CPU, and the
recurrent family (cuBLAS products: scan equal to the step loop bit for
bit, the sequence forward within 1e-4 · max(1, max|cpu|) of the CPU's,
and the O(1)-state lane's pooled tokens equal to its solo decode), and
the snapshot plane (2 + 2 epochs across a snapshot equal to 4 straight
ones on the card bit for bit, through the fused-FC kernel and the
general path; a card snapshot restored on the CPU bit for bit) with
BASELINE #2's MeanDispNormalizer on the card against its numpy_run. Each
skips without a card (decided inside the fixture, never at import).

This file imports torch and the port only — the card's machine has no
JAX, and ``tests/conftest.py`` imports it — so run it there with

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py

Tolerance: max abs error <= 1e-4 for kernel vs plain in float32 (the
kernels' products are 3xTF32 on the tensor cores, float32-grade; for the
backward's gradients 1e-4 · max(1, max|plain|));
for the fused-FC epoch also the loss sum within 1e-5 relative and the
error count exact; a small LM's epoch, kernel vs plain attention: NLL
per token within 1e-5 relative, weights within 1e-3 (99.9 % within
1e-5). The kernels' mixed-precision instances (q/k and v in float32 or
bf16) against their plain versions in the same dtypes (the forward in
the kernel's K/V blocks): the largest error of a bf16 output within
2^-7 · max(1, max|plain|) (one bf16 ulp of its largest element), of a
float32 one within 1e-3 of it; the mean error within 4e-6 of it, which
the plain versions on float32 copies miss wherever the instance rounds
p or ds; remat is bit-identical to no remat through the kernels, and
accumulating 2 chunks follows the direct step within rtol 2e-3 / atol
2e-4 (tests/test_train_e2e.py's tolerances). The conv-family units,
forward and the gradients of sum(y · g), on the card against the same
unit on the CPU in float32: max abs error <= 1e-4 · max(1, max|cpu|)
(cuDNN with TF32 off sums float32 products in another order); a control
runs the same conv with ``cudnn.allow_tf32`` forced on and must land
above that limit, so that the test can tell a TF32 leak."""
import json
import urllib.request

import numpy
import pytest
import torch

from chip_smoke import (TOL_CONV, conv_cases, conv_error, conv_inputs,
                        unit_outputs)
from veles_tpu_torch.config import root
from veles_tpu_torch.convert import params_from_jax, random_params
from veles_tpu_torch.error import VelesError
from veles_tpu_torch.nn import sampling
from veles_tpu_torch.nn.standard_workflow import build_forwards
from veles_tpu_torch.ops import flash_attention as fa
from veles_tpu_torch.ops import fused_fc as ff
from veles_tpu_torch.telemetry import counters

pytestmark = pytest.mark.gpu

LAUNCHES = "veles_flash_attention_launches_total"
LAYERS = ([{"type": "embedding", "vocab_size": 64, "dim": 128}]
          + [{"type": "transformer_block", "n_heads": 2, "n_kv_heads": 1,
              "ffn_hidden": 256, "rope": True, "window": w,
              "name": "b%d" % i} for i, w in enumerate((None, 50))]
          + [{"type": "lm_head", "vocab_size": 64}])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no "
                    "CPU mode")
    from veles_tpu_torch.backends import device_for
    return device_for("cuda")


def qkv(device, b, t, h, kv, d, seed):
    rng = numpy.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(b, t, heads, d).astype("float32")
                             ).to(device) for heads in (h, kv, kv)]


@pytest.mark.parametrize("b,t,h,kv,d,causal,window", [
    (4, 512, 8, 8, 64, True, 0), (2, 300, 8, 2, 64, True, 0),
    (2, 512, 8, 8, 64, True, 128), (1, 333, 4, 2, 256, True, 100),
    (2, 200, 8, 8, 32, False, 0), (2, 257, 8, 4, 128, False, 0),
    (1, 1, 2, 2, 48, True, 0),
    # the tensor-core design's tile edges: T around the 64-row q tiles
    # and the streamed K/V tiles; D off the multiples of 16, 33 (rows off
    # 16 bytes: 4-byte copies) and 160 (o's columns over two CTAs); GQA
    # 8/1 with a window
    (2, 65, 4, 4, 64, True, 0), (2, 127, 4, 2, 64, False, 0),
    (2, 129, 4, 4, 64, True, 0), (2, 200, 4, 4, 8, True, 0),
    (2, 150, 4, 2, 40, True, 0), (2, 140, 4, 4, 72, False, 0),
    (2, 100, 4, 4, 33, True, 0), (1, 90, 2, 2, 160, False, 0),
    (2, 300, 8, 1, 64, True, 64)])
def test_kernel_matches_plain(cuda, b, t, h, kv, d, causal, window):
    q, k, v = qkv(cuda, b, t, h, kv, d, seed=t)
    before = counters.get(LAUNCHES)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    ro, rlse = fa.flash_attention_fwd_reference(q, k, v, causal=causal,
                                                window=window)
    torch.cuda.synchronize()
    assert counters.get(LAUNCHES) == before + 1
    assert float((o - ro).abs().max()) <= 1e-4
    assert float((lse - rlse).abs().max()) <= 1e-4


def test_kernel_reads_strided_inputs(cuda):
    """q/k/v as views into a fused (B, T, 3, H, D) buffer: read through
    their strides, no copy."""
    qkv_buf = torch.randn(2, 100, 3, 4, 32, device=cuda)
    q, k, v = qkv_buf.unbind(2)
    o, _ = fa.flash_attention_fwd(q, k, v, causal=True)
    ro, _ = fa.flash_attention_fwd_reference(q, k, v, causal=True)
    assert float((o - ro).abs().max()) <= 1e-4


def test_kernel_reads_rows_off_16_bytes(cuda):
    """q/k/v as views one element into their buffers: no row starts on 16
    bytes, so every tile row takes the kernel's 4-byte copies."""
    def view(heads):
        return torch.randn(2 * 100 * heads * 64 + 1, device=cuda)[1:].view(
            2, 100, heads, 64)

    q, k, v = view(4), view(2), view(2)
    before = counters.get(LAUNCHES)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    ro, rlse = fa.flash_attention_fwd_reference(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert counters.get(LAUNCHES) == before + 1
    assert float((o - ro).abs().max()) <= 1e-4
    assert float((lse - rlse).abs().max()) <= 1e-4


@pytest.mark.parametrize("where", ["q", "k", "v"])
@pytest.mark.parametrize("causal", [False, True])
def test_kernel_keeps_nan(cuda, where, causal):
    """A NaN made by the card's arithmetic (0/0: bits 0x7fffffff) in one
    element of q, k or v reaches o and lse where it reaches the plain
    version's: a q row's NaN its own o row and lse; a NaN at key row 0,
    which every query row sees, its head's every o row and lse (k) or one
    column of o (v). Every other element agrees within 1e-4."""
    b, t, h, d, i = 1, 100, 2, 64, 70
    q, k, v = qkv(cuda, b, t, h, h, d, seed=7)
    nan = torch.zeros((), device=cuda) / torch.zeros((), device=cuda)
    x = {"q": q, "k": k, "v": v}[where]
    x[0, i if where == "q" else 0, 1, 5] = nan
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    ro, rlse = fa.flash_attention_fwd_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert bool(torch.isnan(ro).any())
    for a, r in ((o, ro), (lse, rlse)):
        expect = torch.isnan(r)
        assert torch.equal(torch.isnan(a), expect)
        both = ~expect
        assert float((a[both] - r[both]).abs().max()) <= 1e-4


def test_kernel_takes_more_than_65535_heads(cuda):
    """B * H = 65,544 (batch, head) pairs: one flat grid index, so no
    65,535 cap from a grid axis."""
    q, k, v = qkv(cuda, 8193, 2, 8, 8, 8, seed=8)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    ro, rlse = fa.flash_attention_fwd_reference(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert float((o - ro).abs().max()) <= 1e-4
    assert float((lse - rlse).abs().max()) <= 1e-4


def test_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = qkv(cuda, 1, 16, 2, 2, 32, seed=0)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros(1, 4, 1, 320, device=cuda)
        fa.flash_attention_fwd(big, big, big)
    with pytest.raises(ValueError, match="stride"):
        fa.flash_attention_fwd(q[..., ::2], k[..., ::2], v[..., ::2])


def test_kernel_builds_for_sm90a(cuda):
    from veles_tpu_torch.ops import _build
    _build.load("flash_attention_fwd")
    assert "sm_90a" in _build.build_log("flash_attention_fwd")


@pytest.fixture
def model(cuda):
    m = build_forwards(LAYERS, device=cuda)
    return params_from_jax(m, random_params(m, seed=4))


def test_prefill_runs_the_kernel_and_matches_plain(model):
    prompt = [int(t) for t in numpy.random.RandomState(1).randint(0, 64, 97)]
    before = counters.get(LAUNCHES)
    flash_logits = sampling.prompt_logits(model, prompt)
    flash_tokens = sampling.generate(model, [prompt, prompt[::-1]], 12,
                                     temperature=0)
    assert counters.get(LAUNCHES) == before + 2 * 2   # 2 blocks x 2 calls
    root.common.engine.flash_attention = False
    try:
        plain_logits = sampling.prompt_logits(model, prompt)
        plain_tokens = sampling.generate(model, [prompt, prompt[::-1]], 12,
                                         temperature=0)
    finally:
        root.common.engine.flash_attention = True
    assert numpy.abs(flash_logits - plain_logits).max() <= 1e-4
    assert flash_tokens == plain_tokens


def test_generation_api_serves_on_the_card(model):
    from veles_tpu_torch.restful_api import GenerationAPI
    api = GenerationAPI(model, port=0).initialize()    # default: cuda
    try:
        assert api.device.type == "cuda"
        req = urllib.request.Request(
            "http://127.0.0.1:%d/generate" % api.port,
            data=json.dumps({"prompt": [1, 2, 3, 4], "n_new": 6}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
    finally:
        api.stop()
    assert body["tokens"] == sampling.generate(model, [1, 2, 3, 4], 6,
                                               temperature=0)


def _engine_requests(seed, n, vocab=64):
    rng = numpy.random.RandomState(seed)
    from veles_tpu_torch.serving import make_request
    return [make_request(rng.randint(1, vocab, int(t_p)).tolist(),
                         int(n_new), temperature=0.8 if i % 2 else 0.0,
                         seed=seed + i)
            for i, (t_p, n_new) in enumerate(zip(
                rng.randint(1, 120, n), rng.randint(1, 20, n)))]


def test_engine_on_the_card_matches_solo(model):
    """The continuous engine on the card (GQA 2/1, one block with a
    window of 50): greedy and sampled rows equal the port's solo
    generate, every prefill block is one flash-forward launch, and the
    page ledger is empty afterwards."""
    from veles_tpu_torch.serving import ContinuousEngine
    reqs = _engine_requests(5, 10)
    engine = ContinuousEngine(model, max_slots=4, buckets=(32, 64, 128),
                              max_context=160, name="gpu_eng").start()
    try:
        before = counters.counters.snapshot()
        out = engine.serve(reqs)
        delta = counters.counters.delta(before)
    finally:
        engine.stop()
    for req, toks in zip(reqs, out):
        assert toks == sampling.generate(
            model, req["prompt"], req["n_new"],
            temperature=req["temperature"], seed=req["seed"])
    assert delta["veles_serving_prefill_dispatches_total"] == len(reqs)
    assert delta[LAUNCHES] == 2 * len(reqs)           # 2 blocks each
    assert engine.peak_slots >= 2
    assert engine.page_pool.ledger() == {}
    assert engine.page_pool.in_use() == 0


def test_engine_reuses_retired_pages_on_the_card(model):
    """A page-constrained pool on the card hands a retired slot's pages
    to new requests; each still gets its solo tokens."""
    from veles_tpu_torch.serving import ContinuousEngine
    reqs = _engine_requests(9, 8)
    solo = [sampling.generate(model, r["prompt"], r["n_new"],
                              temperature=r["temperature"], seed=r["seed"])
            for r in reqs]
    engine = ContinuousEngine(model, max_slots=3, buckets=(32, 64, 128),
                              max_context=160, page_size=16, pages=12,
                              name="gpu_tight").start()
    try:
        for _wave in range(2):
            assert engine.serve(list(reqs)) == solo
            assert engine.serve(list(reversed(reqs))) == solo[::-1]
        assert engine.page_pool.ledger() == {}
        assert not engine._page_table.any()
    finally:
        engine.stop()


def test_flash_forward_refuses_to_drop_gradients(cuda):
    """``flash_attention_fwd`` writes o outside autograd: where q/k/v
    need gradients it raises and names the differentiable entry, whose
    gradients (the backward kernel pair) match autograd through the plain
    attention."""
    q, k, v = qkv(cuda, 1, 16, 2, 2, 32, seed=3)
    q.requires_grad_(True)
    with pytest.raises(VelesError, match="call flash_attention"):
        fa.flash_attention_fwd(q, k, v, causal=True)
    with torch.no_grad():
        o, _ = fa.flash_attention_fwd(q, k, v, causal=True)
    ro, _ = fa.flash_attention_fwd_reference(q.detach(), k, v, causal=True)
    assert float((o - ro).abs().max()) <= 1e-4
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    plain = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    do = torch.randn_like(q)
    got = torch.autograd.grad(fa.flash_attention(*leaves, causal=True),
                              leaves, do)
    from veles_tpu_torch.nn.attention import attention_reference
    want = torch.autograd.grad(attention_reference(*plain, causal=True),
                               plain, do)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-4


BWD_CASES = [
    # (B, T, H, KV, D, causal, window)
    (16, 512, 8, 8, 64, True, 0), (2, 300, 8, 2, 64, True, 0),
    (2, 512, 8, 8, 64, True, 128), (1, 333, 4, 2, 256, True, 100),
    (2, 257, 8, 8, 128, False, 0), (1, 1, 2, 2, 48, True, 0),
    (2, 200, 8, 8, 32, False, 0),
    # the tensor-core design's tile edges: T around the 64-row tiles; D
    # off the multiples of 16, 33 (rows off 16 bytes: 4-byte copies) and
    # 160 (two column CTAs); GQA 8/1 with a window
    (2, 65, 4, 4, 64, True, 0), (2, 127, 4, 2, 64, False, 0),
    (2, 129, 4, 4, 64, True, 0), (2, 200, 4, 4, 8, True, 0),
    (2, 150, 4, 2, 40, True, 0), (2, 140, 4, 4, 72, False, 0),
    (2, 100, 4, 4, 33, True, 0), (1, 90, 2, 2, 160, False, 0),
    (2, 300, 8, 1, 64, True, 64)]


@pytest.mark.parametrize("b,t,h,kv,d,causal,window", BWD_CASES)
def test_backward_kernels_match_plain(cuda, b, t, h, kv, d, causal,
                                      window):
    q, k, v = qkv(cuda, b, t, h, kv, d, seed=t + 1)
    do = qkv(cuda, b, t, h, h, d, seed=t + 2)[0]
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    before = [counters.get(n) for n in (fa.DKV_LAUNCHES, fa.DQ_LAUNCHES)]
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                 window=window)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                   window=window)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                            causal=causal, window=window)
    torch.cuda.synchronize()
    assert [counters.get(n) for n in (fa.DKV_LAUNCHES, fa.DQ_LAUNCHES)] \
        == [x + 2 for x in before]
    for a, r in zip(got, want):
        tol = 1e-4 * max(1.0, float(r.abs().max()))
        assert float((a - r).abs().max()) <= tol
    # a fixed loop order and no atomics: relaunches give the same bits
    assert all(torch.equal(a, r) for a, r in zip(got, again))


def test_backward_kernels_read_strided_inputs(cuda):
    """q/k/v as views into a fused (B, T, 3, H, D) buffer."""
    buf = torch.randn(2, 100, 3, 4, 32, device=cuda)
    q, k, v = buf.unbind(2)
    do = torch.randn(2, 100, 4, 32, device=cuda)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                            causal=True)
    for a, r in zip(got, want):
        assert float((a - r).abs().max()) <= 1e-4 * max(
            1.0, float(r.abs().max()))


def test_backward_kernels_read_rows_off_16_bytes(cuda):
    """q/k/v/do as views one element into their buffers: no row starts on
    16 bytes, so every tile row takes the kernels' 4-byte copies."""
    def view(heads):
        return torch.randn(2 * 100 * heads * 64 + 1, device=cuda)[1:].view(
            2, 100, heads, 64)

    q, k, v, do = view(4), view(2), view(2), view(4)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    before = [counters.get(n) for n in (fa.DKV_LAUNCHES, fa.DQ_LAUNCHES)]
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                            causal=True)
    torch.cuda.synchronize()
    assert [counters.get(n) for n in (fa.DKV_LAUNCHES, fa.DQ_LAUNCHES)] \
        == [x + 2 for x in before]
    for a, r in zip(got, want):
        assert float((a - r).abs().max()) <= 1e-4 * max(
            1.0, float(r.abs().max()))
    assert all(torch.equal(a, r) for a, r in zip(got, again))


@pytest.mark.parametrize("where,causal", [
    ("do", False), ("lse", False), ("lse", True)])
def test_backward_kernels_keep_nan(cuda, where, causal):
    """A NaN made by the card's arithmetic (0/0: bits 0x7fffffff) in one
    element of do or of lse reaches the gradients. Unmasked, the kernels
    are NaN exactly where the plain backward is. Under causal masking a
    masked probability is 0 in the kernels but exp(NEG_INF - NaN) = NaN
    in the plain backward, so the kernels are NaN exactly where the NaN row
    reaches: its dq row and the dk/dv rows of the keys it sees. Every
    other element agrees with the plain backward."""
    b, t, h, d, i = 1, 100, 2, 64, 70
    q, k, v = qkv(cuda, b, t, h, h, d, seed=5)
    do = qkv(cuda, b, t, h, h, d, seed=6)[0]
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    nan = torch.zeros((), device=cuda) / torch.zeros((), device=cuda)
    if where == "do":
        do = do.clone()
        do[0, i, 1, 5] = nan
    else:
        lse = lse.clone()
        lse[0, 1, i] = nan
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                            causal=causal)
    torch.cuda.synchronize()
    if causal:
        dq_nan = torch.zeros(got[0].shape, dtype=torch.bool, device=cuda)
        dq_nan[0, i, 1] = True
        kv_nan = torch.zeros(got[1].shape, dtype=torch.bool, device=cuda)
        kv_nan[0, :i + 1, 1] = True
        expect = [dq_nan, kv_nan, kv_nan]
    else:
        expect = [torch.isnan(r) for r in want]
    for a, r, e in zip(got, want, expect):
        assert bool(e.any())
        assert torch.equal(torch.isnan(a), e)
        both = ~torch.isnan(r) & ~e
        assert float((a[both] - r[both]).abs().max()) <= 1e-4 * max(
            1.0, float(r[both].abs().max()))


def test_backward_kernels_reject_what_they_do_not_take(cuda):
    q, k, v = qkv(cuda, 1, 16, 2, 2, 32, seed=0)
    o, lse = fa.flash_attention_fwd(q, k, v)
    with pytest.raises(TypeError):
        fa.flash_attention_bwd(q, k, v, o, lse, o.half())
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros(1, 4, 1, 320, device=cuda)
        fa.flash_attention_bwd(big, big, big, big, torch.zeros(
            1, 1, 4, device=cuda), big)
    with pytest.raises(ValueError, match="stride"):
        fa.flash_attention_bwd(q[..., ::2], k[..., ::2], v[..., ::2],
                               o[..., ::2], lse, o[..., ::2])


def test_backward_kernels_build_for_sm90a(cuda):
    from veles_tpu_torch.ops import _build
    _build.load("flash_attention_bwd")
    assert "sm_90a" in _build.build_log("flash_attention_bwd")


def test_lm_train_steps_kernel_route_match_plain(cuda):
    """A small char LM on the card, 1 epoch from one seed: the kernel
    route (forward and backward kernels in every block) against the
    plain attention under autograd."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.models import char_lm

    def run(flash):
        root.common.engine.flash_attention = flash
        prng.seed_all(11)
        wf = char_lm.build_workflow(epochs=1, minibatch_size=16,
                                    n_train=64, n_valid=32, n_blocks=2,
                                    dim=64, lr=1e-4)
        wf.initialize()
        before = [counters.get(n) for n in (
            LAUNCHES, fa.DKV_LAUNCHES, fa.DQ_LAUNCHES)]
        wf.run()
        after = [counters.get(n) for n in (
            LAUNCHES, fa.DKV_LAUNCHES, fa.DQ_LAUNCHES)]
        return wf, [a - b for a, b in zip(after, before)]

    try:
        kern, launches = run(True)
        plain, none = run(False)
    finally:
        root.common.engine.flash_attention = True
    # 2 blocks x (4 train + 2 validation steps); backward on train only
    assert launches == [2 * 6, 2 * 4, 2 * 4] and none == [0, 0, 0]
    for cls in (1, 2):
        numpy.testing.assert_allclose(kern.decision.epoch_losses[cls],
                                      plain.decision.epoch_losses[cls],
                                      rtol=1e-5)
    # adam's normalised step is about +-lr wherever a gradient is
    # rounding noise, so one element may flip by 2 lr a step; the bulk
    # agrees to rounding
    diff = torch.cat([(t - plain.train_step.params[name][k]).abs().flatten()
                      for name, p in kern.train_step.params.items()
                      for k, t in p.items()])
    assert float(diff.max()) <= 1e-3
    assert float(torch.quantile(diff, 0.999)) <= 1e-5


AMP_CASES = [
    # (B, T, H, KV, D, causal, window)
    (16, 512, 8, 8, 64, True, 0), (2, 300, 8, 1, 64, True, 64),
    (2, 127, 4, 2, 64, False, 0), (1, 1, 2, 2, 48, True, 0),
    (2, 65, 4, 4, 8, True, 0), (2, 100, 4, 4, 33, True, 0),
    (2, 140, 4, 4, 72, False, 0), (1, 333, 4, 2, 256, True, 100)]


#: the outputs of each instance whose products take p or ds rounded to
#: bf16 (p to v's and do's dtype, ds to q's and k's)
AMP_ROUNDED = {"f32_bf16": ("o",), "bf16_f32": ("dq", "dk", "dv"),
               "bf16_bf16": ("o", "dq", "dk", "dv")}


def amp_plain(q, k, v, do, causal, window, o, lse, f32=False):
    """The plain versions' outputs in the inputs' dtypes, the forward in
    the kernel's K/V blocks, the backward from the kernel's o and lse;
    ``f32``: on float32 copies of the inputs (no p or ds rounded)."""
    xs = tuple(x.float() for x in (q, k, v, do)) if f32 else (q, k, v, do)
    ro, rlse = fa.flash_attention_fwd_reference(
        *xs[:3], causal=causal, window=window,
        block_k=fa.kernel_block_k(q.shape[-1]))
    grads = fa.flash_attention_bwd_reference(*xs[:3], o, lse, xs[3],
                                             causal=causal, window=window)
    return dict(o=ro.to(q.dtype), lse=rlse, **{
        n: g.to(x.dtype) for n, g, x in zip(("dq", "dk", "dv"), grads,
                                            (q, k, v))})


def amp_errors(got, want, control):
    """(max abs error, its limit, mean abs error, its limit, the
    control's mean abs error) of a kernel output against the plain
    version's ``want``: the max within one bf16 ulp of the largest element
    for bf16, 1e-3 for float32; the mean within 4e-6 (each times max(1,
    max|want|))."""
    want_f = want.float()
    scale = max(1.0, float(want_f.abs().max()))
    limit = (2.0 ** -7 if want.dtype == torch.bfloat16 else 1e-3) * scale
    diff = (got.float() - want_f).abs()
    return (float(diff.max()), limit, float(diff.mean()), 4e-6 * scale,
            float((control.float() - want_f).abs().mean()))


@pytest.mark.parametrize("inst", ["f32_bf16", "bf16_f32", "bf16_bf16"])
@pytest.mark.parametrize("b,t,h,kv,d,causal,window", AMP_CASES)
def test_amp_instances_match_plain(cuda, inst, b, t, h, kv, d, causal,
                                   window):
    """Each mixed-precision instance of the three kernels against its
    plain version in the same dtypes: outputs in the inputs' dtypes, each
    kernel launched once and counted under its instance; the control,
    which rounds no p and no ds, misses the mean limit of every output
    the instance rounds for (beyond one key, where p = 1)."""
    qk, vt = (torch.bfloat16 if n == "bf16" else torch.float32
              for n in inst.split("_"))
    q, k, v = qkv(cuda, b, t, h, kv, d, seed=t + d)
    q, k, v = q.to(qk), k.to(qk), v.to(vt)
    do = torch.randn_like(q, dtype=torch.float32).to(qk)
    names = [fa.launch_counter(n, inst) for n in (
        LAUNCHES, fa.DKV_LAUNCHES, fa.DQ_LAUNCHES)]
    before = [counters.get(n) for n in names]
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                 window=window)
    assert [counters.get(n) - c for n, c in zip(names, before)] == [1, 1, 1]
    ref = amp_plain(q, k, v, do, causal, window, o, lse)
    ctl = amp_plain(q, k, v, do, causal, window, o, lse, f32=True)
    torch.cuda.synchronize()
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    assert [g.dtype for g in got] == [q.dtype, k.dtype, v.dtype]
    outs = dict(o=o, lse=lse, dq=got[0], dk=got[1], dv=got[2])
    for n, x in outs.items():
        assert bool(torch.isfinite(x.float()).all())
        err, limit, mean, mean_limit, ctl_mean = amp_errors(x, ref[n],
                                                            ctl[n])
        assert err <= limit and mean <= mean_limit, (n, err, limit, mean,
                                                     mean_limit)
        if t > 1 and n in AMP_ROUNDED[inst]:
            assert ctl_mean > mean_limit, (n, ctl_mean, mean_limit)


def _small_lm(remat=False, grad_accumulation=1):
    """The small char LM of the test above on the card under mixed
    precision (resolved at initialize), 2 train steps of 16 rows and
    one validation step through the kernels: trained, its params."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.models import char_lm
    root.common.engine.mixed_precision = True
    try:
        prng.seed_all(11)
        wf = char_lm.build_workflow(epochs=1, minibatch_size=16, n_train=32,
                                    n_valid=16, n_blocks=2, dim=64, lr=1e-4)
        wf.train_step.remat = remat
        wf.train_step.grad_accumulation = grad_accumulation
        wf.initialize()
    finally:
        root.common.engine.mixed_precision = False
    assert wf.train_step.mixed_precision
    wf.run()
    return {(n, k): t for n, p in wf.train_step.params.items()
            for k, t in p.items()}


def test_remat_is_bit_identical_through_the_kernels(cuda):
    """2 steps of a small LM under mixed precision through the kernels
    (its first block takes the (f32, f32, bf16) instance), with and
    without remat: the same bits in every parameter, the forward kernels
    launched again in the recompute."""
    names = [fa.launch_counter(LAUNCHES, "f32_bf16"),
             fa.launch_counter(fa.DKV_LAUNCHES, "f32_bf16")]
    runs, launched = {}, {}
    for remat in (False, True):
        before = [counters.get(n) for n in names]
        runs[remat] = _small_lm(remat=remat)
        launched[remat] = [counters.get(n) - c
                           for n, c in zip(names, before)]
    # 2 train steps and 1 validation step, the recompute once a train step
    assert launched == {False: [3, 2], True: [5, 2]}
    for key, t in runs[False].items():
        assert torch.equal(t, runs[True][key]), key
        assert t.dtype == torch.float32


def test_grad_accumulation_follows_the_direct_step(cuda):
    """2 steps of a small LM under mixed precision through the kernels,
    the minibatch of 16 as 2 accumulated chunks and as one."""
    direct = _small_lm()
    accum = _small_lm(grad_accumulation=2)
    for key, t in direct.items():
        torch.testing.assert_close(accum[key], t, rtol=2e-3, atol=2e-4)


FFC_LAUNCHES = "veles_fused_fc_launches_total"


def ffc_inputs(device, dims, mb, steps, n_rows, seed, plan="permutation"):
    """``plan``: "permutation" (each row once) or "repeats" (drawn with
    replacement: rows recur within and across steps)."""
    rng = numpy.random.RandomState(seed)

    def dev(a):
        return torch.from_numpy(a).to(device)
    ws = [dev((rng.randn(a, b) / numpy.sqrt(a)).astype("float32"))
          for a, b in zip(dims, dims[1:])]
    bs = [dev((rng.randn(b) * 0.01).astype("float32")) for b in dims[1:]]
    vws = [torch.zeros_like(w) for w in ws]
    vbs = [torch.zeros_like(b) for b in bs]
    ds = dev(rng.rand(n_rows, dims[0]).astype("float32"))
    lb = dev(rng.randint(0, dims[-1], n_rows).astype("int32"))
    rows = (rng.permutation(n_rows)[:steps * mb] if plan == "permutation"
            else rng.randint(0, n_rows, steps * mb))
    return ([ws, bs, vws, vbs], ds, lb,
            dev(rows.reshape(steps, mb).astype("int32")))


def assert_ffc_close(out, ref):
    for xs, ys in zip(out[:4], ref[:4]):
        for a, b in zip(xs, ys):
            assert torch.equal(torch.isnan(a), torch.isnan(b))
            live = ~torch.isnan(b)
            if bool(live.any()):
                assert float((a[live] - b[live]).abs().max()) <= 1e-4
    if numpy.isnan(float(ref[4])):
        assert numpy.isnan(float(out[4]))
    else:
        assert abs(float(out[4]) - float(ref[4])) <= 1e-5 * abs(
            float(ref[4]))
    assert float(out[5]) == float(ref[5])


def same_bits(x, y):
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for xs, ys in zip(x[:4], y[:4]) for a, b in zip(xs, ys))


@pytest.mark.parametrize("dims,mb,steps,plan,kw", [
    ([20, 12, 3], 10, 12, "permutation", dict(act_a=1.0, act_b=1.0)),
    ([20, 12, 3], 10, 12, "permutation",
     dict(momentum=0.9, wd=1e-3, wd_bias=1e-4, lr_bias_ratio=0.5)),
    ([20, 16, 8, 3], 10, 12, "permutation",
     dict(act_a=1.7159, act_b=0.6666, momentum=0.5)),
    ([784, 100, 10], 100, 12, "permutation",
     dict(act_a=1.7159, act_b=0.6666)),
    ([784, 100, 10], 37, 12, "permutation",
     dict(act_a=1.7159, act_b=0.6666, momentum=0.9)),
    # rows of 33 floats (4-byte copies), a one-step plan, a plan that
    # repeats rows, the chain that keeps the column layout
    ([33, 100, 10], 100, 12, "permutation",
     dict(act_a=1.7159, act_b=0.6666, momentum=0.9)),
    ([784, 100, 10], 100, 1, "permutation",
     dict(act_a=1.7159, act_b=0.6666)),
    ([784, 100, 10], 100, 12, "repeats",
     dict(act_a=1.7159, act_b=0.6666, momentum=0.9)),
    ([784, 256, 64, 10], 100, 12, "permutation",
     dict(act_a=1.7159, act_b=0.6666, momentum=0.5)),
    # an empty plan: the state comes back as it went in
    ([784, 100, 10], 100, 0, "permutation",
     dict(act_a=1.7159, act_b=0.6666, momentum=0.9)),
], ids=["unit_ab", "momentum_decay", "three_layer", "mnist", "mb37",
        "d33", "one_step", "repeated_rows", "columns_784_256_64_10",
        "no_steps"])
def test_fused_fc_kernel_matches_plain(cuda, dims, mb, steps, plan, kw):
    state, ds, lb, plan = ffc_inputs(cuda, dims, mb, steps, 1500, seed=mb,
                                     plan=plan)
    before = counters.get(FFC_LAUNCHES)
    out = ff.fused_fc_sgd_epoch(*state, ds, lb, plan, 0.05, **kw)
    again = ff.fused_fc_sgd_epoch(*state, ds, lb, plan, 0.05, **kw)
    ref = ff.fused_fc_sgd_epoch_reference(*state, ds, lb, plan, 0.05, **kw)
    torch.cuda.synchronize()
    assert counters.get(FFC_LAUNCHES) == before + 2
    assert_ffc_close(out, ref)
    # fixed reduction order: two launches are bit-identical
    assert same_bits(out, again)
    # a second epoch continues from the returned state
    out2 = ff.fused_fc_sgd_epoch(*out[:4], ds, lb, plan, 0.05, **kw)
    ref2 = ff.fused_fc_sgd_epoch_reference(*ref[:4], ds, lb, plan, 0.05,
                                           **kw)
    assert_ffc_close(out2, ref2)


def test_fused_fc_kernel_keeps_nan(cuda):
    """A NaN in one dataset row that step 5 reads: the outputs are NaN
    exactly where the plain version's are (every one, once the NaN has
    reached the sums), the error count the same."""
    kw = dict(act_a=1.7159, act_b=0.6666, momentum=0.9)
    state, ds, lb, plan = ffc_inputs(cuda, [784, 100, 10], 100, 12, 1500, 3)
    ds[int(plan[5, 7]), 300] = float("nan")
    out = ff.fused_fc_sgd_epoch(*state, ds, lb, plan, 0.05, **kw)
    ref = ff.fused_fc_sgd_epoch_reference(*state, ds, lb, plan, 0.05, **kw)
    assert bool(torch.isnan(ref[0][0]).any())
    assert_ffc_close(out, ref)


#: (chain, mb) cases and every geometry the wrapper may choose for each
FFC_GEOMETRY_CASES = [
    (dims, mb, geometry)
    for dims, mb in (([784, 100, 10], 100), ([784, 100, 10], 37),
                     ([20, 12, 3], 10), ([784, 256, 64, 10], 100),
                     ([784, 200, 10], 100))
    for geometry in ff.geometries(list(zip(dims, dims[1:])), mb)]


@pytest.mark.parametrize(
    "dims,mb,geometry", FFC_GEOMETRY_CASES,
    ids=["%s-mb%d-%s%d" % ("-".join(map(str, d)), mb, *g)
         for d, mb, g in FFC_GEOMETRY_CASES])
def test_fused_fc_cluster_sizes_agree(cuda, dims, mb, geometry):
    """Every sum runs in one order fixed by the shapes, so every geometry
    the wrapper may choose gives the default's bits."""
    state, ds, lb, plan = ffc_inputs(cuda, dims, mb, 6, 1000, 1)
    base = ff.fused_fc_sgd_epoch(*state, ds, lb, plan, 0.03)
    out = ff.fused_fc_sgd_epoch(*state, ds, lb, plan, 0.03,
                                cluster=geometry[1])
    assert same_bits(out, base)


def test_fused_fc_kernel_builds_for_sm90a(cuda):
    from veles_tpu_torch.ops import _build
    _build.load("fused_fc_sgd")
    assert "sm_90a" in _build.build_log("fused_fc_sgd")


def test_training_workflow_runs_the_kernel(cuda):
    """A small StandardWorkflow on the card (the default device): the
    fused run launches the kernel once per epoch and follows the general
    path's per-epoch error rates and weights."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.loader import FullBatchLoader

    class Blobs(FullBatchLoader):
        hide_from_registry = True

        def load_data(self):
            rng = numpy.random.RandomState(9)
            centers = rng.randn(3, 16) * 2.5
            x = numpy.concatenate([centers[c] + rng.randn(50, 16)
                                   for c in range(3)])
            y = numpy.repeat(numpy.arange(3), 50)
            perm = rng.permutation(len(x))
            self.create_originals(x[perm].astype("float32"),
                                  y[perm].astype("int32"))
            self.class_lengths = [0, 30, 120]

    from veles_tpu_torch.nn.standard_workflow import StandardWorkflow

    def run(fused):
        root.common.engine.fused_fc_scan = fused
        prng.seed_all(777)
        wf = StandardWorkflow(
            name="gpu-train",
            layers=[{"type": "all2all_tanh", "output_sample_shape": 8,
                     "learning_rate": 0.05, "momentum": 0.9},
                    {"type": "softmax", "output_sample_shape": 3,
                     "learning_rate": 0.05, "momentum": 0.9}],
            loader_unit=Blobs(None, minibatch_size=20, name="bl"),
            decision_config=dict(max_epochs=4, fail_iterations=100),
            epochs_per_dispatch=2)
        wf.initialize()
        before = counters.get(FFC_LAUNCHES)
        wf.run()
        return wf, counters.get(FFC_LAUNCHES) - before

    try:
        fused, launches = run(True)
        general, none = run(False)
    finally:
        root.common.engine.fused_fc_scan = False
    assert fused.train_step.device.type == "cuda"
    assert fused.train_step._fused_fc_active and launches == 4
    assert none == 0
    for cls in (0, 1, 2):
        numpy.testing.assert_allclose(fused.decision.epoch_metrics[cls],
                                      general.decision.epoch_metrics[cls],
                                      atol=1e-5)
    for f, g in zip(fused.forwards, general.forwards):
        numpy.testing.assert_allclose(f.weights.map_read(),
                                      g.weights.map_read(), rtol=2e-4,
                                      atol=2e-5)


# -- the conv family on cuDNN ------------------------------------------------
# the cases and their comparison are chip_smoke.py's conv_units phase's


CONV_NAMES = [
    "conv_3x3_64", "conv_tanh_stride_asym", "conv_relu_rgb_stem",
    "conv_sigmoid_no_bias", "deconv_3x3_128_64", "deconv_s2_asym_bias",
    "max_pool_3_2_ceil", "max_pool_ties", "avg_pool_2_ceil",
    "avg_pool_k_below_s", "depool_2", "activation_tanh", "activation_relu",
    "activation_str", "activation_sigmoid", "activation_log",
    "activation_mul"]


@pytest.mark.parametrize("name", CONV_NAMES)
def test_conv_family_on_the_card_matches_cpu(cuda, name):
    case = {c[0]: c for c in conv_cases()}[name]
    _, u, x_shape, p_shapes = case
    assert not torch.backends.cudnn.allow_tf32
    x, params = conv_inputs(name, x_shape, p_shapes, seed=21)
    want = unit_outputs(u, x, params, "cpu", 21)
    got = unit_outputs(u, x, params, cuda, 21)
    assert sorted(got) == sorted(want)
    assert conv_error(got, want) <= TOL_CONV, name


def test_conv_tf32_control_lands_above_the_limit(cuda):
    """The same conv with cuDNN's TF32 forced on: about 2^-11 of the
    largest output apart, above the 1e-4 the float32 route holds."""
    _, u, x_shape, p_shapes = conv_cases()[0]
    x, params = conv_inputs("conv", x_shape, p_shapes, seed=21)
    want = unit_outputs(u, x, params, "cpu", 21)
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = unit_outputs(u, x, params, cuda, 21)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    assert conv_error(got, want) > TOL_CONV


# -- the recurrent family (no hand-written kernel: cuBLAS products) ----------

RECURRENT = {
    "lstm": [{"type": "lstm", "hidden_size": 64, "return_sequences": True,
              "name": "r0"},
             {"type": "lstm", "hidden_size": 64, "return_sequences": True,
              "name": "r1"}],
    "rnn": [{"type": "rnn", "hidden_size": 64, "return_sequences": True,
             "name": "r0"}],
    "ssm": [{"type": "ssm_block", "n_heads": 4, "name": "r0"},
            {"type": "ssm_block", "n_heads": 4, "name": "r1"}],
}


def _recurrent_lm(family, device):
    """A char-LM-shaped recurrent stack (vocab 64, dim 64) with random
    weights from a numpy seed, the embedding scaled up so that the
    tokens vary."""
    stack = build_forwards(
        [{"type": "embedding", "vocab_size": 64, "dim": 64}]
        + RECURRENT[family] + [{"type": "lm_head", "vocab_size": 64}],
        device=device)
    tree = random_params(stack, seed=8)
    tree["embedding0"]["table"] *= 50
    return params_from_jax(stack, tree)


@pytest.mark.parametrize("family", sorted(RECURRENT))
def test_recurrent_scan_equals_step_on_the_card(cuda, family):
    """On the card the scan is the step body's loop bit for bit, and the
    sequence forward agrees with the CPU's within 1e-4 · max(1,
    max|cpu|)."""
    card, host = _recurrent_lm(family, cuda), _recurrent_lm(family, "cpu")
    x = torch.from_numpy(numpy.random.RandomState(2).randn(
        5, 33, 64).astype("float32"))
    with torch.no_grad():
        for layer, cpu_layer in zip(list(card)[1:-1], list(host)[1:-1]):
            p = layer.params()
            xc = x.to(cuda)
            st0 = layer.init_state(5, device=cuda)
            ys, st_scan = layer.scan_state(p, xc, st0)
            st, loop = st0, []
            for t in range(x.shape[1]):
                y, st = layer.step_state(p, xc[:, t].contiguous(), st)
                loop.append(y)
            assert torch.equal(ys, torch.stack(loop, dim=1))
            for k in st:
                assert torch.equal(st_scan[k], st[k]), k
            want = cpu_layer(x)
            err = float((ys.cpu() - want).abs().max())
            assert err <= 1e-4 * max(1.0, float(want.abs().max()))
            x = want


@pytest.mark.parametrize("family", ["lstm", "ssm"])
def test_recurrent_pool_matches_solo_on_the_card(cuda, family):
    """The O(1)-state lane on the card: pooled greedy and sampled rows
    (4 slots, chunks of 8, one pool tile) equal the solo decode."""
    from veles_tpu_torch.serving import (RecurrentEngine,
                                         generate_recurrent)
    model = _recurrent_lm(family, cuda)
    reqs = _engine_requests(13, 8)
    engine = RecurrentEngine(model, max_slots=4, max_context=160,
                             page_size=8, name="gpu_o1").start()
    try:
        out = engine.serve(reqs)
        stats = engine.stats()
    finally:
        engine.stop()
    for req, toks in zip(reqs, out):
        assert toks == generate_recurrent(
            model, req["prompt"], req["n_new"],
            temperature=req["temperature"], seed=req["seed"],
            mode="sample" if req["temperature"] > 0 else "greedy")
    assert stats["admitted"] == stats["retired"] == len(reqs)
    assert stats["pages_total"] == 0
    assert len({tuple(t) for t in out}) > 1


# -- snapshots and BASELINE #2 on the card ------------------------------------


def _tiny_snapshot_workflow(directory, epochs, fused, device=None):
    """tests/test_snapshot.py's TinyLoader chain (240 × 8, 3 classes, mb
    20, exp_decay(0.9)) in epoch blocks of 2, with a Snapshotter writing
    to ``directory`` if given; initialised on ``device`` (the card)."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.loader import FullBatchLoader
    from veles_tpu_torch.nn.lr_adjust import exp_decay
    from veles_tpu_torch.nn.standard_workflow import StandardWorkflow
    from veles_tpu_torch.snapshotter import Snapshotter

    class Tiny(FullBatchLoader):
        hide_from_registry = True

        def load_data(self):
            rng = numpy.random.RandomState(5)
            self.create_originals(rng.rand(240, 8).astype(numpy.float32),
                                  rng.randint(0, 3, 240).astype(
                                      numpy.int32))
            self.class_lengths = [0, 40, 200]

    root.common.engine.fused_fc_scan = fused
    prng.seed_all(1234)
    snap = (Snapshotter(None, prefix="tiny", directory=str(directory))
            if directory else None)
    wf = StandardWorkflow(
        name="snap-gpu",
        layers=[{"type": "all2all_tanh", "output_sample_shape": 8},
                {"type": "softmax", "output_sample_shape": 3}],
        loader_unit=Tiny(None, minibatch_size=20, name="tiny"),
        decision_config=dict(max_epochs=epochs, fail_iterations=99),
        snapshotter_unit=snap, lr_schedule=exp_decay(0.9),
        epochs_per_dispatch=2)
    wf.initialize(device=device)
    return wf


def _step_tensors(wf):
    ts = wf.train_step
    return {(attr, n, k): t for attr in ("params", "opt_state")
            for n, p in getattr(ts, attr).items() for k, t in p.items()}


@pytest.mark.parametrize("fused", [True, False])
def test_snapshot_resume_on_the_card_is_bit_equal(cuda, tmp_path, fused):
    """2 + 2 epochs across a snapshot between two epoch blocks equal 4
    straight epochs on the card, bit for bit: through the fused-FC
    kernel (a launch an epoch) and through the general path."""
    from veles_tpu_torch.snapshotter import resume
    try:
        counters.counters.reset()
        straight = _tiny_snapshot_workflow(None, 4, fused)
        straight.run()
        launches = counters.get(FFC_LAUNCHES)
        _tiny_snapshot_workflow(tmp_path, 2, fused).run()
        resumed = _tiny_snapshot_workflow(None, 4, fused)
        resume(resumed, str(tmp_path / "tiny_current.pickle.gz"))
        resumed.decision.complete <<= False
        resumed.run()
    finally:
        root.common.engine.fused_fc_scan = False
    assert counters.get(FFC_LAUNCHES) == (8 if fused else 0)
    assert launches == (4 if fused else 0)
    assert resumed.train_step._fused_fc_active is fused
    a, b = _step_tensors(straight), _step_tensors(resumed)
    assert sorted(a) == sorted(b)
    for key, t in a.items():
        assert b[key].device.type == "cuda"
        assert torch.equal(b[key], t), key
    assert resumed.decision.epoch_metrics == straight.decision.epoch_metrics


def test_card_snapshot_resumes_on_the_cpu(cuda, tmp_path):
    """A snapshot taken on the card restores on the CPU bit for bit, and
    the CPU run goes on from it."""
    from veles_tpu_torch.snapshotter import resume
    card = _tiny_snapshot_workflow(tmp_path, 2, False)
    card.run()
    host = _tiny_snapshot_workflow(None, 4, False, device="cpu")
    resume(host, str(tmp_path / "tiny_current.pickle.gz"))
    a, b = _step_tensors(card), _step_tensors(host)
    for key, t in a.items():
        assert b[key].device.type == "cpu"
        assert torch.equal(b[key], t.cpu()), key
    host.decision.complete <<= False
    host.run()
    assert host.decision.epoch_number == 4
    assert all(numpy.isfinite(host.decision.epoch_metrics[1]))


def test_mean_disp_normalizer_on_the_card(cuda):
    from veles_tpu_torch import MeanDispNormalizer
    from veles_tpu_torch.memory import Array
    from veles_tpu_torch.workflow import Workflow
    rng = numpy.random.RandomState(0)
    data = (rng.rand(500, 16, 16, 3) * 255).astype(numpy.float32)
    mean, rdisp = MeanDispNormalizer.compute_mean_rdisp(data)
    u = MeanDispNormalizer(Workflow(name="t"))
    u.input = Array(data)
    u.mean, u.rdisp = Array(mean), Array(rdisp)
    u.initialize(device=cuda)
    u.run()
    assert u.output.devmem.device.type == "cuda"
    y = u.output.map_read().copy()
    u.numpy_run()
    numpy.testing.assert_allclose(y, u.output.map_read(), rtol=1e-5,
                                  atol=1e-6)
    assert abs(y).max() <= 1.0 + 1e-5

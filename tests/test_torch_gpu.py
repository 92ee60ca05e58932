"""Tests of the PyTorch port that need the CUDA card: the hand-written
flash-attention forward and backward kernels and the fused-FC SGD kernel
against their plain torch versions, their builds for ``sm_90a``, the
serving path (the window plane and the continuous engine, with its
speculative and beam rows) and LM
training through the flash kernels, the MNIST
training workflow through the fused-FC kernel, the conv-family units
(cuDNN: no hand-written kernel) against the port on the CPU, and the
recurrent family (cuBLAS products: scan equal to the step loop bit for
bit, the sequence forward within 1e-4 · max(1, max|cpu|) of the CPU's,
and the O(1)-state lane's pooled tokens equal to its solo decode), and
the snapshot plane (2 + 2 epochs across a snapshot equal to 4 straight
ones on the card bit for bit, through the fused-FC kernel and the
general path; a card snapshot restored on the CPU bit for bit) with
BASELINE #2's MeanDispNormalizer on the card against its numpy_run, and
the CLI (``python -m veles_tpu_torch``: ``--backend auto`` initialises
on the card; MNIST through it launches the fused-FC kernel), and the
lossless request plane (a sampled row's generator advanced by offset
arithmetic equals one that replayed the draws; a batch row preempted
and resumed on the pool and on the lane answers its solo tokens), and
the training library (a char LM on real text through the flash kernels
at head dims 12 and 128; tensormon on equal to off bit for bit; the NaN
sentinel's policies; LoRA, smoothing with the confusion matrix and the
fused epilogue on the card against the CPU or bit for bit; a minibatch
file's replay through the fused-FC kernel equal to the in-memory run),
and the rest of the LM family (the multi-head attention unit through the
flash kernels and the MoE layer's routing against the CPU; the
O(1)-state lane's state cache restoring the cold scan's bits), and
classic REST serving with the image loaders (a RESTfulAPI round trip on
the card within 1e-5 of the forward alone; device augmentation's
semantics; the fused-FC gate refusing it), and int8 serving (the int8
quantizer's values and scales on the card equal the CPU's bit for bit;
the int8-weights engine equals the float engine serving the dequantized
twin; the int8 KV pool's rows equal the CPU's quantizer of the same
float rows), and the export plane (the registered flash forward op equal
to the launch bit for bit, counted alike, one node of an exported
program; an exported serve artifact's engine equal to the live engine on
the card; the native runtime built and run on the card's machine), and
distribution (two ranks sharing the card: the ring against one process's
flash attention; the test-width LM over data=2, and under tensor=2 with
each rank's flash launches at its 2 of the 4 heads and fsdp=2, against
one process on the card).
Each skips without a card (decided inside the fixture, never at
import).

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
import os
import urllib.request

import numpy
import pytest
import torch

from chip_smoke import (TOL_CONV, TOL_LM_FAMILY, card_vs_cpu, conv_cases,
                        conv_error, conv_inputs, unit_outputs)
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
    (2, 300, 8, 1, 64, True, 64),
    # tiny_transformer's blocks: 4 heads of 8, not causal
    (64, 16, 4, 4, 8, False, 0)])
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


def _draft(cuda, seed=6):
    """A one-block draft of the ``model`` fixture's shape."""
    d = build_forwards(LAYERS[:2] + LAYERS[-1:], device=cuda)
    return params_from_jax(d, random_params(d, seed=seed))


def _spec_engine(model, draft, name):
    from veles_tpu_torch.serving import ContinuousEngine
    return ContinuousEngine(model, max_slots=4, buckets=(32, 64, 128),
                            max_context=160, spec_gamma=4, beam_width=2,
                            draft=draft, name=name).start()


def test_pooled_greedy_speculative_equals_plain_greedy_on_the_card(
        model, cuda):
    """Greedy speculative rows on the card (the draft over its own paged
    pool, the target's verify in one multi-position pass) answer the
    same engine's plain greedy tokens; each speculative admission
    launches the flash forward once per draft block too."""
    from veles_tpu_torch.serving import make_request
    reqs = [dict(r, temperature=0.0) for r in _engine_requests(13, 6)]
    engine = _spec_engine(model, _draft(cuda), "gpu_spec")
    try:
        plain = engine.serve(reqs)
        before = counters.counters.snapshot()
        spec = engine.serve_results([make_request(
            r["prompt"], r["n_new"], mode="speculative") for r in reqs])
        delta = counters.counters.delta(before)
    finally:
        engine.stop()
    assert [r["tokens"] for r in spec] == plain
    assert all(0.0 <= r["acceptance"] <= 1.0 for r in spec)
    assert delta[LAUNCHES] == (2 + 1) * len(reqs)
    assert engine.page_pool.ledger() == {}


def test_self_draft_accepts_everything_on_the_card(model):
    """The target as its own draft: every draft token verifies."""
    from veles_tpu_torch.serving import make_request
    reqs = [make_request(r["prompt"], 17, mode="speculative")
            for r in _engine_requests(14, 3)]
    engine = _spec_engine(model, model, "gpu_self")
    try:
        out = engine.serve_results(reqs)
        plain = engine.serve([dict(r, mode="greedy") for r in reqs])
    finally:
        engine.stop()
    assert [r["tokens"] for r in out] == plain
    assert [(r["acceptance"], r["rounds"]) for r in out] == [(1.0, 4)] * 3


def test_pooled_beam_equals_solo_on_the_card(model, cuda):
    """A beam group of width 2 on the card (its sibling row a page copy
    of the lead's prefill, the reorder by parent a page gather then
    scatter) gives the solo search's tokens, scores within 1e-5."""
    from veles_tpu_torch.nn.beam import beam_generate
    from veles_tpu_torch.serving import make_request
    engine = _spec_engine(model, None, "gpu_beam")
    try:
        for seed in (15, 16, 17):
            p = _engine_requests(seed, 1)[0]["prompt"]
            res = engine.serve_results([make_request(p, 20, mode="beam",
                                                     beam=2)])[0]
            solo, st = beam_generate(model, p, 20, beam=2)
            assert res["tokens"] == solo
            assert numpy.abs(numpy.asarray(res["scores"])
                             - numpy.asarray(st["scores"])).max() <= 1e-5
        assert engine.page_pool.ledger() == {}
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
    (2, 300, 8, 1, 64, True, 64),
    # tiny_transformer's blocks: 4 heads of 8, not causal
    (64, 16, 4, 4, 8, False, 0)]


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


# -- the lossless request plane on the card ---------------------------------


@pytest.mark.parametrize("vocab", [64, 256, 300])
def test_generator_advance_equals_replay_on_the_card(cuda, vocab):
    """``advanced_generator`` on the card (offset arithmetic on the
    Philox counter) leaves a generator in the state of one that replayed
    ``k`` draws of ``_draw``, whatever the probabilities drawn from, and
    its next draw is the replayed one's."""
    rng = numpy.random.RandomState(vocab)
    for steps in (0, 1, 7, 900):
        gen = torch.Generator(device=cuda)
        gen.manual_seed(11)
        for _ in range(steps):
            sampling._draw(torch.from_numpy(rng.randn(vocab).astype(
                "float32")).to(cuda), 0.8, gen)
        adv = sampling.advanced_generator(11, steps, vocab, cuda)
        assert torch.equal(adv.get_state(), gen.get_state()), steps
        nxt = torch.from_numpy(rng.randn(vocab).astype("float32")).to(cuda)
        assert int(sampling._draw(nxt, 0.8, adv)) \
            == int(sampling._draw(nxt, 0.8, gen))


def _preempt_on(engine, prompt_b, prompt_i, mode):
    """A batch request preempted mid-decode by an interactive arrival on
    a 1-slot engine driven tick by tick → (its tokens, the interactive
    answer's tokens)."""
    from veles_tpu_torch.serving import make_request
    from veles_tpu_torch.serving.scheduler import Ticket
    req = make_request(prompt_b, 24, temperature=0.8 if mode == "sample"
                       else 0.0, seed=99, mode=mode)
    req["priority"] = "batch"
    t_b, t_i = Ticket(mode=mode), Ticket()
    assert engine.submit(req, t_b)
    with torch.inference_mode():
        for _ in range(8):
            engine._tick()
        assert 0 < len(engine.scheduler.active()[0].tokens) < 24
        assert engine.submit(make_request(prompt_i, 4), t_i)
        for _ in range(200):
            if t_b.event.is_set() and t_i.event.is_set():
                break
            engine._tick()
    assert t_b.error is None and t_i.error is None
    assert engine.preemptions == 1
    return t_b.result["tokens"], t_i.result["tokens"]


@pytest.mark.parametrize("mode", ["greedy", "sample"])
def test_preempt_resume_on_the_pool_is_bit_identical_on_the_card(model,
                                                                  mode):
    """QoS on: a batch row preempted on the card and resumed (its
    folded prompt re-prefilled through the flash kernel, a sampled
    row's generator advanced) answers its solo decode's tokens; each
    prefill, the resumed one too, is one launch a block."""
    from veles_tpu_torch.serving import ContinuousEngine
    rng = numpy.random.RandomState(21)
    prompt_b = rng.randint(1, 64, 70).tolist()
    prompt_i = rng.randint(1, 64, 30).tolist()
    root.common.serving.qos = True
    try:
        engine = ContinuousEngine(model, max_slots=1,
                                  buckets=(32, 64, 128), max_context=160,
                                  name="gpu_qos")
        before = counters.get(LAUNCHES)
        got, inter = _preempt_on(engine, prompt_b, prompt_i, mode)
        launches = counters.get(LAUNCHES) - before
    finally:
        root.common.serving.qos = False
    assert got == sampling.generate(model, prompt_b, 24,
                                    temperature=0.8 if mode == "sample"
                                    else 0.0, seed=99)
    assert inter == sampling.generate(model, prompt_i, 4, temperature=0)
    # 2 blocks x (the batch, the interactive and the resumed prefill)
    assert launches == 2 * 3
    assert engine.page_pool.in_use() == 0


@pytest.mark.parametrize("mode", ["greedy", "sample"])
def test_preempt_resume_on_the_lane_is_bit_identical_on_the_card(cuda,
                                                                  mode):
    """The same on the O(1)-state lane: the resumed row's state, rebuilt
    by scanning prompt + emitted tokens at 8 rows, gives the solo
    decode's tokens on the card."""
    from veles_tpu_torch.serving import RecurrentEngine, generate_recurrent
    model = _recurrent_lm("lstm", cuda)
    rng = numpy.random.RandomState(22)
    prompt_b = rng.randint(1, 64, 19).tolist()
    prompt_i = rng.randint(1, 64, 9).tolist()
    root.common.serving.qos = True
    try:
        engine = RecurrentEngine(model, max_slots=1, max_context=160,
                                 page_size=8, name="gpu_o1_qos")
        got, _inter = _preempt_on(engine, prompt_b, prompt_i, mode)
    finally:
        root.common.serving.qos = False
    assert got == generate_recurrent(
        model, prompt_b, 24, temperature=0.8 if mode == "sample" else 0.0,
        seed=99, mode=mode)


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


def test_devtime_measure_attributes_flash_to_its_span(cuda):
    """``devtime.measure`` on the card: a torch.profiler capture
    (``source == "profiler"``, the clocks met at the anchor) whose one
    flash-forward kernel event lands in the span around its launch."""
    from veles_tpu_torch.telemetry import devtime
    from veles_tpu_torch.telemetry.spans import span
    q, k, v = qkv(cuda, 1, 512, 8, 8, 64, seed=5)
    fa.flash_attention_fwd(q, k, v, causal=True)      # build and warm
    torch.cuda.synchronize()

    def fn():
        with span("test.flash_fwd"):
            fa.flash_attention_fwd(q, k, v, causal=True)
            # the kernel runs inside the span's window only if the span
            # waits for it (spans themselves never synchronise)
            torch.cuda.synchronize()

    rec = devtime.measure(fn, device=cuda)
    assert rec["source"] == "profiler" and rec["clock"] == "anchor"
    assert rec["device_time_s"] > 0
    assert 0 <= rec["idle_share"] < 1
    flash = [r for name, r in rec["by_kernel"].items()
             if "flash_fwd_kernel" in name]
    assert sum(r["events"] for r in flash) == 1
    mine = rec["spans"]["test.flash_fwd"]
    assert mine["spans"] == 1 and mine["events"] >= 1
    assert mine["device_time_s"] >= sum(r["device_time_s"] for r in flash)


def test_devtime_capture_without_device_work_raises(cuda):
    """No fallback hides the device: a capture with no device event is
    an error on the card, not a host-time record."""
    from veles_tpu_torch.telemetry import devtime
    torch.cuda.synchronize()
    with pytest.raises(VelesError, match="no device event"):
        devtime.measure(lambda: None, sync=lambda: None, device=cuda)


CLI_TINY_MODEL = """
import numpy
from veles_tpu_torch.loader import FullBatchLoader
from veles_tpu_torch.nn.standard_workflow import StandardWorkflow


class L(FullBatchLoader):
    hide_from_registry = True

    def load_data(self):
        rng = numpy.random.RandomState(0)
        self.create_originals(rng.rand(120, 6).astype(numpy.float32),
                              rng.randint(0, 3, 120).astype(numpy.int32))
        self.class_lengths = [0, 24, 96]


def build_workflow():
    return StandardWorkflow(
        name="tiny", layers=[{"type": "softmax", "output_sample_shape": 3}],
        loader_unit=L(None, minibatch_size=24, name="l"),
        loss_function="softmax", decision_config=dict(max_epochs=2))
"""


def test_cli_auto_backend_initialises_on_the_card(cuda, tmp_path):
    """``python -m veles_tpu_torch MODEL --backend auto --dry-run``
    initialises on the card."""
    import os
    import subprocess
    import sys
    model = tmp_path / "tiny_model.py"
    model.write_text(CLI_TINY_MODEL)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch", str(model), "--backend",
         "auto", "--dry-run", "-v"], cwd=repo, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, PYTHONPATH=repo))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "initialized tiny on cuda:0" in r.stderr
    assert "dry run: initialize OK" in r.stderr


def test_cli_mnist_runs_the_fused_fc_kernel(cuda, tmp_path):
    """MNIST through the CLI with ``fused_fc_scan``: in 2-epoch blocks
    the kernel runs one launch per epoch, and the final weights, biases
    and momenta and the results equal, bit for bit, those of the same
    workflow built and run directly from the same seed, which is not the
    default ``root.common.random_seed``."""
    from chip_smoke import CLI_MNIST_MODEL, CLI_MNIST_SEED, mnist_trees
    from veles_tpu_torch import prng
    from veles_tpu_torch.__main__ import main
    from veles_tpu_torch.models import mnist
    assert CLI_MNIST_SEED != root.common.random_seed
    model = tmp_path / "mnist_model.py"
    model.write_text(CLI_MNIST_MODEL)
    res = tmp_path / "r.json"
    try:
        before = counters.get(FFC_LAUNCHES)
        assert main([str(model), "root.common.engine.fused_fc_scan=true",
                     "--random-seed", str(CLI_MNIST_SEED), "--result-file",
                     str(res)]) == 0
        launches = counters.get(FFC_LAUNCHES) - before
        prng.seed_all(CLI_MNIST_SEED)
        wf = mnist.build_workflow(epochs=4, epochs_per_dispatch=2)
        wf.initialize()
        wf.run()
    finally:
        root.common.engine.fused_fc_scan = False
        root.common.random_seed = 1234
    data = json.loads(res.read_text())
    assert launches == 4 and data["epochs"] == 4
    state, direct = torch.load(tmp_path / "mnist_state.pt"), mnist_trees(wf)
    assert state.keys() == direct.keys() and len(state) == 8
    assert all(torch.equal(state[k], direct[k]) for k in state)
    assert data["err_history"]["validation"] == wf.decision.epoch_metrics[1]


# -- the rest of the Znicz layer set (no hand-written kernel) -------------

ZNICZ_NAMES = ["lrn_n5_c95", "lrn_n3_c33", "lrn_n5_c3", "cutter_asym"]


@pytest.mark.parametrize("name", ZNICZ_NAMES)
def test_znicz_units_on_the_card_match_cpu(cuda, name):
    """LRN and the cutter, forward and the gradients of sum(y · g), on
    the card within 1e-4 · max(1, max|cpu|) of the CPU's."""
    from chip_smoke import TOL_ZNICZ, znicz_unit_cases
    i, (_, u, shape) = next((i, c) for i, c in enumerate(znicz_unit_cases())
                            if c[0] == name)
    x = numpy.random.RandomState(500 + i).randn(*shape).astype(
        "float32") * 3
    want = unit_outputs(u, x, {}, "cpu", 500 + i)
    assert conv_error(unit_outputs(u, x, {}, cuda, 500 + i),
                      want) <= TOL_ZNICZ


@pytest.mark.parametrize("solver,kw", [
    ("adagrad", {}), ("rmsprop", {}), ("adadelta", {}),
    ("sgd", {"gradient_clip": 0.5}), ("adam", {"gradient_clip_norm": 1.0})])
def test_solvers_on_the_card_match_cpu(cuda, solver, kw):
    from chip_smoke import TOL_ZNICZ, solver_updates
    assert conv_error(solver_updates(cuda, solver, kw, 7),
                      solver_updates("cpu", solver, kw, 7)) <= TOL_ZNICZ


def test_random_units_on_the_card(cuda):
    """Dropout keeps 0.7 of 10^6 elements within 0.002, each kept one
    x/keep, a seed gives its mask twice; stochastic pooling in
    evaluation is max pooling, and its training picks lie in their
    windows."""
    from veles_tpu_torch.nn import dropout, pooling
    drop = dropout.DropoutForward(None, dropout_ratio=0.3)
    x = torch.rand((1000, 1000), device=cuda) + 0.5
    gen = [torch.Generator(device=cuda).manual_seed(2) for _ in range(2)]
    y = drop.apply({}, x, train=True, generator=gen[0])
    assert torch.equal(y, drop.apply({}, x, train=True, generator=gen[1]))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) <= 0.002
    assert torch.equal(y[kept], x[kept] / 0.7)
    assert drop.apply({}, x) is x
    sp = pooling.StochasticPooling(None, kx=2, ky=2)
    xs = torch.randn((4, 9, 11, 8), device=cuda)
    assert torch.equal(sp.apply({}, xs), pooling.MaxPooling(
        None, kx=2, ky=2).apply({}, xs))
    ys = sp.apply({}, xs, train=True,
                  generator=torch.Generator(device=cuda).manual_seed(1))
    wins = sp._padded(xs, float("-inf")).unfold(2, 2, 2).unfold(3, 2, 2)
    wins = wins.reshape(wins.shape[:4] + (4,)).permute(0, 2, 3, 4, 1)
    assert bool((wins == ys[:, :, :, None, :]).any(dim=3).all())
    assert bool(torch.isfinite(ys).all())


def test_som_and_cd1_steps_on_the_card_match_cpu(cuda):
    from chip_smoke import TOL_ZNICZ
    from veles_tpu_torch.nn import kohonen, rbm
    rng = numpy.random.RandomState(3)
    w0 = rng.rand(64, 50).astype("float32")
    x = rng.rand(40, 50).astype("float32")
    grid = kohonen._grid_coords(8, 8)
    out = {}
    for dev in ("cpu", cuda):
        w, win, q = kohonen.som_step(*(torch.from_numpy(a).to(dev)
                                       for a in (w0, grid, x)), 0.3, 2.0)
        out[str(dev)] = ({"w": w.cpu(), "q": q.reshape(1).cpu()},
                         win.cpu())
    assert conv_error(out[str(cuda)][0], out["cpu"][0]) <= TOL_ZNICZ
    assert torch.equal(out[str(cuda)][1], out["cpu"][1])
    p = {"weights": rng.randn(50, 16).astype("float32") * 0.1,
         "vbias": numpy.zeros(50, "float32"),
         "hbias": numpy.zeros(16, "float32")}
    u = rng.rand(40, 16).astype("float32")
    res = {}
    for dev in ("cpu", cuda):
        new, err = rbm.cd1_step({k: torch.from_numpy(v).to(dev)
                                 for k, v in p.items()},
                                torch.from_numpy(x).to(dev),
                                torch.from_numpy(u).to(dev), 0.1)
        res[str(dev)] = {k: v.cpu() for k, v in
                         dict(new, err=err.reshape(1)).items()}
    assert conv_error(res[str(cuda)], res["cpu"]) <= TOL_ZNICZ


def test_small_alexnet_trains_on_the_card(cuda):
    """The CI AlexNet (32 px) through ``mcdnnic_topology`` with adam on
    the card: finite metrics, the loss falling, no hand-written kernel
    launched."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.models import alexnet
    prng.seed_all(5)
    wf = alexnet.build_workflow(epochs=2, n_train=640, n_valid=128)
    wf.initialize()
    assert wf.train_step.device.type == "cuda"
    counters.counters.reset()
    wf.run()
    losses = wf.decision.epoch_losses[2]
    assert all(numpy.isfinite(losses)) and losses[1] < losses[0]
    assert not any(v for k, v in counters.counters.snapshot().items()
                   if "launches" in k)


def test_kohonen_demo_on_the_card(cuda):
    from veles_tpu_torch import prng
    from veles_tpu_torch.models import kohonen_demo
    prng.seed_all(1234)
    wf = kohonen_demo.build_workflow(epochs=8, minibatch_size=100,
                                     n_train=600)
    wf.initialize()
    wf.run()
    res = wf.gather_results()
    assert wf.trainer.weights.devmem.device.type == "cuda"
    assert res["final_qerr"] < 0.25
    assert res["qerr_history"][-1] < res["qerr_history"][0]


def test_masked_chain_never_launches_the_fused_kernel(cuda):
    """A [tanh, softmax] MNIST chain with a ZeroFiller mask and
    ``fused_fc_scan`` on trains on the general path: the kernel's launch
    counter stays 0 and the mask holds."""
    from veles_tpu_torch.models import mnist
    from veles_tpu_torch.nn.zerofill import ZeroFiller
    root.common.engine.fused_fc_scan = True
    try:
        wf = mnist.build_workflow(epochs=2, epochs_per_dispatch=2)
        wf.initialize()
        assert wf.train_step._fused_fc is not None
        ZeroFiller(wf, target=wf.forwards[0], grouping=2).initialize()
        assert wf.train_step._fused_fc is None
        before = counters.get(FFC_LAUNCHES)
        wf.run()
        assert counters.get(FFC_LAUNCHES) == before
    finally:
        root.common.engine.fused_fc_scan = False
    w = wf.train_step.params["all2all_tanh0"]["weights"].cpu().numpy()
    assert (w[:392, 50:] == 0).all() and (w[392:, :50] == 0).all()


def test_conv_weight_gradient_is_float32_grade(cuda):
    """AlexNet's 5×5 conv of 48 → 128 channels over 109×109: the port's
    float32 weight gradient on the card within 1e-4 of the float64 one
    (max abs error over max|f64|), where cuDNN's lies ~1e-2 off."""
    from veles_tpu_torch.nn.conv import conv2d
    rng = numpy.random.RandomState(700)
    x = torch.from_numpy(rng.randn(4, 48, 109, 109)).to(cuda).contiguous(
        memory_format=torch.channels_last)
    w = torch.from_numpy(rng.randn(128, 48, 5, 5) / numpy.sqrt(1200)).to(
        cuda)
    gy = torch.from_numpy(rng.randn(4, 128, 105, 105)).to(cuda)
    want = torch.nn.grad.conv2d_weight(x, w.shape, gy)
    wf = w.float().requires_grad_(True)
    conv2d(x.float(), wf, (1, 1), (0, 0)).backward(gy.float())
    assert float((wf.grad.double() - want).abs().max()
                 / want.abs().max()) <= 1e-4


# -- the training library on the card (train_text, train_library) ---------

def _text_file(tmp_path, chars):
    import chip_smoke
    return chip_smoke.pydoc_corpus(str(tmp_path), chars)[0]


@pytest.mark.parametrize("dim,what", [(48, "d12"), (512, "d128")])
def test_text_lm_launches_the_flash_kernels(cuda, tmp_path, dim, what):
    """(a) A char transformer on real text (pydoc, 4 heads of 12 or of
    128) launches each flash kernel 2 blocks × the steps its epoch
    implies, and its losses are finite."""
    import chip_smoke
    path = _text_file(tmp_path, 20000 if dim == 48 else 60000)
    wf, launches, _, _ = chip_smoke.text_run(
        path, False, seed=11, epochs=1, minibatch_size=16, n_blocks=2,
        dim=dim, seq_len=32 if dim == 48 else 256)
    train, evals = chip_smoke.text_steps(wf)
    assert launches == {"fwd": 2 * (train + evals), "dkv": 2 * train,
                        "dq": 2 * train}
    assert all(numpy.isfinite(v) for v in wf.decision.epoch_losses[1])


def test_tensormon_on_equals_off_on_the_card(cuda, tmp_path):
    """(b) Tensormon on and off from one seed: the same parameters and
    optimiser state bit for bit, the same flash launches, the same
    synchronising calls; one sample on, none off."""
    import chip_smoke
    path = _text_file(tmp_path, 40000)
    runs = {}
    try:
        for on in (False, True):
            before = counters.get("veles_tensormon_samples_total")
            runs[on] = chip_smoke.text_run(
                path, on, seed=77, epochs=1, minibatch_size=8, n_blocks=1,
                dim=512, seq_len=128) + (
                counters.get("veles_tensormon_samples_total") - before,)
    finally:
        root.common.telemetry.tensormon.enabled = False
    (off, l_off, s_off, _, n_off), (on, l_on, s_on, _, n_on) = \
        runs[False], runs[True]
    for a, b in zip(chip_smoke.flat_tree(off.train_step.params)
                    + chip_smoke.flat_tree(off.train_step.opt_state),
                    chip_smoke.flat_tree(on.train_step.params)
                    + chip_smoke.flat_tree(on.train_step.opt_state)):
        assert torch.equal(a, b)
    assert l_off == l_on and s_off == s_on
    assert (n_off, n_on) == (0, 1)


def test_nan_sentinel_policies_on_the_card(cuda, tmp_path):
    """(c) warn counts and completes; halt raises with /readyz 503;
    snapshot_and_halt commits one verified snapshot and one black box."""
    import chip_smoke
    out = chip_smoke.library_sentinel(str(tmp_path))
    assert out["warn"]["nan_total"] > 0 and out["warn"]["epochs"] == 3
    assert out["halt"] == dict(raised=True, readyz=503, model_health=False)
    sh = out["snapshot_and_halt"]
    assert sh["raised"] and sh["snapshots"] == 1 and sh["verified"]
    assert sh["blackboxes"] == 1 and sh["nan_events"] >= 1
    assert sh["reason"].startswith("nan sentinel")


def _library_blobs(**kw):
    """A 784-feature blob load under MNIST's graph and knobs (the fused
    kernel's shapes), 1,000 train / 200 validation rows."""
    import chip_smoke
    from veles_tpu_torch.loader import FullBatchLoader

    def load_data(self):
        rng = numpy.random.RandomState(5)
        y = rng.randint(0, 10, 1200).astype(numpy.int32)
        x = (rng.randn(1200, 784) * 0.3).astype(numpy.float32)
        x[numpy.arange(1200), y * 70] += 2.0
        self.create_originals(x, y)
        self.class_lengths = [0, 200, 1000]
    loader = type("Blobs", (FullBatchLoader,), {
        "hide_from_registry": True, "load_data": load_data})(
        None, minibatch_size=100, name="mnist")
    return chip_smoke.mnist_library_workflow(loader=loader, **kw)


def test_tensormon_keeps_the_general_path_on_the_card(cuda):
    """(d) With tensormon on the fused-FC kernel is refused and never
    launched; the general path's epochs are finite."""
    root.common.telemetry.tensormon.enabled = True
    try:
        wf = _library_blobs()
        assert wf.train_step._fused_fc is None
        before = counters.get(FFC_LAUNCHES)
        wf.run()
        assert counters.get(FFC_LAUNCHES) == before
    finally:
        root.common.telemetry.tensormon.enabled = False
    assert all(numpy.isfinite(v) for v in wf.decision.epoch_metrics[1])


def test_lora_on_the_card_matches_the_cpu_and_freezes_the_base(cuda):
    """(e) LoRA rank 8 on both All2All layers: the first two steps on
    the card within 1e-4 relative of the CPU's; two epochs keep the base
    bit for bit and move the adapters, with no fused-FC launch."""
    import chip_smoke
    card = _library_blobs(lora_rank=8)
    cpu = _library_blobs(lora_rank=8, device="cpu")
    got, want = (list(chip_smoke.train_steps(w, 2)) for w in (card, cpu))
    for (lc, oc), (lh, oh) in zip(got, want):
        assert abs(float(lc) - float(lh)) <= 1e-4 * abs(float(lh))
        assert chip_smoke.tree_max_rel(oc, oh) <= 1e-4
    base = {n: {k: p[k].clone() for k in ("weights", "bias")}
            for n, p in card.train_step.params.items()}
    before = counters.get(FFC_LAUNCHES)
    card.run()
    assert counters.get(FFC_LAUNCHES) == before
    for n, p in card.train_step.params.items():
        assert all(torch.equal(p[k], base[n][k]) for k in base[n])
        assert float(p["weights_lora_b"].abs().max()) > 0


def test_smoothing_and_confusion_on_the_card(cuda):
    """(f) Label smoothing 0.1 with the confusion matrix: the first two
    SGD steps within 1e-4 relative of the CPU's; each set's matrix sums
    to n_samples and its off-diagonal to n_err."""
    import chip_smoke
    cfg = dict(label_smoothing=0.1, compute_confusion=True)
    card = _library_blobs(evaluator_config=cfg)
    cpu = _library_blobs(evaluator_config=cfg, device="cpu")
    lc, _ = chip_smoke.first_train_steps(card, 2)
    lh, _ = chip_smoke.first_train_steps(cpu, 2)
    assert all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(lc, lh))
    card.run()
    for s in (1, 2):
        cms = card.decision.epoch_confusion[s]
        assert len(cms) == 2
        for cm, (n, err) in zip(cms, card.decision.epoch_counts[s]):
            assert cm.sum() == n and cm.sum() - numpy.trace(cm) == err


def test_fused_epilogue_is_bit_identical_on_the_card(cuda):
    """(g) ``engine.fused_epilogue`` on against off on a chain with
    standalone activation layers: the same weights and metrics."""
    layers = [{"type": "all2all", "output_sample_shape": 100,
               "learning_rate": 0.03},
              {"type": "activation_mul", "factor": 0.6666},
              {"type": "activation_tanh"},
              {"type": "softmax", "output_sample_shape": 10,
               "learning_rate": 0.03}]
    runs = []
    for on in (False, True):
        root.common.engine.fused_epilogue = on
        try:
            wf = _library_blobs(layers=layers, fused=False, per_dispatch=1)
            assert bool(wf.train_step._epilogue) == on
            wf.run()
        finally:
            root.common.engine.fused_epilogue = False
        runs.append(wf)
    off, on = runs
    for n in off.train_step.params:
        for k in off.train_step.params[n]:
            assert torch.equal(off.train_step.params[n][k],
                               on.train_step.params[n][k])
    assert off.decision.epoch_metrics == on.decision.epoch_metrics


def test_minibatch_file_replay_trains_the_same_bits(cuda, tmp_path):
    """(h) The rows written through MinibatchesSaver (served in order)
    and replayed by MinibatchesLoader train 2 fused-FC epochs (2
    launches) to the in-memory run's weights bit for bit."""
    from veles_tpu_torch.loader import MinibatchesLoader, MinibatchesSaver
    ref = _library_blobs()
    src = ref.loader
    path = str(tmp_path / "b.vtmb")
    saver = MinibatchesSaver(None, file_name=path)
    plain = type(src)(None, minibatch_size=100, shuffle_limit=-1,
                      name="src")
    plain.initialize()
    saver.loader = plain
    saver.initialize()
    while True:
        plain.run()
        saver.run()
        if bool(plain.epoch_ended):
            break
    saver.stop()
    ref.run()
    import chip_smoke
    replay = chip_smoke.mnist_library_workflow(loader=MinibatchesLoader(
        None, file_name=path, minibatch_size=100, name="mnist"))
    before = counters.get(FFC_LAUNCHES)
    replay.run()
    assert counters.get(FFC_LAUNCHES) - before == 2
    for a, b in zip(chip_smoke.flat_tree(ref.train_step.params),
                    chip_smoke.flat_tree(replay.train_step.params)):
        assert torch.equal(a, b)


# -- the rest of the LM family on the card -----------------------------------

@pytest.mark.parametrize("n_kv,causal", [(4, False), (2, True)])
def test_mha_unit_runs_the_flash_kernels(cuda, n_kv, causal):
    """The multi-head attention unit on the card: one forward launch and
    one dK/dV and one dQ launch a call; forward and gradients within
    1e-4 · max(1, max|cpu|) of the CPU's."""
    from veles_tpu_torch.memory import Array
    from veles_tpu_torch.nn.attention import MultiHeadAttention
    x = numpy.random.RandomState(3).randn(4, 96, 64).astype("float32")
    u = MultiHeadAttention(None, n_heads=4, n_kv_heads=n_kv,
                           causal=causal, name="mha")
    u.input = Array(x)
    u.initialize(device=cuda)
    errs, launched = card_vs_cpu(u, x, 4)
    assert launched == {"fwd": 1, "dkv": 1, "dq": 1}
    assert max(errs.values()) <= TOL_LM_FAMILY, errs


def test_moe_routing_on_the_card_matches_the_cpu(cuda):
    """Top-2 MoE over 1,024 tokens: the routing masks equal the CPU's,
    forward and gradients within 1e-4 · max(1, max|cpu|)."""
    from veles_tpu_torch.memory import Array
    from veles_tpu_torch.nn.moe import MoEFFN
    x = numpy.random.RandomState(5).randn(8, 128, 64).astype("float32")
    u = MoEFFN(None, n_experts=4, hidden=128, top_k=2, name="moe")
    u.input = Array(x)
    u.initialize(device=cuda)
    host = {k: torch.from_numpy(numpy.array(v.map_read(), "float32"))
            for k, v in u.param_arrays().items()}
    flat = torch.from_numpy(x.reshape(-1, 64))
    with torch.no_grad():
        _, m_cpu = u.route(host, flat)
        _, m_card = u.route({k: v.to(cuda) for k, v in host.items()},
                            flat.to(cuda))
    assert torch.equal(m_card.cpu(), m_cpu)
    errs, _ = card_vs_cpu(u, x, 6)
    assert max(errs.values()) <= TOL_LM_FAMILY, errs


def test_state_cache_restores_the_cold_bits_on_the_card(cuda):
    """A warm admission (snapshot adopted, the suffix scanned) leaves
    the slot's state row with the cold scan's bits, and answers the
    cold tokens."""
    from veles_tpu_torch.serving import RecurrentEngine, make_request
    model = _recurrent_lm("lstm", cuda)
    prompt = [int(t) for t in numpy.random.RandomState(8).randint(
        0, 64, 45)]
    eng = RecurrentEngine(model, max_slots=2, max_context=80, page_size=8,
                          state_cache=True, name="gpu_sc").start()
    try:
        rows = []
        toks = []
        for _ in range(2):
            toks.append(eng.serve([make_request(prompt, 1)])[0])
            rows.append([{k: v[0].clone() for k, v in st.items()}
                         for st in eng._states])
        stats = eng.stats()
    finally:
        eng.stop()
    assert stats["state_restores"] == 1 and stats["state_cache_blocks"] == 5
    assert toks[0] == toks[1]
    for cold, warm in zip(*rows):
        for k in cold:
            assert torch.equal(cold[k], warm[k]), k


def _npy_class_tree(directory, classes=3, per_class=30, size=12, seed=0):
    """A class tree of uint8 ``.npy`` images (no Pillow on the card's
    machine), each class a distinct mean color."""
    rng = numpy.random.RandomState(seed)
    for c in range(classes):
        d = directory / ("c%d" % c)
        d.mkdir(parents=True)
        for i in range(per_class):
            img = numpy.clip(rng.rand(size, size, 3) * 0.3
                             + numpy.eye(3)[c % 3] * 0.7, 0, 1)
            numpy.save(str(d / ("%03d.npy" % i)),
                       numpy.round(img * 255).astype(numpy.uint8))
    return str(directory)


def _image_workflow(directory, layers, **kw):
    from veles_tpu_torch import prng
    from veles_tpu_torch.loader import ClassImageLoader
    from veles_tpu_torch.nn.standard_workflow import StandardWorkflow
    prng.seed_all(3)
    loader = ClassImageLoader(None, root_dir=directory, valid_ratio=0.25,
                              minibatch_size=16, name="gpu_images", **kw)
    wf = StandardWorkflow(
        name="gpu-images", layers=layers, loader_unit=loader,
        loss_function="softmax",
        decision_config=dict(max_epochs=2, fail_iterations=99))
    wf.initialize()
    return wf


FC_LAYERS = [{"type": "all2all_tanh", "output_sample_shape": 16},
             {"type": "softmax", "output_sample_shape": 3}]


def test_device_augmentation_semantics_on_the_card(cuda, tmp_path):
    """Mirror + 8x8 crop in the train step on the card: each row of a
    step's draw a window of its source or of its mirror, about half of
    600 rows mirrored, one key one draw, the evaluation crop exact; the
    workflow trains on the 8x8 minibatch."""
    from chip_smoke import window_hits
    wf = _image_workflow(_npy_class_tree(tmp_path), FC_LAYERS, mirror=True,
                         crop=(8, 8), device_augmentation=True)
    step = wf.train_step
    dataset, _ = step._dataset()
    assert dataset.device.type == "cuda"
    src = dataset.repeat(10, 1, 1, 1)[:600]
    out = step._augmented(src, 0)
    assert out.shape == (600, 8, 8, 3) and out.device.type == "cuda"
    hits = window_hits(src, out, (8, 8))
    assert bool(hits.any(1).all())
    share = float((hits[:, 1] & ~hits[:, 0]).float().mean())
    assert 0.4 <= share <= 0.6, share
    assert torch.equal(out, step._augmented(src, 0))
    assert not torch.equal(out, step._augmented(src, 1))
    assert torch.equal(wf.loader.device_eval_fn(src), src[:, 2:10, 2:10])
    assert wf.loader.minibatch_data.shape[1:] == (8, 8, 3)
    wf.run()
    assert all(numpy.isfinite(wf.decision.epoch_losses[2]))


def test_fused_gate_refuses_device_augmentation_on_the_card(cuda,
                                                            tmp_path,
                                                            caplog):
    """An FC chain on a device-augmenting loader with ``fused_fc_scan``
    on keeps the general path, with the reference's reason, and never
    launches the fused-FC kernel."""
    import logging
    root.common.engine.fused_fc_scan = True
    try:
        with caplog.at_level(logging.INFO):
            wf = _image_workflow(_npy_class_tree(tmp_path), FC_LAYERS,
                                 mirror=True, crop=(8, 8),
                                 device_augmentation=True)
        before = counters.get(FFC_LAUNCHES)
        wf.run()
    finally:
        root.common.engine.fused_fc_scan = False
    assert wf.train_step._fused_fc is None
    assert counters.get(FFC_LAUNCHES) == before
    assert any(r.getMessage().endswith("device-side augmentation not fused")
               for r in caplog.records)


def test_restful_api_round_trip_on_the_card(cuda):
    """``docs/examples.md`` §5's serving workflow on the card: 24
    concurrent POSTs, each answered within 1e-5 of the forward of its
    row alone, in fewer dispatches than requests; a bad shape 400, an
    unknown path 404, the close ending the workflow."""
    import threading
    from chip_smoke import (TOL_REST, http_status, record_dispatches,
                            rest_load, rest_workflow)
    layers = [{"type": "all2all_tanh", "output_sample_shape": 32},
              {"type": "softmax", "output_sample_shape": 5}]
    rng = numpy.random.RandomState(4)
    tree = {"all2all_tanh0": {"weights": rng.randn(12, 32) * 0.3,
                              "bias": rng.randn(32) * 0.1},
            "softmax1": {"weights": rng.randn(32, 5) * 0.3,
                         "bias": rng.randn(5) * 0.1}}
    wf, loader, fwds, api = rest_workflow(
        layers, tree, "RestfulLoader", sample_shape=(12,),
        minibatch_size=8, timeout=60.0)
    assert all(f.device.type == "cuda" for f in fwds)
    dispatches = record_dispatches(loader)
    thread = threading.Thread(target=wf.run, daemon=True)
    thread.start()
    url = "http://127.0.0.1:%d" % api.port
    xs = rng.rand(24, 12).astype(numpy.float32)
    try:
        answers, _ = rest_load(url + "/api", [{"input": x.tolist()}
                                              for x in xs], 24)
        assert [a[0] for a in answers] == [200] * 24
        assert len(dispatches) < 24 and max(dispatches) <= 8
        with torch.no_grad():
            for x, a in zip(xs, answers):
                y = torch.from_numpy(x[None]).to(cuda)
                for f in fwds:
                    y = f.apply({k: v.device_view(cuda) for k, v in
                                 f.param_arrays().items()}, y)
                err = numpy.abs(numpy.asarray(a[1]["result"])
                                - y[0].cpu().numpy()).max()
                assert err <= TOL_REST, err
        assert http_status(url + "/api", {"input": [0.0] * 3})[0] == 400
        assert http_status(url + "/nope", {"input": []})[0] == 404
        assert "veles_rest_requests_served 24" in http_status(
            url + "/metrics")[2]
    finally:
        loader.close()
        thread.join(timeout=30)
        api.stop()
    assert not thread.is_alive()


# -- int8 serving ---------------------------------------------------------------

def test_int8_quantizer_bits_on_the_card_equal_the_cpu(cuda):
    """Weights (both granularities, float32 and bf16 sources, an all-zero
    column, huge and tiny columns, a NaN and an infinity) and K/V rows:
    the card's int8 values and scales equal the CPU's bit for bit (a
    true division, round-half-to-even, NaN → 0 before the cast)."""
    from veles_tpu_torch.ops import precision
    rng = numpy.random.RandomState(8)
    w = rng.randn(512, 2048).astype("float32")
    w[:, 0] = 0
    w[:, 1] *= 3e4
    w[:, 2] *= 1e-30
    w[5, 3], w[6, 4] = numpy.nan, numpy.inf
    for dtype in (torch.float32, torch.bfloat16):
        src = torch.from_numpy(w).to(dtype)
        for axis in (-1, None):
            q, s = precision.quantize_int8(src.to(cuda), axis=axis)
            q_cpu, s_cpu = precision.quantize_int8(src, axis=axis)
            assert torch.equal(q.cpu(), q_cpu)
            assert s.cpu().numpy().tobytes() == s_cpu.numpy().tobytes()
            # the infinity's column dequantizes to 0 · inf = NaN, whose
            # bits the two devices may spell differently
            got = precision.dequantize_int8(q, s).cpu()
            want = precision.dequantize_int8(q_cpu, s_cpu)
            assert torch.equal(torch.isnan(got), torch.isnan(want))
            assert torch.equal(got.nan_to_num(), want.nan_to_num())
    x = torch.from_numpy(rng.randn(3, 300, 8, 64).astype("float32"))
    q, s = precision.quantize_rows_int8(x.to(cuda))
    q_cpu, s_cpu = precision.quantize_rows_int8(x)
    assert torch.equal(q.cpu(), q_cpu)
    assert s.cpu().numpy().tobytes() == s_cpu.numpy().tobytes()


def test_int8_engines_on_the_card(model, cuda):
    """The int8-weights engine's tokens, greedy and sampled, equal the
    float engine serving ``dequantize_params(quantize_params(...))`` bit
    for bit; on the int8 KV pool every prefill is 2 flash launches, the
    pool's scales are the CPU quantizer's of the float prefill rows, and
    concurrent tokens equal solo ones."""
    from veles_tpu_torch import quant
    from veles_tpu_torch.serving import ContinuousEngine
    reqs = _engine_requests(12, 8)
    q, _ = quant.quantize_params(sampling.params_of(model))
    twin = build_forwards(LAYERS, device=cuda)
    params_from_jax(twin, {u: {k: v.cpu().numpy() for k, v in t.items()}
                           for u, t in quant.dequantize_params(q).items()})
    geometry = dict(max_slots=4, buckets=(32, 64, 128), max_context=160)
    out = {}
    for name, stack, kw in (("twin", twin, {}),
                            ("qw", model, {"quant_weights": True}),
                            ("qkv", model, {"quant_kv": True})):
        engine = ContinuousEngine(stack, name="gpu_" + name, **geometry,
                                  **kw).start()
        try:
            before = counters.counters.snapshot()
            out[name] = engine.serve(reqs)
            delta = counters.counters.delta(before)
            if name == "qkv":
                assert [engine.serve([r])[0] for r in reqs] == out[name]
                assert engine.stats()["kv_pool_bytes"] == 2 * 2 * (
                    engine.page_pool.device_rows * engine.page_size
                    * (1 * 64 + 4))
            assert delta[LAUNCHES] == 2 * len(reqs)
            assert engine.page_pool.in_use() == 0
        finally:
            engine.stop()
    assert out["qw"] == out["twin"]
    # the int8 pool's prefill rows: the CPU quantizer of the card's float
    # K rows of block 0 (1 kv head of 64)
    from veles_tpu_torch.nn.sampling import (_embed_prompt, _prefill_blocks,
                                             split_stack)
    stack = split_stack(model)
    ids = torch.as_tensor([reqs[0]["prompt"]], device=cuda)
    with torch.inference_mode():
        x = _embed_prompt(stack["stem"], stack["pos_emb"], ids)
        _, caches = _prefill_blocks(stack["blocks"], x, ids.shape[1])
    k = caches[0][0][0]
    qk, sk = quant.quantize_rows_int8(k)
    qk_cpu, sk_cpu = quant.quantize_rows_int8(k.cpu())
    assert torch.equal(qk.cpu(), qk_cpu) and torch.equal(sk.cpu(), sk_cpu)


def test_registered_op_equals_the_launch(cuda):
    """``torch.ops.veles_tpu_torch.flash_attention_fwd`` gives the launch's
    o and lse bit for bit and counts one launch a call, called directly,
    through ``attention_core`` without a gradient, and as the one node of
    an exported program."""
    from veles_tpu_torch.nn.attention import attention_core
    q, k, v = qkv(cuda, 2, 200, 8, 2, 64, seed=5)
    scale = 1.0 / 8.0
    want_o, want_lse = fa._launch(q, k, v, True, 0, scale)
    before = counters.get(LAUNCHES)
    o, lse = torch.ops.veles_tpu_torch.flash_attention_fwd(q, k, v, True, 0,
                                                          scale)
    torch.cuda.synchronize()
    assert counters.get(LAUNCHES) == before + 1
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    with torch.no_grad():
        assert torch.equal(attention_core(q, k, v, causal=True), want_o)

    class Attend(torch.nn.Module):
        def forward(self, q, k, v):
            return attention_core(q, k, v, causal=True)

    with torch.no_grad():
        program = torch.export.export(Attend(), (q, k, v))
    nodes = [n for n in program.graph.nodes if n.op == "call_function"
             and "flash_attention_fwd" in str(n.target)]
    assert len(nodes) == 1
    before = counters.get(LAUNCHES)
    got = program.module()(q, k, v)
    torch.cuda.synchronize()
    assert counters.get(LAUNCHES) == before + 1
    assert torch.equal(got, want_o)


def test_exported_serve_programs_equal_the_live_engine(model, cuda,
                                                       tmp_path):
    """A serve artifact exported on the card (2 blocks, GQA 2/1, a window
    of 50): its engine's greedy and sampled tokens equal the live
    engine's, every prefill through its program with one flash launch a
    block, and a CPU artifact falls back counted."""
    from veles_tpu_torch.export.serve_artifact import export_serve_artifact
    from veles_tpu_torch.serving import ContinuousEngine
    geometry = dict(max_slots=4, buckets=(32, 128), max_context=160,
                    page_size=16)
    path = export_serve_artifact(model, str(tmp_path / "art"), **geometry)
    reqs = _engine_requests(31, 8)
    out = {}
    for name, art in (("live", None), ("artifact", path)):
        engine = ContinuousEngine(model, name="gpu_art_" + name,
                                  artifact=art, **geometry).start()
        try:
            before = counters.counters.snapshot()
            out[name] = engine.serve(reqs)
            delta = counters.counters.delta(before)
            st = engine.stats()
            assert st["artifact_mode"] == (art is not None)
            assert delta[LAUNCHES] == 2 * len(reqs)
            assert st["pages_in_use"] == 0
        finally:
            engine.stop()
    assert out["artifact"] == out["live"]
    cpu_model = build_forwards(LAYERS, device="cpu")
    params_from_jax(cpu_model, random_params(cpu_model, seed=4))
    cpu_path = export_serve_artifact(cpu_model, str(tmp_path / "cpu"),
                                     device="cpu", **geometry)
    before = counters.get("veles_artifact_load_failures_total")
    engine = ContinuousEngine(model, name="gpu_art_cpu", artifact=cpu_path,
                              **geometry).start()
    try:
        assert engine.serve(reqs[:2]) == out["live"][:2]
        assert not engine.artifact_mode
    finally:
        engine.stop()
    assert counters.get("veles_artifact_load_failures_total") == before + 1


def test_native_runtime_on_the_card_machine(cuda, tmp_path):
    """The runtime builds from the checkout on the card's machine and runs
    a package exported from the card: within rtol 2e-3, atol 2e-4 of
    ``run_package`` on the card."""
    from veles_tpu_torch.export import native, package_export, run_package
    from veles_tpu_torch.export.native import NativeModel
    from veles_tpu_torch.memory import Array
    from veles_tpu_torch.nn.all2all import All2AllSoftmax, All2AllTanh
    from veles_tpu_torch.workflow import Workflow
    assert native.build_library().startswith(native.NATIVE_BUILD_DIR)
    wf = Workflow(name="native_gpu")
    x = numpy.random.RandomState(3).rand(16, 64).astype(numpy.float32)
    fc = All2AllTanh(wf, output_sample_shape=32, name="fc")
    head = All2AllSoftmax(wf, output_sample_shape=10, name="head")
    fc.input = Array(x)
    fc.initialize(device=cuda)
    head.input = Array(numpy.zeros((16, 32), numpy.float32))
    head.initialize(device=cuda)
    wf.forwards = [fc, head]
    path = package_export(wf, str(tmp_path / "pkg"), input_shape=[16, 64])
    want = run_package(path, x)
    model = NativeModel(path)
    try:
        numpy.testing.assert_allclose(model(x), want, rtol=2e-3, atol=2e-4)
    finally:
        model.close()


def _card_world(tmp_path, scenario):
    """``scenario`` of tests/torch_dist_child.py in two processes sharing
    the card (gloo, collectives staged through host buffers)."""
    import socket
    import subprocess
    import sys
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.dirname(here))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(here, "torch_dist_child.py"), str(r),
         "2", str(port), str(tmp_path), scenario],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    return [dict(numpy.load(os.path.join(str(tmp_path), "%s_%d.npz"
                                         % (scenario, r))))
            for r in range(2)]


@pytest.mark.parametrize("axis,heads", [("tensor", 2), ("fsdp", 4)])
def test_parameter_axis_step_matches_one_process(cuda, tmp_path, axis,
                                                 heads):
    """The test-width LM under tensor=2 (head-parallel: 2 of its 4 heads
    a rank) and fsdp=2 (gathered at use) on the card against one process
    on the card: NLL/token within 1e-4 relative, weights within 1e-3
    (99.9 % within 1e-5), both ranks' gathered weights identical, every
    flash forward of a rank at ``heads`` heads."""
    import torch_dist_child as child
    name = {"tensor": "card_tp", "fsdp": "card_fsdp"}[axis]
    ranks = _card_world(tmp_path, name)
    wf = child.lm_workflow()
    wf.initialize()
    wf.run()
    want = child.result(wf)
    steps = (16 // 4) * 2, (8 // 4) * 2          # two epochs
    for rank in ranks:
        assert rank["launches"].tolist() == [2 * sum(steps), 2 * steps[0],
                                             2 * steps[0]]
        assert rank["heads"].tolist() == [[heads, 2 * sum(steps)]]
        for key in ("train_loss", "valid_loss"):
            numpy.testing.assert_allclose(rank[key], want[key], rtol=1e-4)
    diff = numpy.sort(numpy.concatenate([
        numpy.abs(ranks[0][k] - want[k]).ravel()
        for k in want if k.startswith("p_")]))
    assert diff[-1] <= 1e-3 and diff[int(0.999 * (diff.size - 1))] <= 1e-5
    for k in want:
        if k.startswith("p_"):
            numpy.testing.assert_array_equal(ranks[1][k], ranks[0][k])


def test_pipeline_step_matches_one_process(cuda, tmp_path):
    """The test-width LM under pipeline=2 on the card (a block a rank, 2
    microbatches) against one process on the card: NLL/token within 1e-4
    relative, weights within 1e-3 (99.9 % within 1e-5), both ranks'
    gathered weights identical; a rank launches the flash forward for
    each microbatch of each train and validation step and the backward
    pair for each train microbatch, all at 4 heads."""
    import torch_dist_child as child
    ranks = _card_world(tmp_path, "card_pp")
    wf = child.lm_workflow()
    wf.initialize()
    wf.run()
    want = child.result(wf)
    steps = (16 // 4) * 2, (8 // 4) * 2          # two epochs
    for rank in ranks:
        assert rank["launches"].tolist() == [2 * sum(steps), 2 * steps[0],
                                             2 * steps[0]]
        assert rank["heads"].tolist() == [[4, 2 * sum(steps)]]
        for key in ("train_loss", "valid_loss"):
            numpy.testing.assert_allclose(rank[key], want[key], rtol=1e-4)
    diff = numpy.sort(numpy.concatenate([
        numpy.abs(ranks[0][k] - want[k]).ravel()
        for k in want if k.startswith("p_")]))
    assert diff[-1] <= 1e-3 and diff[int(0.999 * (diff.size - 1))] <= 1e-5
    for k in want:
        if k.startswith("p_"):
            numpy.testing.assert_array_equal(ranks[1][k], ranks[0][k])


def test_card_tensor_hops_with_its_bits(cuda, tmp_path):
    """``distributed.send_recv`` of a (64, 33) float32 card tensor from
    rank 0 to rank 1 and back, the ranks sharing the card under gloo: the
    same bits on the card, each send staged through pinned host memory
    and counted, each receive copied back."""
    for rank in _card_world(tmp_path, "card_hop"):
        assert int(rank["equal"]) == 1
        assert str(rank["device"]).startswith("cuda")
        assert str(rank["backend"]) == "gloo"
        assert int(rank["hopped"]) == 64 * 33 * 4
        assert int(rank["staged_calls"]) == 1
        assert int(rank["staged_bytes"]) == 2 * 64 * 33 * 4


def test_ring_two_ranks_match_one_process_flash(cuda, tmp_path):
    """The ring over two processes sharing the card, B2 T1024 H4 D64
    causal: two forward launches and two backward pairs a rank, o and
    the gradients within 1e-4 · max(1, max|ref|) of one-process
    ``flash_attention`` on the whole sequence."""
    for rank in _card_world(tmp_path, "card_ring"):
        assert rank["launches"].tolist() == [2, 2, 2]
        assert rank["err"].max() <= 1e-4, rank["err"]
        assert int(rank["staged"]) > 0


def test_data_parallel_step_matches_one_process(cuda, tmp_path):
    """The test-width LM over data=2 on the card against one process on
    the card: NLL/token within 1e-4 relative, weights within 1e-3 (99.9 %
    within 1e-5), both ranks' weights identical, one flash forward a
    block for each train and validation step and one backward pair a
    block for each train step."""
    import torch_dist_child as child
    ranks = _card_world(tmp_path, "card_dp")
    wf = child.lm_workflow()
    wf.initialize()
    wf.run()
    want = child.result(wf)
    steps = (16 // 4) * 2, (8 // 4) * 2          # two epochs
    for rank in ranks:
        assert rank["launches"].tolist() == [2 * sum(steps), 2 * steps[0],
                                             2 * steps[0]]
        for key in ("train_loss", "valid_loss"):
            numpy.testing.assert_allclose(rank[key], want[key], rtol=1e-4)
    diff = numpy.sort(numpy.concatenate([
        numpy.abs(ranks[0][k] - want[k]).ravel()
        for k in want if k.startswith("p_")]))
    assert diff[-1] <= 1e-3 and diff[int(0.999 * (diff.size - 1))] <= 1e-5
    for k in want:
        if k.startswith("p_"):
            numpy.testing.assert_array_equal(ranks[1][k], ranks[0][k])


def test_blocked_linalg_on_the_card_without_tf32(cuda):
    """The blocked family on the card at 2048, TF32 off (``device_for``'s
    policy): the 1×1 SUMMA product, the one-card panel loop and the
    Cholesky solve within 100·eps(float32) ≈ 1.19e-5 of float64 numpy, a
    matrix that is not positive definite refused through
    ``cholesky_ex``'s info, and float64 kept as float64."""
    from veles_tpu_torch.linalg import (LinalgError, blocked_cholesky,
                                        blocked_matmul, cholesky_solve,
                                        default_tolerance, linalg_mesh)
    assert not torch.backends.cuda.matmul.allow_tf32
    tol = default_tolerance(numpy.float32)
    rng = numpy.random.RandomState(0)
    a = rng.standard_normal((2048, 2048)).astype(numpy.float32)
    b = rng.standard_normal((2048, 2048)).astype(numpy.float32)
    ref = a.astype(numpy.float64) @ b.astype(numpy.float64)
    for mesh in (linalg_mesh(), None):
        c = blocked_matmul(a, b, mesh=mesh, device=cuda)
        assert c.device.type == "cuda"
        c = c.cpu().numpy()
        assert numpy.linalg.norm(c - ref) / numpy.linalg.norm(ref) < tol
    g = rng.standard_normal((2048, 2048)).astype(numpy.float32)
    spd = g @ g.T + 2048 * numpy.eye(2048, dtype=numpy.float32)
    rhs = rng.standard_normal((2048, 1)).astype(numpy.float32)
    x = cholesky_solve(spd, rhs, mesh=linalg_mesh(), device=cuda)
    x = x.cpu().numpy()
    want = numpy.linalg.solve(spd.astype(numpy.float64),
                              rhs.astype(numpy.float64))
    assert numpy.linalg.norm(x - want) / numpy.linalg.norm(want) < tol
    bad = numpy.eye(256, dtype=numpy.float32)
    bad[130, 130] = -1.0
    with pytest.raises(LinalgError, match="not positive definite"):
        blocked_cholesky(bad, device=cuda)
    a64 = rng.standard_normal((256, 256))
    c64 = blocked_matmul(a64, a64, mesh=linalg_mesh(), device=cuda)
    assert c64.dtype == torch.float64
    ref64 = a64 @ a64
    assert numpy.linalg.norm(c64.cpu().numpy() - ref64) \
        / numpy.linalg.norm(ref64) < default_tolerance(numpy.float64)


def test_trial_placement_on_the_card(cuda, tmp_path):
    """``mesh_slice_placement(1, total_devices=1)``: a trial sees exactly
    the one card and resolves it; a second slot raises before any trial
    runs; ``cpu_placement`` hides the card."""
    import json
    import sys
    from veles_tpu_torch.parallel.trials import (Trial, TrialScheduler,
                                                 cpu_placement,
                                                 mesh_slice_placement)
    child = ("import json, sys, torch\n"
             "sys.path.insert(0, %r)\n"
             "from veles_tpu_torch.backends import device_for_backend\n"
             "d = device_for_backend(None)\n"
             "json.dump({'n': torch.cuda.device_count(), 'device': str(d)},"
             " open(sys.argv[1], 'w'))\n"
             % os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    out = tmp_path / "t.json"
    res = TrialScheduler(n_workers=1, placement=mesh_slice_placement(
        1, total_devices=1)).run([Trial([sys.executable, "-c", child,
                                         str(out)])])
    assert res[0].ok, res[0].stderr_tail
    assert json.load(open(out)) == {"n": 1, "device": "cuda:0"}
    with pytest.raises(ValueError):
        TrialScheduler(n_workers=2, placement=mesh_slice_placement(
            1, total_devices=1)).run([Trial([sys.executable, "-c", "pass"])
                                      for _ in range(2)])
    res = TrialScheduler(n_workers=1, placement=cpu_placement).run(
        [Trial([sys.executable, "-c", child, str(out)])])
    assert res[0].ok, res[0].stderr_tail
    assert json.load(open(out)) == {"n": 0, "device": "cpu"}

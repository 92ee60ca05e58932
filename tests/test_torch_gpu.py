"""Tests of the PyTorch port that need the CUDA card: the hand-written
flash-attention kernel against its plain torch version, its build for
``sm_90a``, and the serving path through it. Each skips without a card
(decided inside the fixture, never at import).

This file imports torch and the port only — the card's machine has no
JAX, and ``tests/conftest.py`` imports it — so run it there with

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py

Tolerance: max abs error <= 1e-4 for kernel vs plain in float32 (only
the summation order differs)."""
import json
import urllib.request

import numpy
import pytest
import torch

from veles_tpu_torch.config import root
from veles_tpu_torch.convert import params_from_jax, random_params
from veles_tpu_torch.nn import sampling
from veles_tpu_torch.nn.standard_workflow import build_forwards
from veles_tpu_torch.ops import flash_attention as fa
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
    (1, 1, 2, 2, 48, True, 0)])
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


def test_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = qkv(cuda, 1, 16, 2, 2, 32, seed=0)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q.bfloat16(), k.bfloat16(), v.bfloat16())
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

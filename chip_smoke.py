#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``veles_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (``{"phase": ...}``):

1. device  — fail unless ``torch.cuda.is_available()``; the card's name
             and power limit as ``nvidia-smi`` reports them;
2. build   — compile every kernel of the serving path from
             ``veles_tpu_torch/csrc`` with ``nvcc`` and print the
             compiler's register / shared-memory / spill report;
3. kernels — each kernel's wrapper on card tensors against its plain
             torch version at the serving path's shapes and at the edge
             cases (GQA, window, ragged T, head dims, non-causal);
             max abs error of o and lse must be <= 1e-4 (float32, only
             the summation order differs);
4. timing  — kernel, plain version and the PyTorch library call
             (``scaled_dot_product_attention``, timed as a yardstick and
             never called by the port) with CUDA events, beside the
             bound the published peaks give;
5. serve   — the bench-width LM (6 RoPE blocks, d_model 512, 8 heads,
             FFN 2048, vocab 256, random weights from a numpy seed in the
             reference's layout) behind ``GenerationAPI`` on the card,
             8 concurrent HTTP requests; checks the answers, that the
             greedy tokens equal the plain-attention path's, that the
             prefill logits agree within 1e-3, and that every prefill
             block launched the flash kernel.

Then the kernels line (``{"kernels": [...]}``) and, last, the device
line ``{"ok": true, "device": {...}}``. Any failure raises and the run
exits non-zero without the last line; without a card it exits 1 at once.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))

#: published peaks of one H100 SXM (NVIDIA data sheet, dense): float32
#: on the CUDA cores and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

TOL_KERNEL = 1e-4
TOL_LOGITS = 1e-3
N_NEW = 32

BENCH_LAYERS = (
    [{"type": "embedding", "vocab_size": 256, "dim": 512}]
    + [{"type": "transformer_block", "n_heads": 8, "ffn_hidden": 2048,
        "causal": True, "rope": True, "name": "blk%d" % i}
       for i in range(6)]
    + [{"type": "lm_head", "vocab_size": 256}])


def emit(phase, **fields):
    print(json.dumps(dict(phase=phase, **fields)), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters):
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls,
    after a warm-up, with CUDA events."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def qkv(b, t, h, kv, d, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((b, t, heads, d), generator=g, device="cuda")
            for heads in (h, kv, kv)]


def phase_kernels(fa):
    """Kernel vs plain on the card; returns the largest error."""
    import torch
    cases = [
        # (name, B, T, H, KV, D, causal, window)
        ("serve_b4_t512", 4, 512, 8, 8, 64, True, 0),
        ("serve_b2_t2048", 2, 2048, 8, 8, 64, True, 0),
        ("serve_b1_t300", 1, 300, 8, 8, 64, True, 0),
        ("gqa_kv2", 4, 512, 8, 2, 64, True, 0),
        ("window128", 4, 512, 8, 8, 64, True, 128),
        ("ragged_t300_noncausal", 2, 300, 8, 8, 64, False, 0),
        ("d32", 2, 512, 8, 8, 32, True, 0),
        ("d128", 2, 512, 8, 8, 128, True, 0),
        ("d256_gqa_window", 1, 333, 4, 2, 256, True, 100),
        ("noncausal", 4, 512, 8, 8, 64, False, 0),
    ]
    worst = 0.0
    for i, (name, b, t, h, kv, d, causal, window) in enumerate(cases):
        q, k, v = qkv(b, t, h, kv, d, seed=100 + i)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                        window=window)
        ro, rlse = fa.flash_attention_fwd_reference(
            q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err_o = float((o - ro).abs().max())
        err_lse = float((lse - rlse).abs().max())
        finite = bool(torch.isfinite(o).all() and torch.isfinite(lse).all())
        emit("kernels", kernel="flash_attention_fwd", case=name,
             shape=[b, t, h, kv, d], causal=causal, window=window,
             max_abs_err_o=err_o, max_abs_err_lse=err_lse, finite=finite)
        if not finite or max(err_o, err_lse) > TOL_KERNEL:
            raise AssertionError("flash_attention_fwd disagrees with its "
                                 "plain version on %s: o %g, lse %g"
                                 % (name, err_o, err_lse))
        worst = max(worst, err_o, err_lse)
    return worst


def phase_timing(fa):
    """Times at the serving shapes; returns the main shape's record."""
    import torch
    import torch.nn.functional as F
    records = []
    for b, t in ((4, 512), (2, 2048)):
        h = kv = 8
        d = 64
        q, k, v = qkv(b, t, h, kv, d, seed=7)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ms = cuda_time_ms(
            lambda: fa.flash_attention_fwd(q, k, v, causal=True), 50)
        plain_ms = cuda_time_ms(
            lambda: fa.flash_attention_fwd_reference(q, k, v, causal=True),
            10)
        library_ms = cuda_time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True), 50)
        flops, nbytes = fa.analytic_cost(b, t, h, d, causal=True, kv=kv)
        t_ops = flops / PEAK_F32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
        rec = dict(shape=[b, t, h, kv, d], causal=True, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   flops=flops, bytes=nbytes,
                   bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   achieved_tflops=flops / (ms * 1e-3) / 1e12)
        emit("timing", kernel="flash_attention_fwd", **rec)
        records.append(rec)
    return records[0]


def post(url, payload, timeout=600.0):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            body = json.loads(r.read())
            code = r.status
    except urllib.error.HTTPError as e:
        code, body = e.code, json.loads(e.read())
    return code, body, (time.perf_counter() - t0) * 1e3


def phase_serve(card):
    import numpy
    import torch
    from veles_tpu_torch.config import root
    from veles_tpu_torch.convert import params_from_jax, random_params
    from veles_tpu_torch.nn import sampling
    from veles_tpu_torch.nn.standard_workflow import build_forwards
    from veles_tpu_torch.restful_api import GenerationAPI
    from veles_tpu_torch.telemetry import counters

    model = build_forwards(BENCH_LAYERS)          # default device: card
    params_from_jax(model, random_params(model, seed=0))
    n_blocks = sum(1 for c in BENCH_LAYERS
                   if c["type"] == "transformer_block")
    rng = numpy.random.RandomState(1)

    def prompt(n):
        return [int(x) for x in rng.randint(0, 256, n)]

    requests = ([{"prompt": prompt(512), "n_new": N_NEW}
                 for _ in range(4)]
                + [{"prompt": prompt(2048), "n_new": N_NEW}
                   for _ in range(2)]
                + [{"prompt": prompt(300), "n_new": N_NEW},
                   {"prompt": prompt(512), "n_new": N_NEW,
                    "mode": "sample", "temperature": 0.8, "seed": 5}])
    # one-time CUDA/cuBLAS initialisation outside the measured run
    sampling.generate(model, requests[6]["prompt"][:64], 2, temperature=0)
    torch.cuda.synchronize()

    api = GenerationAPI(model, port=0, batch_window=0.5).initialize()
    try:
        url = "http://127.0.0.1:%d/generate" % api.port
        results = [None] * len(requests)

        def fire(i):
            results[i] = post(url, requests[i])

        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(len(requests))]
        batches0 = api.batches_run
        counters.counters.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = counters.get("veles_flash_attention_launches_total")
        prefills = api.batches_run - batches0
        peak_bytes = torch.cuda.max_memory_allocated()
    finally:
        api.stop()

    for i, res in enumerate(results):
        if res is None or res[0] != 200:
            raise AssertionError("request %d failed: %r" % (i, res))
        toks = res[1]["tokens"]
        if len(toks) != N_NEW or not all(0 <= t < 256 for t in toks):
            raise AssertionError("request %d: bad tokens %r" % (i, toks))
    if prefills < 1 or launches != n_blocks * prefills:
        raise AssertionError("flash launches %d != %d blocks x %d "
                             "prefills" % (launches, n_blocks, prefills))

    # the same greedy prompts through the plain attention on the card
    groups = {}
    for i, req in enumerate(requests):
        if req.get("mode", "greedy") == "greedy":
            groups.setdefault(len(req["prompt"]), []).append(i)
    logit_err = 0.0
    try:
        for length, idx in groups.items():
            flash_logits = sampling.prompt_logits(
                model, requests[idx[0]]["prompt"])
            root.common.engine.flash_attention = False
            plain = sampling.generate(
                model, [requests[i]["prompt"] for i in idx], N_NEW,
                temperature=0)
            plain_logits = sampling.prompt_logits(
                model, requests[idx[0]]["prompt"])
            root.common.engine.flash_attention = True
            if not numpy.isfinite(flash_logits).all():
                raise AssertionError("non-finite prefill logits")
            logit_err = max(logit_err, float(
                numpy.abs(flash_logits - plain_logits).max()))
            for row, i in zip(plain, idx):
                if results[i][1]["tokens"] != row:
                    raise AssertionError(
                        "request %d (T=%d): served greedy tokens differ "
                        "from the plain path" % (i, length))
    finally:
        root.common.engine.flash_attention = True
    if logit_err > TOL_LOGITS:
        raise AssertionError("prefill logits flash vs plain differ by %g"
                             % logit_err)
    lat = [res[2] for res in results]
    emit("serve", card=card, requests=len(requests), prefills=prefills,
         greedy_groups=[len(v) for v in groups.values()],
         flash_launches=launches, n_blocks=n_blocks,
         wall_s=wall, requests_per_s=len(requests) / wall,
         tokens_per_s=len(requests) * N_NEW / wall,
         request_ms=lat, prefill_logit_max_abs_err=logit_err,
         peak_memory_bytes=int(peak_bytes))
    phase_breakdown(card, model, [requests[i]["prompt"]
                                  for i in groups[512]])
    return launches


def host_ms(fn):
    """Host-clock time of ``fn()`` ending in a device synchronise."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_breakdown(card, model, prompts):
    """Where one batched greedy decode spends its time: prefill (the
    n_new=1 call) vs the per-step decode, and the device's busy share
    and top kernels from torch.profiler (null when the profiler sees
    no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from veles_tpu_torch.nn import sampling

    def run(n):
        return lambda: sampling.generate(model, prompts, n, temperature=0)

    prefill_ms = min(host_ms(run(1)) for _ in range(3))
    total_ms = min(host_ms(run(N_NEW)) for _ in range(3))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms = host_ms(run(N_NEW))
    kernels = [(getattr(e, "self_device_time_total", 0) / 1e3, e.key,
                e.count) for e in prof.key_averages()
               if getattr(e, "device_type", None) is not None
               and "CUDA" in str(e.device_type)]
    busy_ms = sum(k[0] for k in kernels)
    kernels.sort(reverse=True)
    emit("breakdown", card=card, batch=len(prompts),
         prompt_len=len(prompts[0]), n_new=N_NEW,
         prefill_ms=prefill_ms, decode_total_ms=total_ms,
         decode_step_ms=(total_ms - prefill_ms) / (N_NEW - 1),
         profiled_wall_ms=wall_ms,
         device_busy_ms=busy_ms if kernels else None,
         device_idle_share=(1 - busy_ms / wall_ms) if kernels else None,
         kernel_launches=sum(k[2] for k in kernels) if kernels else None,
         top_kernels=[{"name": k[1][:80], "ms": k[0], "calls": k[2]}
                      for k in kernels[:8]])


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from veles_tpu_torch.backends import device_for
    from veles_tpu_torch.ops import _build
    from veles_tpu_torch.ops import flash_attention as fa

    device_for("cuda")          # applies the f32 (no TF32) policy
    card = nvidia_smi()
    emit("device", card=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    _build.load("flash_attention_fwd")
    emit("build", source="veles_tpu_torch/csrc/flash_attention_fwd.cu",
         seconds=time.perf_counter() - t0,
         ptxas=_build.build_log("flash_attention_fwd").splitlines())

    worst = phase_kernels(fa)
    timing = phase_timing(fa)
    launches = phase_serve(card)

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "veles_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "veles_tpu/ops/flash_attention.py:77",
        "launches": launches, "max_abs_err": worst,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"], "ok": True}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

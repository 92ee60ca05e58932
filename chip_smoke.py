#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``veles_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (``{"phase": ...}``):

1. device  — fail unless ``torch.cuda.is_available()``; the card's name
             and power limit as ``nvidia-smi`` reports them;
2. build   — compile every kernel of ``veles_tpu_torch/csrc`` with
             ``nvcc``, one process per source, all started together, and
             print the compiler's register / shared-memory / spill report;
3. kernels — each kernel's wrapper on card tensors against its plain
             torch version at the main paths' shapes and at edge cases.
             flash_attention_fwd (3xTF32 on the tensor cores): 26 cases
             (the engine's B1 prefills at T 128, 1024, 2048, ragged T 1,
             65, 127, 129, D 8..256 including 33, 40, 72 and
             160, GQA 8/1 with a window, views offset by one element, B*H
             65,544) with max abs error of o and lse <= 1e-4 and one
             launch each, and a NaN in q, k or v (causal and not) landing
             exactly where the plain version's does. fused_fc_sgd
             (layer 0 split by input rows over a 16-CTA cluster, 3xTF32
             on the tensor cores; the column layout, at 16 or 8 CTAs,
             for the chains the rows layout cannot hold): 11 cases
             (MNIST 784-100-10 with a continuation launch, momentum and
             decay, mb 37 and 10, 784-256-64-10, 784-200-10, rows of 33
             floats, a one-step plan, a plan that repeats rows, a NaN in
             one dataset row), max abs
             error of w/b/vw/vb <= 1e-4 over the finite elements, NaN
             patterns equal, loss_sum relative error <= 1e-5, err_count
             exact (float32, the per-step sums run in another order);
             two launches on the same inputs, and every geometry the
             wrapper may choose, give the same bits;
4. timing  — kernel, plain version and the library yardstick with CUDA
             events, beside the bound the published peaks give. The
             flash forward at B4 T512, B16 T512, B2 T2048 and the
             engine's B1 T128 and B1 T2048 (H8 D64 causal) against
             SDPA, each record with ``bound_ms`` (float32 FMA),
             ``bound_tc_ms`` (3xTF32 on the tensor cores, the one the
             kernel runs against and the kernels line's ``bound_ms``)
             and ``pct_of_tc_bound``. The
             fused-FC MNIST epoch (K 600) at every geometry the wrapper
             may choose, µs a step, ``bound_ms`` (float32 FMA),
             ``bound_tc_ms`` (3xTF32, the kernels line's),
             ``cluster_ceiling_ms`` (3xTF32 at the cluster's SMs, from
             the published peaks); it has no single library call, so the
             port's general path (autograd, eager) times the same
             epoch; the kernel is held against the plain version at the
             12-step tolerances;
5. serve   — the bench-width LM (6 RoPE blocks, d_model 512, 8 heads,
             FFN 2048, vocab 256, random weights from a numpy seed in the
             reference's layout) behind ``GenerationAPI`` on the card,
             8 concurrent HTTP requests; checks the answers, that the
             greedy tokens equal the plain-attention path's, that the
             prefill logits agree within 1e-3, and that every prefill
             block launched the flash kernel; the window plane, pinned
             with ``engine="window"``;
6. serve_continuous — the same LM behind ``GenerationAPI``'s default
             continuous engine (8 slots, buckets 128..2048, max_context
             2048, pages of 16, decode_block 1): 24 requests posted at
             once (prompts of 60, 120, 250, 480, 900 and 1800 tokens,
             four each, two greedy and two sampled at 0.8, n_new
             16/32/48, a seed each), and the same 24 through the window
             plane in the same run. Checks: every answer is the
             engine's and equals the window plane's, admitted = retired
             = 24, flash launches = 6 x prefills = 6 x 24, each prefill
             at its prompt's bucket, peak slots 2..8, the page ledger
             empty afterwards, continuous tokens/s above the window
             plane's; prints both planes' tokens/s, latency and TTFT
             percentiles, the median decode tick, peak slots, pages and
             memory;
7. serve_continuous_breakdown — torch.profiler over 20 decode ticks
             while all 8 rows are live: device ms by kernel, launches a
             tick, the device's idle share;
8. train   — MNIST-784 (784 → 100 tanh → 10 softmax, mb 100, 60k/10k
             synthetic rows) through ``models.mnist.build_workflow``,
             8 epochs at 4 per dispatch, once with ``fused_fc_scan`` on
             and once off, from the same seed: the fused run launched the
             kernel once per epoch, its validation error falls, and its
             per-epoch validation errors agree with the general path's
             within 0.005 and its final weights within 1e-4; then one
             fused 4-epoch block under
             torch.profiler: device busy share and top kernels;
9. kernels_bwd — the flash backward pair (dK/dV, dQ; 3xTF32 on the
             tensor cores) against the plain backward on 18 cases (the
             bench shape, GQA 8/2 and 8/1, windows, ragged T 1, 65, 127,
             129, D 8..256 including 33, 40, 72 and 160, strided q/k/v
             and views offset by one element, so that no row is 16-byte
             aligned): max abs error of each gradient <= 1e-4 *
             max(1, max|plain|), relaunches bit-identical, each call
             counted once by each kernel's launch counter, and autograd
             through ``flash_attention`` against autograd through the
             plain attention;
10. timing_bwd — each backward kernel at the bench shape with CUDA
             events, its bounds (``ops/flash_attention.backward_bounds``:
             3xTF32 on the tensor cores, ``bound_tc_ms``, the one the
             kernels run against and the kernels line's ``bound_ms``; and
             float32 FMA on the CUDA cores, ``bound_ms`` here, kept
             comparable with earlier runs), the plain backward's
             time and SDPA's backward (the yardstick; it computes the
             pair's function);
11. train_lm — the bench LM (``models/char_lm.build_bench_workflow``:
             6 RoPE blocks, d_model 512, 8 heads, FFN 2048, vocab 256,
             T 512, mb 16, 1,024 / 128 rows, adam lr 1e-4), one epoch
             from one seed with the kernels and with the plain
             attention: forward launches 6 x (64 + 8), dK/dV = dQ
             launches 6 x 64 (0 on the plain run); per-epoch train and
             validation NLL/token within 1e-4 relative; final weights
             within 1e-3 max abs and 1e-5 at the 99.9th percentile
             (adam's normalised step flips an element whose gradient is
             rounding noise by up to 2 lr a step); epoch ms, tokens/s,
             peak memory; then 16 greedy tokens from the trained
             weights through the sampler, equal to the plain path's;
12. train_lm_breakdown — torch.profiler over 4 train steps: device busy
             share, launches per step, top kernels, the flash kernels'
             share;
13. kernels_amp — the mixed-precision instances of the three flash
             kernels (q/k and v float32 or bf16: f32_bf16, bf16_f32,
             bf16_bf16; the f32 one is phases 3 and 9) against their
             plain versions in the same dtypes (the forward in the
             kernel's K/V blocks, whose running max its p is rounded
             against) on 17 cases (the bench shape, windows, GQA 8/1, T
             1/65/127/129, D 8..256 including 33, 72 and 160, views off
             by one element) and a NaN in q, k or v: the largest error of
             a bf16 output within 2^-7 · max(1, max|plain|) (one bf16 ulp
             of its largest element), of a float32 one within 1e-3 of it;
             the mean error within 4e-6 of it, and the control — the
             plain versions on float32 copies, which round nothing —
             beyond that on every case of more than one key, for every
             output the instance rounds p or ds for; outputs in the
             inputs' dtypes, NaN patterns equal, relaunches
             bit-identical, each call counted once under its instance;
14. timing_amp — each instance's three kernels at B16 and B4 T512 H8
             D64 causal: CUDA events, the plain version, the bound
             (``forward_bounds``/``backward_bounds`` of the instance: bf16
             products at the bf16 peak, the others 3xTF32) and SDPA in
             bf16 for the all-bf16 instance, SDPA on float32 inputs for
             the mixed ones (no library call takes two dtypes);
15. train_lm_amp — the bench LM under ``engine.mixed_precision``, one
             epoch from one seed through the kernels and through the plain
             attention: block 0 takes the (f32, f32, bf16) instance 72 /
             64 / 64 times, the other 5 blocks the f32 one 5 × 72 / 5 × 64;
             NLL/token kernels vs plain within 1e-4 relative (the kernels
             round p to bf16 before p·v as the reference's kernel does,
             the plain attention does not); float32 masters; epoch ms,
             tokens/s, peak memory beside ``train_lm``'s; 16 greedy tokens
             from the trained weights equal to the plain path's; then the
             same for the bench LM without RoPE, whose block 0 takes the
             all-bf16 instance 72 / 64 / 64 times;
16. conv_units — the conv family (conv with each activation, strides,
             asymmetric padding; deconv at stride 1 and 2 with an
             asymmetric crop; max and avg pooling in ceil mode with ties
             and k < s; depooling; the six activation units), forward and
             the gradients of sum(y · g), on the card (cuDNN, TF32 off)
             against the port on the CPU: worst error per unit <= 1e-4 ·
             max(1, max|cpu|); a control with ``cudnn.allow_tf32`` forced
             on lands above it; whether relaunches are bit-identical;
17. train_ae — ImagenetAE's bench workflow
             (``models/imagenet_ae.build_bench_workflow``: 128×128×3, mb
             64, 1,024 / 128 synthetic rows, lr 1e-4), two epochs in
             float32 and two under the reference bench's setting
             (``engine.mixed_precision``, ``dataset_dtype="bfloat16"``):
             the float32 run's first two train steps against the port on
             the CPU from the same weights (loss and each weight update
             within 1e-4 relative); rmse finite and falling; each
             epoch's ms, train samples/s (the served rate times the train
             share, as ``bench.py`` scales it), model TFLOP/s from the
             counted work (1.8245 GFLOP forward a sample, ×3 a train
             sample: 5.84 TFLOP an epoch with its validation pass) and
             its share of the card's bf16 and float32 peaks; peak memory;
             a third epoch under torch.profiler: the device's idle share
             and top kernels;
18. train_cifar — ``models/cifar.build_workflow`` (caffe quick, 50,000 /
             10,000 surrogate rows, mb 100), one epoch: validation error,
             epoch ms; then 20 train steps under torch.profiler: the
             device's idle share and top kernels.
             Phases 16–18 launch no hand-written kernel (the launch
             counters stay 0): the conv path is cuDNN's;
19. recurrent_units — LSTM, RNN and SSM block training units (BASELINE
             #5's LSTM, the bench-width LSTM and SSM block, odd widths),
             forward and the gradients of sum(y · g), on the card against
             the port on the CPU: worst error <= 1e-4 · max(1, max|cpu|);
             the scan equals the loop of the step body bit for bit on the
             card; and whether a product row's bits change with the row
             count on the card (the reason the O(1)-state lane runs every
             product at one row count);
20. train_genre — BASELINE #5 (``models/genre_recognition``: LSTM 64
             over T 64 × 24 features, softmax 6, mb 60, lr 0.05, 1,800 /
             360 rows): the first two train steps on the card against the
             CPU from the same weights (loss and each update within 1e-4
             relative), then 5 epochs with the validation error falling;
             epoch ms, train samples/s, peak memory, and 4 train steps
             under torch.profiler (launches a step, idle share);
21. serve_recurrent — the char LM's ``arch="lstm"`` and ``"ssm"`` at
             the bench LM's width (dim 512, 6 blocks, random weights from
             numpy seed 0) behind ``GenerationAPI``'s default engine,
             which must land on the O(1)-state lane (the reference's
             defaults: 8 slots, max_context 640, chunks of 16,
             decode_block 1): 16 requests at once (prompts of 60, 120,
             250 and 512 tokens, half sampled, n_new 16/32/48), all
             answered 200 by the lane; 4 greedy and 4 sampled answers
             equal to ``generate_recurrent`` on the card; the state pool's
             bytes equal after a 4- and a 44-token decode, no pages; a
             slot's state against the paged transformer twin's KV rows at
             the same geometry (the reference's 4x bar); tokens/s, TTFT,
             the median decode tick; a profiled admission (launches a
             prefill token) and 10 profiled decode ticks with 8 rows live
             (launches a tick, idle share). Phases 19–21 launch no
             hand-written kernel;
22. snapshot — MNIST-784 (BASELINE #1: hidden 100, mb 100, 60k/10k
             surrogate rows, seed 1234) at 2 epochs a dispatch through
             the fused-FC kernel: 4 epochs straight, and 2 epochs with a
             gz ``Snapshotter`` whose ``_current`` file a fresh workflow
             ``resume``s and runs on to 4. Final weights, biases and
             both momenta bit-identical, per-epoch validation errors
             equal, the kernel launched in every epoch of both runs
             (4, then 2 + 2); the general path (cuBLAS) the same way
             within rtol 1e-5 / atol 1e-6, its bits reported; the file
             read on the host with ``load_snapshot`` equal to the card's
             tensors bit for bit. Records export ms, file bytes and
             resume ms;
23. baseline2 — BASELINE #2's units on the CIFAR-10 surrogate's 50,000
             training rows (32×32×3, float32 on the card):
             ``compute_mean_rdisp`` on the host, ``MeanDispNormalizer``
             on the card against its ``numpy_run`` within rtol 1e-5 /
             atol 1e-6 with |y| <= 1 + 1e-5, its ms beside the bound of
             the 1.23 GB it must move (0.367 ms at 3.35 TB/s); then
             ``InputJoiner`` of the normalised rows and their one-hot
             labels on the card, exact against numpy;
24. train_zoo — kanji (576 → 256 → 576 tanh, adam, MSE on targets) and
             video_ae (256 → 96 → 24 → 96 → 256 tanh, adam, MSE on the
             input) at the reference's sizes: the first two adam steps
             on the card against the CPU, each from the state the CPU's
             started from (loss and the moments m and v within 1e-4
             relative; the weight update's difference reported: adam's
             normalised step turns a gradient that is rounding noise
             into a full-size step),
             then 3 epochs with the validation rmse falling; epoch ms.
             Phases 23–24 launch no hand-written kernel.

Then the card's line, the kernels line (``{"kernels": [...]}``; the
flash kernels' AMP instances as entries of their own, each with its
launches in the AMP epochs; the fused-FC kernel's launches in ``train``
and, under ``launches_by_path``, in ``snapshot`` too) and,
last, the device line ``{"ok": true, "device": {...}}``. Any failure
raises and the run exits non-zero without the last line; without a card
it exits 1 at once.
"""

import json
import math
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))

TOL_KERNEL = 1e-4
TOL_LOGITS = 1e-3
#: fused-FC epoch loss, kernel vs plain (relative; float32 per-step sums
#: in another order)
TOL_LOSS_REL = 1e-5
#: per-epoch validation error rate, fused kernel vs general path
#: (absolute; 0.005 is 50 of the 10,000 validation rows)
TOL_VALID_ERR = 0.005
#: final weights after 8 epochs, fused kernel vs general path (absolute;
#: float32 in two summation orders, compounding over 4,800 steps)
TOL_TRAIN_WEIGHTS = 1e-4
#: the MNIST runs' master seed
SEED = 1234
N_NEW = 32
#: LM training, kernel route vs plain attention, same seed: per-epoch
#: NLL/token (relative), final weights (max abs, and at the 99.9th
#: percentile: adam's step is about +-lr wherever a gradient is rounding
#: noise, so a summation-order difference can flip one element by up to
#: 2 lr = 2e-4 a step, while the bulk must agree to rounding)
TOL_LM_LOSS_REL = 1e-4
TOL_LM_WEIGHTS_MAX = 1e-3
TOL_LM_WEIGHTS_P999 = 1e-5
LM_SEED = 77
LM_N_NEW = 16
#: conv-family units on the card vs the port on the CPU, float32 (max
#: abs error over max(1, max|cpu|): cuDNN sums in another order)
TOL_CONV = 1e-4
#: the bench AE's first two float32 train steps, card vs CPU: the loss
#: and each weight update (relative to its largest element)
TOL_AE_STEP_REL = 1e-4
AE_SEED = 99
#: train steps of CIFAR's profiled window
CIFAR_STEPS = 20
#: published dense peaks of one H100 SXM at 700 W (TFLOP/s)
PEAK_TFLOPS = {"bf16": 989.0, "f32": 67.0}

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


def cuda_time_ms(fn, iters, warmup=3):
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls,
    after ``warmup`` calls, with CUDA events."""
    import torch
    for _ in range(warmup):
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
    from veles_tpu_torch.telemetry import counters
    cases = [
        # (name, B, T, H, KV, D, causal, window, layout)
        ("serve_b4_t512", 4, 512, 8, 8, 64, True, 0, None),
        ("serve_b2_t2048", 2, 2048, 8, 8, 64, True, 0, None),
        ("serve_b1_t300", 1, 300, 8, 8, 64, True, 0, None),
        # the continuous engine's prefills: one prompt padded to a bucket
        ("serve_continuous_b1_t128", 1, 128, 8, 8, 64, True, 0, None),
        ("serve_continuous_b1_t1024", 1, 1024, 8, 8, 64, True, 0, None),
        ("serve_continuous_b1_t2048", 1, 2048, 8, 8, 64, True, 0, None),
        ("train_b16_t512", 16, 512, 8, 8, 64, True, 0, None),
        ("gqa_kv2", 4, 512, 8, 2, 64, True, 0, None),
        ("window128", 4, 512, 8, 8, 64, True, 128, None),
        ("ragged_t300_noncausal", 2, 300, 8, 8, 64, False, 0, None),
        ("d32", 2, 512, 8, 8, 32, True, 0, None),
        ("d128", 2, 512, 8, 8, 128, True, 0, None),
        ("d256_gqa_window", 1, 333, 4, 2, 256, True, 100, None),
        ("noncausal", 4, 512, 8, 8, 64, False, 0, None),
        # the tile edges of the tensor-core design: T around the 64-row q
        # tiles and the streamed K/V tiles, D off the multiples of 16 (33:
        # rows off 16 bytes, so 4-byte copies), D past 128 (o's columns
        # over two CTAs), GQA 8/1 with a window, every row off 16 bytes,
        # and more (batch, head) pairs than a grid axis of 65,535 takes
        ("t1", 1, 1, 2, 2, 48, True, 0, None),
        ("t65", 2, 65, 4, 4, 64, True, 0, None),
        ("t127_noncausal_gqa_4_2", 2, 127, 4, 2, 64, False, 0, None),
        ("t129", 2, 129, 4, 4, 64, True, 0, None),
        ("d8", 2, 200, 4, 4, 8, True, 0, None),
        ("d33", 2, 100, 4, 4, 33, True, 0, None),
        ("d40_gqa_4_2", 2, 150, 4, 2, 40, True, 0, None),
        ("d72_noncausal", 2, 140, 4, 4, 72, False, 0, None),
        ("d160_noncausal", 1, 90, 2, 2, 160, False, 0, None),
        ("gqa_8_1_window64", 2, 300, 8, 1, 64, True, 64, None),
        ("offset_views", 2, 100, 4, 2, 64, True, 0, "offset"),
        ("heads_65544", 8193, 2, 8, 8, 8, True, 0, None),
    ]
    worst = 0.0
    for i, (name, b, t, h, kv, d, causal, window, layout) in \
            enumerate(cases):
        if layout:
            q, k, v = bwd_inputs(b, t, h, kv, d, 100 + i, layout)[:3]
        else:
            q, k, v = qkv(b, t, h, kv, d, seed=100 + i)
        before = counters.get(fa.FWD_LAUNCHES)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                        window=window)
        launched = counters.get(fa.FWD_LAUNCHES) - before
        ro, rlse = fa.flash_attention_fwd_reference(
            q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err_o = float((o - ro).abs().max())
        err_lse = float((lse - rlse).abs().max())
        finite = bool(torch.isfinite(o).all() and torch.isfinite(lse).all())
        emit("kernels", kernel="flash_attention_fwd", case=name,
             shape=[b, t, h, kv, d], causal=causal, window=window,
             layout=layout, max_abs_err_o=err_o, max_abs_err_lse=err_lse,
             finite=finite, launches=launched)
        if not finite or launched != 1 or max(err_o, err_lse) > TOL_KERNEL:
            raise AssertionError("flash_attention_fwd disagrees with its "
                                 "plain version on %s: o %g, lse %g"
                                 % (name, err_o, err_lse))
        worst = max(worst, err_o, err_lse)
    # a NaN made by the card's arithmetic (0/0) in q (row 70), k or v (key
    # row 0, which every query row sees): NaN exactly where the plain
    # version has it, the rest within the tolerance
    nan = torch.zeros((), device="cuda") / torch.zeros((), device="cuda")
    for where in ("q", "k", "v"):
        for causal in (False, True):
            q, k, v = qkv(1, 100, 2, 2, 64, seed=150)
            {"q": q, "k": k, "v": v}[where][
                0, 70 if where == "q" else 0, 1, 5] = nan
            o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
            ro, rlse = fa.flash_attention_fwd_reference(q, k, v,
                                                        causal=causal)
            torch.cuda.synchronize()
            same_nan = all(torch.equal(torch.isnan(a), torch.isnan(r))
                           for a, r in ((o, ro), (lse, rlse)))
            errs = [float((a[~torch.isnan(r)] - r[~torch.isnan(r)])
                          .abs().max()) for a, r in ((o, ro), (lse, rlse))]
            n_nan = int(torch.isnan(ro).sum())
            emit("kernels", kernel="flash_attention_fwd",
                 case="nan_in_%s" % where, shape=[1, 100, 2, 2, 64],
                 causal=causal, nan_elements_o=n_nan,
                 same_nan_pattern=same_nan, max_abs_err_o=errs[0],
                 max_abs_err_lse=errs[1])
            if not same_nan or n_nan == 0 or max(errs) > TOL_KERNEL:
                raise AssertionError("flash_attention_fwd does not keep a "
                                     "NaN in %s (causal %s): %s / %s"
                                     % (where, causal, same_nan, errs))
            worst = max(worst, *errs)
    return worst


def phase_timing(fa, card):
    """Times at the serving shapes and the training shape; returns the
    records keyed by (B, T)."""
    import torch.nn.functional as F
    records = {}
    # the window plane's batch, the training batch, the longest prompt;
    # the continuous engine's smallest and largest prefill buckets
    for b, t in ((4, 512), (16, 512), (2, 2048), (1, 128), (1, 2048)):
        h = kv = 8
        d = 64
        q, k, v = qkv(b, t, h, kv, d, seed=7)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ms = cuda_time_ms(
            lambda: fa.flash_attention_fwd(q, k, v, causal=True), 100)
        plain_ms = cuda_time_ms(
            lambda: fa.flash_attention_fwd_reference(q, k, v, causal=True),
            10)
        library_ms = cuda_time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True), 100)
        flops, nbytes = fa.forward_work(b, t, h, d, causal=True, kv=kv)
        bound = fa.forward_bounds(b, t, h, d, causal=True, kv=kv)
        rec = dict(shape=[b, t, h, kv, d], causal=True, card=card, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   flops=flops, bytes=nbytes,
                   # float32 FMA on the CUDA cores, kept comparable with
                   # earlier runs; the kernel's products run on the tensor
                   # cores in 3xTF32, so bound_tc_ms is the one it runs
                   # against
                   bound_ms=bound["f32"], bound_tc_ms=bound["tc"],
                   bound_by=bound["bound_by"],
                   pct_of_tc_bound=100.0 * bound["tc"] / ms,
                   achieved_tflops=flops / (ms * 1e-3) / 1e12)
        emit("timing", kernel="flash_attention_fwd", **rec)
        records[(b, t)] = rec
    return records


def ffc_inputs(dims, mb, steps, n_rows, seed, plan="permutation"):
    """A random chain, dataset, labels and plan on the card, from a
    numpy seed. ``plan``: "permutation" (each row once) or "repeats"
    (rows drawn with replacement: a row recurs within and across
    steps)."""
    import numpy
    import torch
    rng = numpy.random.RandomState(seed)

    def dev(a):
        return torch.from_numpy(a).cuda()
    ws = [dev((rng.randn(a, b) / numpy.sqrt(a)).astype("float32"))
          for a, b in zip(dims, dims[1:])]
    bs = [dev((rng.randn(b) * 0.01).astype("float32")) for b in dims[1:]]
    vws = [torch.zeros_like(w) for w in ws]
    vbs = [torch.zeros_like(b) for b in bs]
    ds = dev(rng.rand(n_rows, dims[0]).astype("float32"))
    lb = dev(rng.randint(0, dims[-1], n_rows).astype("int32"))
    rows = (rng.permutation(n_rows)[:steps * mb] if plan == "permutation"
            else rng.randint(0, n_rows, steps * mb))
    return ws, bs, vws, vbs, ds, lb, dev(
        rows.reshape(steps, mb).astype("int32"))


def ffc_errors(out, ref):
    """(max abs error over the finite elements of w/b/vw/vb, loss
    relative error, err_count difference, NaN patterns equal) of a
    kernel result against the plain version's. NaN losses agree."""
    import torch
    err, nan_same = 0.0, True
    for xs, ys in zip(out[:4], ref[:4]):
        for a, b in zip(xs, ys):
            nan_same &= bool(torch.equal(torch.isnan(a), torch.isnan(b)))
            live = ~(torch.isnan(a) | torch.isnan(b))
            if bool(live.any()):
                err = max(err, float((a[live] - b[live]).abs().max()))
    got, want = float(out[4]), float(ref[4])
    if math.isnan(got) or math.isnan(want):
        loss_rel = 0.0 if math.isnan(got) and math.isnan(want) else math.inf
    else:
        loss_rel = abs(got - want) / max(abs(want), 1e-30)
    return err, loss_rel, abs(float(out[5]) - float(ref[5])), nan_same


def same_bits(x, y):
    """Two fused-FC results hold the same bits in w/b/vw/vb (NaN too)."""
    import torch
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for xs, ys in zip(x[:4], y[:4]) for a, b in zip(xs, ys))


def phase_kernels_fused_fc(ff):
    """fused_fc_sgd_epoch vs its plain version on the card, each case at
    the geometry the wrapper chooses and again at every other it may
    choose (same bits); returns the largest weight error."""
    import torch
    lecun = dict(act_a=1.7159, act_b=0.6666)
    cases = [
        # (name, dims, mb, steps, plan, kwargs)
        ("mnist_784_100_10", [784, 100, 10], 100, 12, "permutation",
         lecun),
        ("momentum_decay", [784, 100, 10], 100, 12, "permutation",
         dict(lecun, momentum=0.9, wd=1e-3, wd_bias=1e-4,
              lr_bias_ratio=0.5)),
        ("unit_ab", [784, 100, 10], 100, 12, "permutation",
         dict(act_a=1.0, act_b=1.0)),
        ("three_layer_784_256_64_10", [784, 256, 64, 10], 100, 12,
         "permutation", dict(lecun, momentum=0.5)),
        # the columns layout at both of its cluster sizes
        ("columns_784_200_10", [784, 200, 10], 100, 12, "permutation",
         dict(lecun, momentum=0.9)),
        ("odd_20_12_3_mb10", [20, 12, 3], 10, 12, "permutation", lecun),
        ("mb37", [784, 100, 10], 37, 12, "permutation", lecun),
        # rows of 33 floats: off 16 bytes, 4-byte copies
        ("unaligned_d33", [33, 100, 10], 100, 12, "permutation",
         dict(lecun, momentum=0.9)),
        ("one_step", [784, 100, 10], 100, 1, "permutation", lecun),
        ("repeated_rows", [784, 100, 10], 100, 12, "repeats",
         dict(lecun, momentum=0.9)),
        # a NaN in one dataset row that step 5 reads
        ("nan_row", [784, 100, 10], 100, 12, "nan", lecun),
    ]
    worst = 0.0
    for i, (name, dims, mb, steps, plan_kind, kw) in enumerate(cases):
        ws, bs, vws, vbs, ds, lb, plan = ffc_inputs(
            dims, mb, steps, 2000, seed=200 + i,
            plan="repeats" if plan_kind == "repeats" else "permutation")
        if plan_kind == "repeats":
            assert len(set(plan.flatten().tolist())) < plan.numel()
        if plan_kind == "nan":
            ds[int(plan[5, 7]), 300] = float("nan")
        shapes = [tuple(w.shape) for w in ws]
        geos = ff.geometries(shapes, mb)
        smem = ff.smem_bytes(shapes, mb, geos[0][1], geos[0][0])
        out = ff.fused_fc_sgd_epoch(ws, bs, vws, vbs, ds, lb, plan, 0.05,
                                    **kw)
        again = ff.fused_fc_sgd_epoch(ws, bs, vws, vbs, ds, lb, plan, 0.05,
                                      **kw)
        ref = ff.fused_fc_sgd_epoch_reference(ws, bs, vws, vbs, ds, lb,
                                              plan, 0.05, **kw)
        others = {"%s%d" % g: same_bits(ff.fused_fc_sgd_epoch(
            ws, bs, vws, vbs, ds, lb, plan, 0.05, cluster=g[1], **kw), out)
            for g in geos[1:]}
        torch.cuda.synchronize()
        same = same_bits(out, again)
        rec = dict(kernel="fused_fc_sgd_epoch", case=name, dims=dims, mb=mb,
                   steps=steps, layout=geos[0][0], cluster=geos[0][1],
                   smem_bytes=smem, other_geometries_same_bits=others, **kw)
        if name == "mnist_784_100_10":
            # a second launch continues from the first's returned state
            out = ff.fused_fc_sgd_epoch(*out[:4], ds, lb, plan, 0.05, **kw)
            ref = ff.fused_fc_sgd_epoch_reference(*ref[:4], ds, lb, plan,
                                                  0.05, **kw)
            torch.cuda.synchronize()
            rec["case"] = "mnist_784_100_10+continuation"
        err, loss_rel, err_diff, nan_same = ffc_errors(out, ref)
        finite = all(bool(torch.isfinite(a).all()) for xs in out[:4]
                     for a in xs)
        emit("kernels", max_abs_err=err, loss_rel_err=loss_rel,
             err_count_diff=err_diff, nan_pattern_same=nan_same,
             bit_identical_relaunch=same, finite=finite, **rec)
        if (finite != (plan_kind != "nan") or not nan_same
                or err > TOL_KERNEL or loss_rel > TOL_LOSS_REL
                or err_diff != 0 or not same or not all(others.values())):
            raise AssertionError("fused_fc_sgd_epoch disagrees with its "
                                 "plain version on %s: %g / %g / %g / %s / "
                                 "%s / %s" % (rec["case"], err, loss_rel,
                                              err_diff, nan_same, same,
                                              others))
        worst = max(worst, err)
    return worst


def mnist_workflow(fused, epochs=8, per_dispatch=4, seed=SEED,
                   snapshot_dir=None):
    """The MNIST-784 workflow on the card from ``seed``, initialised;
    with a gz ``Snapshotter`` writing to ``snapshot_dir`` if given."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.models import mnist
    root.common.engine.fused_fc_scan = bool(fused)
    prng.seed_all(seed)
    wf = mnist.build_workflow(epochs=epochs, minibatch_size=100,
                              snapshot_dir=snapshot_dir,
                              epochs_per_dispatch=per_dispatch)
    wf.initialize()                     # default device: the card
    return wf


def phase_timing_fused_fc(ff, card):
    """One MNIST epoch (K 600, mb 100) on the port's MNIST data: the
    kernel over 5 launches at every geometry the wrapper may choose, the
    plain version once, the general path's train segment for the same
    plan. Every geometry's last launch is held against the plain
    version's result (same tolerances as the 12-step cases) and against
    the default's (identical bits); returns the kernel's record."""
    import numpy
    import torch
    wf = mnist_workflow(False, epochs=1, per_dispatch=4)
    step, loader = wf.train_step, wf.loader
    dataset, labels = step._dataset()
    n_valid = loader.class_lengths[1]
    rng = numpy.random.RandomState(SEED)
    plan = torch.from_numpy((n_valid + rng.permutation(
        loader.class_lengths[2])).reshape(-1, 100).astype("int32")).cuda()
    mask = torch.ones(plan.shape, device="cuda")
    names = [f.name for f in wf.forwards]
    ws = [step.params[n]["weights"] for n in names]
    bs = [step.params[n]["bias"] for n in names]
    vws = [torch.zeros_like(w) for w in ws]
    vbs = [torch.zeros_like(b) for b in bs]
    kw = dict(act_a=1.7159, act_b=0.6666)
    lr = 0.03
    shapes = [tuple(w.shape) for w in ws]
    steps = int(plan.shape[0])
    geos = ff.geometries(shapes, 100)
    layout, cluster = geos[0]
    rec = dict(kernel="fused_fc_sgd_epoch", card=card, dims=[784, 100, 10],
               mb=100, steps=steps, layout=layout, cluster=cluster,
               geometries=["%s%d" % g for g in geos])
    outs = {}

    def keep(key, fn):
        def run():
            outs[key] = fn()
        return run

    for lay, c in geos:
        rec["ms_%s%d" % (lay, c)] = cuda_time_ms(keep((lay, c), lambda: (
            ff.fused_fc_sgd_epoch(ws, bs, vws, vbs, dataset, labels, plan,
                                  lr, cluster=c, **kw))), 5)
    rec["ms"] = rec["ms_%s%d" % (layout, cluster)]
    rec["us_per_step"] = rec["ms"] * 1e3 / steps
    rec["plain_ms"] = cuda_time_ms(keep("plain", lambda: (
        ff.fused_fc_sgd_epoch_reference(ws, bs, vws, vbs, dataset, labels,
                                        plan, lr, **kw))), 1, warmup=0)
    rec["general_path_ms"] = cuda_time_ms(
        lambda: step._train_plan(step.params, step.opt_state,
                                 step._zero_accum(), dataset, labels, plan,
                                 mask, 1.0), 2, warmup=1)
    errs = [ffc_errors(outs[g], outs["plain"]) for g in geos]
    err = max(e[0] for e in errs)
    loss_rel = max(e[1] for e in errs)
    err_diff = max(abs(e[2]) for e in errs)
    same = all(same_bits(outs[g], outs[geos[0]]) for g in geos)
    finite = all(bool(torch.isfinite(a).all()) for g in geos
                 for xs in outs[g][:4] for a in xs)
    # the bounds are the work the epoch needs; analytic_cost is the
    # reference's model (it charges a layer-0 d_h product), printed beside
    bounds = ff.epoch_bounds(shapes, 100, steps, cluster)
    model_flops, model_bytes = ff.analytic_cost(shapes, 100, steps)
    rec.update(max_abs_err=err, loss_rel_err=loss_rel,
               err_count_diff=err_diff, geometries_bit_identical=same,
               finite=finite, loss_sum=float(outs[geos[0]][4]),
               err_count=float(outs[geos[0]][5]),
               analytic_cost_flops=model_flops,
               analytic_cost_bytes=model_bytes, library_ms=None,
               achieved_tflops=bounds["flops"] / (rec["ms"] * 1e-3) / 1e12,
               **bounds)
    emit("timing", **rec)
    if not finite or err > TOL_KERNEL or loss_rel > TOL_LOSS_REL \
            or err_diff != 0 or not same:
        raise AssertionError("fused_fc_sgd_epoch disagrees with its plain "
                             "version on the MNIST epoch: %g / %g / %g / %s"
                             % (err, loss_rel, err_diff, same))
    return rec


def phase_train(card):
    """MNIST through the port's workflow, fused kernel vs general path
    from the same seed; returns the fused run's kernel launches."""
    import numpy
    import torch
    from veles_tpu_torch.telemetry import counters
    runs = {}
    for fused in (True, False):
        wf = mnist_workflow(fused)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counters.counters.reset()
        t0 = time.perf_counter()
        wf.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counters.get("veles_fused_fc_launches_total")
        d = wf.decision
        valid = list(d.epoch_metrics[1])
        runs[fused] = dict(
            wf=wf, wall=wall, launches=launches, valid=valid,
            train=list(d.epoch_metrics[2]),
            active=bool(wf.train_step._fused_fc_active),
            engaged=wf.train_step._fused_fc is not None,
            peak=int(torch.cuda.max_memory_allocated()),
            samples=wf.loader.samples_served)
    f, g = runs[True], runs[False]
    epochs = len(f["valid"])
    weight_diff = max(
        float(numpy.abs(a.weights.map_read() - b.weights.map_read()).max())
        for a, b in zip(f["wf"].forwards, g["wf"].forwards))
    valid_diff = max(abs(a - b) for a, b in zip(f["valid"], g["valid"]))
    emit("train", card=card, model="mnist-784 784-100-10", mb=100,
         epochs=epochs, epochs_per_dispatch=4,
         rows={"train": f["wf"].loader.class_lengths[2],
               "validation": f["wf"].loader.class_lengths[1]},
         fused_fc_active=f["active"], fused_fc_launches=f["launches"],
         general_path_launches=g["launches"],
         valid_err_fused=f["valid"], valid_err_general=g["valid"],
         train_err_fused=f["train"], train_err_general=g["train"],
         valid_err_max_diff=valid_diff, final_weight_max_abs_diff=weight_diff,
         wall_s_fused=f["wall"], wall_s_general=g["wall"],
         epoch_ms_fused=f["wall"] / epochs * 1e3,
         epoch_ms_general=g["wall"] / epochs * 1e3,
         samples_per_s_fused=f["samples"] / f["wall"],
         samples_per_s_general=g["samples"] / g["wall"],
         peak_memory_bytes_fused=f["peak"],
         peak_memory_bytes_general=g["peak"])
    if not (f["engaged"] and f["active"]) or g["engaged"]:
        raise AssertionError("the MNIST config did not engage the fused "
                             "kernel (or the general run did)")
    if f["launches"] != epochs or epochs != 8 or g["launches"] != 0:
        raise AssertionError("fused-FC launches %d (general %d) for %d "
                             "epochs" % (f["launches"], g["launches"],
                                         epochs))
    if not all(numpy.isfinite(f["valid"] + f["train"])):
        raise AssertionError("non-finite error rates")
    if not min(f["valid"]) < f["valid"][0]:
        raise AssertionError("validation error did not fall: %s"
                             % f["valid"])
    if valid_diff > TOL_VALID_ERR:
        raise AssertionError("per-epoch validation error fused vs general "
                             "differs by %g" % valid_diff)
    if not weight_diff <= TOL_TRAIN_WEIGHTS:
        raise AssertionError("final weights fused vs general differ by %g"
                             % weight_diff)
    return f["launches"]


def bwd_inputs(b, t, h, kv, d, seed, layout=None):
    """q, k, v, do on the card from a seed. ``layout`` "strided": q/k/v
    are views of one (B, T, 3, H, D) buffer (requires kv == h);
    "offset": each of q, k, v, do is a view one element into its buffer,
    so that no row starts on 16 bytes."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    if layout == "strided":
        q, k, v = torch.randn((b, t, 3, h, d), generator=g,
                              device="cuda").unbind(2)
    elif layout == "offset":
        def view(heads):
            n = b * t * heads * d
            return torch.randn(n + 1, generator=g, device="cuda")[1:].view(
                b, t, heads, d)
        return view(h), view(kv), view(kv), view(h)
    else:
        q, k, v = qkv(b, t, h, kv, d, seed)
    do = torch.randn((b, t, h, d), generator=g, device="cuda")
    return q, k, v, do


def phase_kernels_bwd(fa):
    """The backward pair vs the plain backward on the card; returns the
    largest error of each kernel (dQ; dK and dV)."""
    import torch
    from veles_tpu_torch.nn.attention import attention_reference, expand_kv
    from veles_tpu_torch.telemetry import counters
    cases = [
        # (name, B, T, H, KV, D, causal, window, layout)
        ("bench_b16_t512", 16, 512, 8, 8, 64, True, 0, None),
        ("t300_gqa_8_2", 2, 300, 8, 2, 64, True, 0, None),
        ("window128", 2, 512, 8, 8, 64, True, 128, None),
        ("t333_d256_gqa_4_2_window100", 1, 333, 4, 2, 256, True, 100,
         None),
        ("noncausal_t257_d128", 2, 257, 8, 8, 128, False, 0, None),
        ("t1", 1, 1, 2, 2, 48, True, 0, None),
        ("d32_noncausal_t200", 2, 200, 8, 8, 32, False, 0, None),
        ("strided_qkv", 2, 100, 4, 4, 32, True, 0, "strided"),
        # the tile edges of the tensor-core design: T around the 64-row
        # tiles, D off the multiples of 16 (33: rows off 16 bytes, so
        # 4-byte copies), D past 128 (two column CTAs), GQA 8/1 with a
        # window, every row off 16 bytes
        ("t65", 2, 65, 4, 4, 64, True, 0, None),
        ("t127_noncausal_gqa_4_2", 2, 127, 4, 2, 64, False, 0, None),
        ("t129", 2, 129, 4, 4, 64, True, 0, None),
        ("d8", 2, 200, 4, 4, 8, True, 0, None),
        ("d40_gqa_4_2", 2, 150, 4, 2, 40, True, 0, None),
        ("d72_noncausal", 2, 140, 4, 4, 72, False, 0, None),
        ("d33", 2, 100, 4, 4, 33, True, 0, None),
        ("d160_noncausal", 1, 90, 2, 2, 160, False, 0, None),
        ("gqa_8_1_window64", 2, 300, 8, 1, 64, True, 64, None),
        ("offset_views", 2, 100, 4, 4, 64, True, 0, "offset"),
    ]
    worst = {"dq": 0.0, "dkv": 0.0}
    for i, (name, b, t, h, kv, d, causal, window, layout) in \
            enumerate(cases):
        q, k, v, do = bwd_inputs(b, t, h, kv, d, 300 + i, layout)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                        window=window)
        before = [counters.get(n) for n in (fa.DKV_LAUNCHES,
                                            fa.DQ_LAUNCHES)]
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                     window=window)
        again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                       window=window)
        launched = [counters.get(n) - c for n, c in zip(
            (fa.DKV_LAUNCHES, fa.DQ_LAUNCHES), before)]
        ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                               causal=causal, window=window)
        # autograd through the differentiable entry vs through the plain
        # attention (the gradcheck of the wiring)
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        plain = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        auto = torch.autograd.grad(fa.flash_attention(
            *leaves, causal=causal, window=window or None), leaves, do)
        auto_ref = torch.autograd.grad(attention_reference(
            plain[0], expand_kv(plain[1], h), expand_kv(plain[2], h),
            causal=causal, window=window or None), plain, do)
        torch.cuda.synchronize()
        errs = [float((a - r).abs().max()) for a, r in zip(got, ref)]
        limits = [TOL_KERNEL * max(1.0, float(r.abs().max())) for r in ref]
        auto_errs = [float((a - r).abs().max())
                     for a, r in zip(auto, auto_ref)]
        auto_limits = [TOL_KERNEL * max(1.0, float(r.abs().max()))
                       for r in auto_ref]
        same = all(torch.equal(a, r) for a, r in zip(got, again))
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        emit("kernels_bwd", case=name, shape=[b, t, h, kv, d],
             causal=causal, window=window, layout=layout,
             max_abs_err_dq=errs[0], max_abs_err_dk=errs[1],
             max_abs_err_dv=errs[2], limits=limits,
             autograd_max_abs_err=auto_errs,
             bit_identical_relaunch=same, finite=finite,
             launches_dkv_dq=launched)
        if not finite or not same or launched != [2, 2] or any(
                e > lim for e, lim in zip(errs + auto_errs,
                                          limits + auto_limits)):
            raise AssertionError("flash backward disagrees with its plain "
                                 "version on %s: %s / %s / %s / %s"
                                 % (name, errs, auto_errs, same, launched))
        worst["dq"] = max(worst["dq"], errs[0])
        worst["dkv"] = max(worst["dkv"], errs[1], errs[2])
    return worst


def phase_timing_bwd(fa, card):
    """Each backward kernel at the bench shape (B16 T512 H8 D64 causal):
    CUDA events, its bound, the plain backward and SDPA's backward."""
    import torch
    import torch.nn.functional as F
    b, t, h, kv, d = 16, 512, 8, 8, 64
    q, k, v, do = bwd_inputs(b, t, h, kv, d, 9)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    delta = (do * o).sum(-1).permute(0, 2, 1)
    scale = 1.0 / math.sqrt(d)
    args = (q, k, v, do, lse, delta, True, 0, scale)
    ms = {"dkv": cuda_time_ms(lambda: fa.launch_bwd_dkv(*args), 30),
          "dq": cuda_time_ms(lambda: fa.launch_bwd_dq(*args), 30)}
    pair_ms = cuda_time_ms(
        lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True),
        30)
    plain_ms = cuda_time_ms(lambda: fa.flash_attention_bwd_reference(
        q, k, v, o, lse, do, causal=True), 5)
    qt, kt, vt = (x.transpose(1, 2).detach().clone().requires_grad_()
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    library_ms = cuda_time_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), 30)
    work = fa.backward_work(b, t, h, d, causal=True, kv=kv)
    bounds = fa.backward_bounds(b, t, h, d, causal=True, kv=kv)
    records = {}
    for name in ("dkv", "dq"):
        flops, nbytes = work[name]
        bound = bounds[name]
        rec = dict(shape=[b, t, h, kv, d], causal=True, card=card,
                   ms=ms[name], pair_ms=pair_ms, plain_ms=plain_ms,
                   library_ms=library_ms, flops=flops, bytes=nbytes,
                   bound_ms=bound["f32"], bound_tc_ms=bound["tc"],
                   bound_by=bound["bound_by"],
                   achieved_tflops=flops / (ms[name] * 1e-3) / 1e12,
                   share_of_tc_bound=bound["tc"] / ms[name])
        emit("timing_bwd", kernel="flash_attention_bwd_" + name, **rec)
        records[name] = rec
    return records


def lm_workflow(flash):
    """The bench LM on the card from LM_SEED, one epoch, initialised;
    ``flash`` routes attention through the kernels or the plain
    version."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.models import char_lm
    root.common.engine.flash_attention = bool(flash)
    prng.seed_all(LM_SEED)
    wf = char_lm.build_bench_workflow()
    wf.decision.max_epochs = 1          # the bench config never stops
    wf.initialize()                     # default device: the card
    return wf


def phase_train_lm(card):
    """The bench LM, one epoch with the kernels and one with the plain
    attention, from one seed; returns the kernel run's workflow, its
    launches per kernel and its epoch ms, tokens/s and peak memory."""
    import torch
    from veles_tpu_torch.config import root
    from veles_tpu_torch.models import char_lm
    from veles_tpu_torch.ops import flash_attention as fa
    from veles_tpu_torch.telemetry import counters
    names = (fa.FWD_LAUNCHES, fa.DKV_LAUNCHES, fa.DQ_LAUNCHES)
    runs = {}
    try:
        for flash in (True, False):
            wf = lm_workflow(flash)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            counters.counters.reset()
            t0 = time.perf_counter()
            wf.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs[flash] = dict(
                wf=wf, wall=wall,
                launches=[int(counters.get(n)) for n in names],
                peak=int(torch.cuda.max_memory_allocated()),
                loss={cls: list(wf.decision.epoch_losses[cls])
                      for cls in (1, 2)},
                err={cls: list(wf.decision.epoch_metrics[cls])
                     for cls in (1, 2)})
        kern, plain = runs[True], runs[False]
        wf = kern["wf"]
        diff = torch.cat([
            (t - plain["wf"].train_step.params[n][k]).abs().flatten()
            for n, p in wf.train_step.params.items() for k, t in p.items()])
        diff = diff.sort().values
        w_max = float(diff[-1])
        w_p999 = float(diff[int(0.999 * (diff.numel() - 1))])
        loss_rel = max(abs(a - b) / abs(b) for cls in (1, 2)
                       for a, b in zip(kern["loss"][cls],
                                       plain["loss"][cls]))
        prompt = [int(x) for x in wf.loader.original_data.mem[0][:32]]
        root.common.engine.flash_attention = True
        tokens = char_lm.generate(wf, prompt, LM_N_NEW, temperature=0)
        root.common.engine.flash_attention = False
        plain_tokens = char_lm.generate(wf, prompt, LM_N_NEW, temperature=0)
    finally:
        root.common.engine.flash_attention = True
    steps = wf.loader.class_lengths[2] // wf.loader.max_minibatch_size
    valid_steps = -(-wf.loader.class_lengths[1]
                    // wf.loader.max_minibatch_size)
    n_blocks = sum(1 for c in wf.layers_config
                   if c["type"] == "transformer_block")
    train_tokens = (wf.loader.class_lengths[2]
                    * wf.loader.original_data.shape[1])
    emit("train_lm", card=card, model="char-lm-bench 6x512 h8 ffn2048 "
         "v256 T512", mb=wf.loader.max_minibatch_size, epochs=1,
         train_steps=steps, valid_steps=valid_steps,
         launches_kernel_run=dict(zip(("fwd", "dkv", "dq"),
                                      kern["launches"])),
         launches_plain_run=dict(zip(("fwd", "dkv", "dq"),
                                     plain["launches"])),
         nll_per_token_kernel={"train": kern["loss"][2],
                               "validation": kern["loss"][1]},
         nll_per_token_plain={"train": plain["loss"][2],
                              "validation": plain["loss"][1]},
         err_kernel={"train": kern["err"][2], "validation": kern["err"][1]},
         err_plain={"train": plain["err"][2], "validation": plain["err"][1]},
         nll_max_rel_diff=loss_rel, final_weight_max_abs_diff=w_max,
         final_weight_p999_abs_diff=w_p999,
         epoch_ms_kernel=kern["wall"] * 1e3,
         epoch_ms_plain=plain["wall"] * 1e3,
         train_tokens_per_s_kernel=train_tokens / kern["wall"],
         train_tokens_per_s_plain=train_tokens / plain["wall"],
         peak_memory_bytes_kernel=kern["peak"],
         peak_memory_bytes_plain=plain["peak"],
         greedy_tokens=tokens, greedy_tokens_plain=plain_tokens)
    want = [n_blocks * (steps + valid_steps), n_blocks * steps,
            n_blocks * steps]
    if kern["launches"] != want or plain["launches"] != [0, 0, 0] \
            or want != [6 * 72, 6 * 64, 6 * 64]:
        raise AssertionError("LM launches %s (plain %s), want %s"
                             % (kern["launches"], plain["launches"], want))
    if not all(math.isfinite(x) for cls in (1, 2)
               for x in kern["loss"][cls]):
        raise AssertionError("non-finite LM loss")
    if loss_rel > TOL_LM_LOSS_REL:
        raise AssertionError("NLL/token kernel vs plain differs by %g "
                             "relative" % loss_rel)
    if not (w_max <= TOL_LM_WEIGHTS_MAX and w_p999 <= TOL_LM_WEIGHTS_P999):
        raise AssertionError("final LM weights kernel vs plain differ: max "
                             "%g, 99.9th percentile %g" % (w_max, w_p999))
    if len(tokens) != LM_N_NEW or tokens != plain_tokens:
        raise AssertionError("greedy tokens from the trained LM differ from "
                             "the plain path: %s vs %s"
                             % (tokens, plain_tokens))
    return wf, dict(zip(("fwd", "dkv", "dq"), kern["launches"])), dict(
        epoch_ms=kern["wall"] * 1e3,
        tokens_per_s=train_tokens / kern["wall"], peak=kern["peak"])


def phase_train_lm_breakdown(card, wf):
    """Where 4 train steps of the bench LM spend their time (kernel
    route): torch.profiler's device busy share, launches per step, top
    kernels and the flash kernels' share."""
    import torch
    step, loader = wf.train_step, wf.loader
    dataset, targets = step._dataset()
    mb = loader.max_minibatch_size
    n_valid = loader.class_lengths[1]
    plan = (n_valid + torch.arange(4 * mb, device=step.device,
                                   dtype=torch.int32)).reshape(4, mb)
    mask = torch.ones(plan.shape, device=step.device)

    def run():
        step._train_plan(step.params, step.opt_state, step._zero_accum(),
                         dataset, targets, plan, mask, 1.0)

    run()                               # warm
    rec = profiled(run, ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"))
    flash = rec.pop("matched_ms")
    busy = rec["device_busy_ms"] or float("nan")
    emit("train_lm_breakdown", card=card, steps=4,
         step_ms=rec["profiled_wall_ms"] / 4,
         launches_per_step=(rec["kernel_launches"] or 0) / 4,
         flash_ms=flash,
         flash_share_of_device={k: v / busy for k, v in flash.items()},
         **rec)


#: the mixed-precision instances of the flash kernels, "<q/k>_<v>"
#: dtypes (the float32 one is held by the kernels and kernels_bwd phases)
AMP_INSTANCES = ("f32_bf16", "bf16_f32", "bf16_bf16")
#: an AMP instance's output, kernel vs plain, times max(1, max|plain|):
#: the largest error of a float32 output within 1e-3, of a bf16 one within
#: one bf16 ulp of its largest element (2^-7: both round float32 sums
#: that differ in their last bits, so an element can land one ulp apart,
#: and an ulp of an element in the top binade is more than 2^-8 of the
#: largest); the mean error within 4e-6, which the control — the plain
#: versions on float32 copies of the inputs, which round no p and no ds
#: — misses wherever the instance rounds (NVIDIA H100 80GB HBM3: the
#: kernels' mean error at most 1.2e-6, the control's at least 1.9e-5)
TOL_AMP_F32 = 1e-3
TOL_AMP_BF16 = 2.0 ** -7
TOL_AMP_MEAN = 4e-6
#: the outputs of each instance whose products take p or ds rounded to
#: bf16 (p to v's and do's dtype, ds to q's and k's)
AMP_ROUNDED = {"f32_bf16": ("o",), "bf16_f32": ("dq", "dk", "dv"),
               "bf16_bf16": ("o", "dq", "dk", "dv")}
#: the bench LM under mixed precision, kernels vs plain attention, same
#: seed: per-epoch NLL/token (relative), as the float32 train_lm's. The
#: kernels round p to bf16 before p·v in the first block's forward, as
#: the reference's kernel does; the plain attention, as the reference's
#: attention_reference, does not where q is float32
TOL_LM_AMP_LOSS_REL = 1e-4


#: the cases of kernels_amp, the bench shape first
AMP_CASES = [
    # (name, B, T, H, KV, D, causal, window, layout)
    ("bench_b16_t512", 16, 512, 8, 8, 64, True, 0, None),
    ("b4_t512", 4, 512, 8, 8, 64, True, 0, None),
    ("window128", 2, 512, 8, 8, 64, True, 128, None),
    ("gqa_8_1_window64", 2, 300, 8, 1, 64, True, 64, None),
    ("noncausal_t127_gqa_4_2", 2, 127, 4, 2, 64, False, 0, None),
    ("t1", 1, 1, 2, 2, 48, True, 0, None),
    ("t65", 2, 65, 4, 4, 64, True, 0, None),
    ("t129", 2, 129, 4, 4, 64, True, 0, None),
    ("d8", 2, 200, 4, 4, 8, True, 0, None),
    ("d32_noncausal", 2, 200, 8, 8, 32, False, 0, None),
    ("d33", 2, 100, 4, 4, 33, True, 0, None),
    ("d40_gqa_4_2", 2, 150, 4, 2, 40, True, 0, None),
    ("d72_noncausal", 2, 140, 4, 4, 72, False, 0, None),
    ("d128_noncausal_t257", 2, 257, 8, 8, 128, False, 0, None),
    ("d160_noncausal", 1, 90, 2, 2, 160, False, 0, None),
    ("d256_gqa_4_2_window100", 1, 333, 4, 2, 256, True, 100, None),
    ("offset_views", 2, 100, 4, 2, 64, True, 0, "offset"),
]


def amp_dtypes(inst):
    """(q/k dtype, v dtype) of an instance name."""
    import torch
    return tuple(torch.bfloat16 if n == "bf16" else torch.float32
                 for n in inst.split("_"))


def amp_inputs(b, t, h, kv, d, seed, inst, layout=None):
    """q, k, v, do on the card in an instance's dtypes (do in q's).
    ``layout`` "offset": each a view one element into its buffer."""
    import torch
    qk, vt = amp_dtypes(inst)
    xs = [x.to(vt if i == 2 else qk)
          for i, x in enumerate(bwd_inputs(b, t, h, kv, d, seed))]
    if layout == "offset":
        def off(x):
            buf = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")
            view = buf[1:].view(x.shape)
            view.copy_(x)
            return view
        xs = [off(x) for x in xs]
    return xs


def amp_outputs(fa, q, k, v, do, causal, window, o=None, lse=None,
                f32=False):
    """The plain versions' o, lse and (dq, dk, dv) in the inputs' dtypes,
    the forward in the kernel's K/V blocks, the backward from ``o`` and
    ``lse`` (the forward's own by default). ``f32``: computed on float32
    copies of the inputs (the control: no p or ds rounded)."""
    xs = (q, k, v, do)
    if f32:
        xs = tuple(x.float() for x in xs)
    po, plse = fa.flash_attention_fwd_reference(
        *xs[:3], causal=causal, window=window,
        block_k=fa.kernel_block_k(q.shape[-1]))
    grads = fa.flash_attention_bwd_reference(
        *xs[:3], po if o is None else o, plse if lse is None else lse,
        xs[3], causal=causal, window=window)
    return dict(o=po.to(q.dtype), lse=plse,
                **{n: g.to(x.dtype) for n, g, x in zip(
                    ("dq", "dk", "dv"), grads, (q, k, v))})


def amp_error(got, want, control=None):
    """One output of an AMP instance against the plain version's: max and
    mean abs error over the elements the plain version has finite, their
    limits, the control's mean error, and whether the NaN patterns
    agree."""
    import torch
    got, want_f = got.float(), want.float()
    live = ~torch.isnan(want_f)
    rec = dict(same_nan=bool(torch.equal(torch.isnan(got), ~live)),
               max=0.0, mean=0.0, control_mean=None)
    if bool(live.any()):
        diff = (got[live] - want_f[live]).abs()
        rec.update(max=float(diff.max()), mean=float(diff.mean()))
        if control is not None:
            rec["control_mean"] = float(
                (control.float()[live] - want_f[live]).abs().mean())
    scale = max(1.0, float(want_f[live].abs().max())) if bool(
        live.any()) else 1.0
    tol = TOL_AMP_BF16 if want.dtype == torch.bfloat16 else TOL_AMP_F32
    rec.update(limit=tol * scale, mean_limit=TOL_AMP_MEAN * scale)
    rec["ok"] = (rec["same_nan"] and rec["max"] <= rec["limit"]
                 and rec["mean"] <= rec["mean_limit"])
    return rec


def phase_kernels_amp(fa):
    """Each mixed-precision instance of the three flash kernels against
    its plain version in the same dtypes on the card; returns the
    largest abs error and the largest share of its limit, by (instance,
    kernel)."""
    import torch
    from veles_tpu_torch.telemetry import counters
    worst, share = {}, {}
    for inst in AMP_INSTANCES:
        for i, case in enumerate(AMP_CASES):
            errs, ok = amp_case(fa, inst, case, 500 + i)
            if not ok:
                raise AssertionError(
                    "flash %s instance disagrees with its plain version "
                    "on %s: %s" % (inst, case[0], errs))
            if case[2] > 1:
                # the control misses where the instance rounds (one key
                # gives p = 1, which rounds to itself): the check sees
                # the reference's rounding points
                missed = {n: errs[n]["control_mean"] > errs[n]["mean_limit"]
                          for n in AMP_ROUNDED[inst]}
                if not all(missed.values()):
                    raise AssertionError(
                        "flash %s instance: the unrounded control meets "
                        "the limits on %s: %s" % (inst, case[0], errs))
            for kern, outs in (("fwd", ("o", "lse")), ("dkv", ("dk", "dv")),
                               ("dq", ("dq",))):
                key = (inst, kern)
                worst[key] = max([worst.get(key, 0.0)]
                                 + [errs[n]["max"] for n in outs])
                share[key] = max([share.get(key, 0.0)] + [
                    max(errs[n]["max"] / errs[n]["limit"],
                        errs[n]["mean"] / errs[n]["mean_limit"])
                    for n in outs])
        # a NaN made by the card's arithmetic (0/0) in q (row 70), k or v
        # (key row 0, which every query row sees): NaN exactly where the
        # plain version has it, the rest within the limits
        nan = torch.zeros((), device="cuda") / torch.zeros((), device="cuda")
        for where in ("q", "k", "v"):
            for causal in (False, True):
                q, k, v, _ = amp_inputs(1, 100, 2, 2, 64, 550, inst)
                {"q": q, "k": k, "v": v}[where][
                    0, 70 if where == "q" else 0, 1, 5] = nan
                o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
                ref = amp_outputs(fa, q, k, v, q, causal, 0)
                torch.cuda.synchronize()
                errs = [amp_error(o, ref["o"]), amp_error(lse, ref["lse"])]
                n_nan = int(torch.isnan(ref["o"].float()).sum())
                emit("kernels_amp", instance=inst, case="nan_in_%s" % where,
                     shape=[1, 100, 2, 2, 64], causal=causal,
                     nan_elements_o=n_nan, errors=errs)
                if n_nan == 0 or not all(e["ok"] for e in errs):
                    raise AssertionError(
                        "flash %s instance does not keep a NaN in %s "
                        "(causal %s): %s" % (inst, where, causal, errs))
    return worst, share


def amp_case(fa, inst, case, seed):
    """One case of ``kernels_amp``: the instance's three kernels on it,
    each output against the plain version's and the control's; emits the
    record and returns (errors by output, whether every check holds)."""
    import torch
    from veles_tpu_torch.telemetry import counters
    name, b, t, h, kv, d, causal, window, layout = case
    names = {k_: fa.launch_counter(n, inst) for k_, n in (
        ("fwd", fa.FWD_LAUNCHES), ("dkv", fa.DKV_LAUNCHES),
        ("dq", fa.DQ_LAUNCHES))}
    q, k, v, do = amp_inputs(b, t, h, kv, d, seed, inst, layout)
    before = {k_: counters.get(n) for k_, n in names.items()}
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                 window=window)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                   window=window)
    launched = {k_: counters.get(n) - before[k_] for k_, n in names.items()}
    ref = amp_outputs(fa, q, k, v, do, causal, window, o, lse)
    ctl = amp_outputs(fa, q, k, v, do, causal, window, o, lse, f32=True)
    torch.cuda.synchronize()
    outs = dict(o=o, lse=lse, dq=got[0], dk=got[1], dv=got[2])
    errs = {n: amp_error(x, ref[n], ctl[n]) for n, x in outs.items()}
    dtypes_ok = (o.dtype == q.dtype and [g.dtype for g in got]
                 == [q.dtype, k.dtype, v.dtype])
    same = all(torch.equal(a, r) for a, r in zip(got, again))
    finite = all(bool(torch.isfinite(x).all()) for x in outs.values())
    emit("kernels_amp", instance=inst, case=name, shape=[b, t, h, kv, d],
         causal=causal, window=window, layout=layout, errors=errs,
         bit_identical_relaunch=same, finite=finite, dtypes_ok=dtypes_ok,
         launches=launched)
    ok = (finite and same and dtypes_ok
          and launched == {"fwd": 1, "dkv": 2, "dq": 2}
          and all(e["ok"] for e in errs.values()))
    return errs, ok


def phase_timing_amp(fa, card):
    """Each mixed-precision instance of the three flash kernels at the
    bench shape (B16 T512 H8 D64 causal) and at B4 T512, with CUDA events:
    kernel, plain version, bound, and the library yardstick — SDPA in bf16
    for the all-bf16 instance, and SDPA on float32 inputs for the mixed
    ones (no library call takes q/k and v in two dtypes); returns the
    records keyed by (instance, kernel, B)."""
    import torch
    import torch.nn.functional as F
    records = {}
    h = kv = 8
    d, t = 64, 512
    scale = 1.0 / math.sqrt(d)
    for b in (16, 4):
        for inst in AMP_INSTANCES:
            q, k, v, do = amp_inputs(b, t, h, kv, d, 9, inst)
            o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
            delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1)
            args = (q, k, v, do, lse, delta, True, 0, scale)
            ms = {"fwd": cuda_time_ms(
                lambda: fa.flash_attention_fwd(q, k, v, causal=True), 100),
                "dkv": cuda_time_ms(lambda: fa.launch_bwd_dkv(*args), 30),
                "dq": cuda_time_ms(lambda: fa.launch_bwd_dq(*args), 30)}
            plain = {"fwd": cuda_time_ms(
                lambda: fa.flash_attention_fwd_reference(q, k, v,
                                                         causal=True), 10)}
            plain["dkv"] = plain["dq"] = cuda_time_ms(
                lambda: fa.flash_attention_bwd_reference(
                    q, k, v, o, lse, do, causal=True), 5)
            lib_dtype = (torch.bfloat16 if inst == "bf16_bf16"
                         else torch.float32)
            qt, kt, vt = (x.transpose(1, 2).to(lib_dtype).detach().clone()
                          .requires_grad_() for x in (q, k, v))
            lib = {"fwd": cuda_time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True), 100)}
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
            dot = do.transpose(1, 2).to(lib_dtype)
            lib["dkv"] = lib["dq"] = cuda_time_ms(lambda: torch.autograd.grad(
                out, (qt, kt, vt), dot, retain_graph=True), 30)
            qb, vb = (2 if n == "bf16" else 4 for n in inst.split("_"))
            work = {"fwd": fa.forward_work(b, t, h, d, True, 0, kv, qb, vb)}
            work.update(fa.backward_work(b, t, h, d, True, 0, kv, qb, vb))
            bounds = {"fwd": fa.forward_bounds(b, t, h, d, True, 0, kv,
                                               inst)}
            bounds.update(fa.backward_bounds(b, t, h, d, True, 0, kv, inst))
            for kern in ("fwd", "dkv", "dq"):
                flops, nbytes = work[kern]
                bound = bounds[kern]
                rec = dict(instance=inst, kernel=kern,
                           shape=[b, t, h, kv, d], causal=True, card=card,
                           ms=ms[kern], plain_ms=plain[kern],
                           library_ms=lib[kern],
                           library=("sdpa bf16" if lib_dtype == torch.bfloat16
                                    else "sdpa float32 (inputs widened)"),
                           flops=flops, bytes=nbytes,
                           bound_ms=bound["tc"], bound_by=bound["bound_by"],
                           bound_f32_ms=bound["f32"],
                           share_of_bound=bound["tc"] / ms[kern])
                emit("timing_amp", **rec)
                records[(inst, kern, b)] = rec
    return records


def phase_train_lm_amp(card, f32_run):
    """The bench LM under mixed precision (``engine.mixed_precision``),
    one epoch from one seed through the kernels and through the plain
    attention, beside the float32 ``train_lm`` of this run (``f32_run``:
    its epoch ms, tokens/s and peak memory); then the same for the bench
    LM without RoPE (its first block's attention takes q, k and v in
    bf16). Returns the
    launches by (instance, kernel): the RoPE run's, and the RoPE-less
    run's of the all-bf16 instance."""
    import torch
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.models import char_lm
    from veles_tpu_torch.ops import flash_attention as fa
    from veles_tpu_torch.telemetry import counters
    totals = {"fwd": fa.FWD_LAUNCHES, "dkv": fa.DKV_LAUNCHES,
              "dq": fa.DQ_LAUNCHES}

    def run(flash, rope=True):
        root.common.engine.flash_attention = bool(flash)
        prng.seed_all(LM_SEED)
        wf = char_lm.build_bench_workflow()
        if not rope:
            # the bench LM without RoPE (not a reference cell): under mixed
            # precision its first block's attention takes q, k and v in bf16
            for unit in wf.forwards:
                if hasattr(unit, "rope"):
                    unit.rope = False
        wf.decision.max_epochs = 1
        wf.initialize()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counters.counters.reset()
        t0 = time.perf_counter()
        wf.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"%s/%s" % (inst, kern): int(counters.get(
            fa.launch_counter(n, inst)))
            for inst in fa.INSTANCES for kern, n in totals.items()}
        return dict(wf=wf, wall=wall, launches=launches,
                    peak=int(torch.cuda.max_memory_allocated()),
                    loss={cls: list(wf.decision.epoch_losses[cls])
                          for cls in (1, 2)},
                    err={cls: list(wf.decision.epoch_metrics[cls])
                         for cls in (1, 2)})

    def greedy(wf):
        """16 greedy tokens from the trained weights, through the kernels
        and through the plain attention."""
        prompt = [int(x) for x in wf.loader.original_data.mem[0][:32]]
        out = []
        for flash in (True, False):
            root.common.engine.flash_attention = flash
            out.append(char_lm.generate(wf, prompt, LM_N_NEW, temperature=0))
        return out

    root.common.engine.mixed_precision = True
    try:
        kern, plain = run(True), run(False)
        norope, norope_plain = run(True, rope=False), run(False, rope=False)
        tokens, plain_tokens = greedy(kern["wf"])
        norope_tokens, norope_plain_tokens = greedy(norope["wf"])
    finally:
        root.common.engine.mixed_precision = False
        root.common.engine.flash_attention = True
    wf = kern["wf"]
    masters = sorted({str(t.dtype) for run_ in (kern, norope)
                      for p in run_["wf"].train_step.params.values()
                      for t in p.values()})

    def rel(a, b):
        return max(abs(x - y) / abs(y) for cls in (1, 2)
                   for x, y in zip(a["loss"][cls], b["loss"][cls]))
    loss_rel, norope_rel = rel(kern, plain), rel(norope, norope_plain)
    steps = wf.loader.class_lengths[2] // wf.loader.max_minibatch_size
    valid_steps = -(-wf.loader.class_lengths[1]
                    // wf.loader.max_minibatch_size)
    train_tokens = (wf.loader.class_lengths[2]
                    * wf.loader.original_data.shape[1])
    emit("train_lm_amp", card=card, model="char-lm-bench 6x512 h8 ffn2048 "
         "v256 T512, engine.mixed_precision", mb=wf.loader.max_minibatch_size,
         epochs=1, train_steps=steps, valid_steps=valid_steps,
         launches_kernel_run={k: v for k, v in kern["launches"].items() if v},
         launches_plain_run={k: v for k, v in plain["launches"].items()
                             if v},
         launches_norope_run={k: v for k, v in norope["launches"].items()
                              if v},
         launches_norope_plain_run={
             k: v for k, v in norope_plain["launches"].items() if v},
         nll_per_token_kernel={"train": kern["loss"][2],
                               "validation": kern["loss"][1]},
         nll_per_token_plain={"train": plain["loss"][2],
                              "validation": plain["loss"][1]},
         nll_per_token_norope={"train": norope["loss"][2],
                               "validation": norope["loss"][1]},
         nll_per_token_norope_plain={"train": norope_plain["loss"][2],
                                     "validation": norope_plain["loss"][1]},
         err_kernel={"train": kern["err"][2], "validation": kern["err"][1]},
         err_plain={"train": plain["err"][2], "validation": plain["err"][1]},
         nll_max_rel_diff=loss_rel, nll_max_rel_diff_norope=norope_rel,
         limit=TOL_LM_AMP_LOSS_REL,
         master_dtypes=masters,
         epoch_ms_kernel=kern["wall"] * 1e3,
         epoch_ms_plain=plain["wall"] * 1e3,
         epoch_ms_norope=norope["wall"] * 1e3,
         epoch_ms_norope_plain=norope_plain["wall"] * 1e3,
         epoch_ms_f32=f32_run["epoch_ms"],
         train_tokens_per_s_kernel=train_tokens / kern["wall"],
         train_tokens_per_s_plain=train_tokens / plain["wall"],
         train_tokens_per_s_f32=f32_run["tokens_per_s"],
         peak_memory_bytes_kernel=kern["peak"],
         peak_memory_bytes_plain=plain["peak"],
         peak_memory_bytes_norope=norope["peak"],
         peak_memory_bytes_f32=f32_run["peak"],
         greedy_tokens=tokens, greedy_tokens_plain=plain_tokens,
         greedy_tokens_norope=norope_tokens,
         greedy_tokens_norope_plain=norope_plain_tokens)
    # block 0 takes (f32, f32, bf16) operands, the later 5 float32: the
    # forward 64 train + 8 validation steps, each backward 64
    fwd, bwd = steps + valid_steps, steps
    want = {"f32_bf16/fwd": fwd, "f32_bf16/dkv": bwd, "f32_bf16/dq": bwd,
            "f32_f32/fwd": 5 * fwd, "f32_f32/dkv": 5 * bwd,
            "f32_f32/dq": 5 * bwd}
    want_norope = {"bf16_bf16/fwd": fwd, "bf16_bf16/dkv": bwd,
                   "bf16_bf16/dq": bwd, "f32_f32/fwd": 5 * fwd,
                   "f32_f32/dkv": 5 * bwd, "f32_f32/dq": 5 * bwd}
    got = {k: v for k, v in kern["launches"].items() if v}
    got_norope = {k: v for k, v in norope["launches"].items() if v}
    if got != want or got_norope != want_norope or any(
            plain["launches"].values()) or any(
            norope_plain["launches"].values()) or fwd != 72 or bwd != 64:
        raise AssertionError("AMP LM launches %s / %s (plain %s / %s), want "
                             "%s / %s" % (got, got_norope, plain["launches"],
                                          norope_plain["launches"], want,
                                          want_norope))
    if not all(math.isfinite(x) for run_ in (kern, plain, norope,
                                             norope_plain)
               for cls in (1, 2) for x in run_["loss"][cls]):
        raise AssertionError("non-finite AMP LM loss")
    if max(loss_rel, norope_rel) > TOL_LM_AMP_LOSS_REL:
        raise AssertionError("AMP NLL/token kernel vs plain differs by %g "
                             "(RoPE-less %g) relative"
                             % (loss_rel, norope_rel))
    if masters != ["torch.float32"]:
        raise AssertionError("AMP masters are %s, not float32" % masters)
    for got_, want_ in ((tokens, plain_tokens),
                        (norope_tokens, norope_plain_tokens)):
        if len(got_) != LM_N_NEW or got_ != want_:
            raise AssertionError("greedy tokens from an AMP-trained LM "
                                 "differ from the plain path: %s vs %s"
                                 % (got_, want_))
    out = {tuple(k.split("/")): v for k, v in got.items()}
    out.update((tuple(k.split("/")), v) for k, v in got_norope.items()
               if not k.startswith("f32_f32"))
    return out


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


def bench_lm():
    """The bench-width LM on the card, weights from numpy seed 0 in the
    reference's layout."""
    from veles_tpu_torch.convert import params_from_jax, random_params
    from veles_tpu_torch.nn.standard_workflow import build_forwards
    model = build_forwards(BENCH_LAYERS)          # default device: card
    return params_from_jax(model, random_params(model, seed=0))


def phase_serve(card):
    import numpy
    import torch
    from veles_tpu_torch.config import root
    from veles_tpu_torch.nn import sampling
    from veles_tpu_torch.restful_api import GenerationAPI
    from veles_tpu_torch.telemetry import counters

    model = bench_lm()
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

    api = GenerationAPI(model, port=0, batch_window=0.5,
                        engine="window").initialize()
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


#: the serve_continuous phase's engine (the reference's knobs, at the
#: bench LM's context) and its load: four requests at each prompt
#: length, two greedy and two sampled, n_new cycling 16/32/48, a seed each
CONT_ENGINE = dict(max_slots=8, buckets=(128, 256, 512, 1024, 2048),
                   max_context=2048, page_size=16, decode_block=1)
CONT_LENGTHS = (60, 120, 250, 480, 900, 1800)
CONT_N_NEW = (16, 32, 48)
CONT_TICKS = 20


def continuous_load():
    import numpy
    rng = numpy.random.RandomState(3)
    reqs = []
    for length in CONT_LENGTHS:
        for j in range(4):
            req = {"prompt": [int(x) for x in rng.randint(0, 256, length)],
                   "n_new": CONT_N_NEW[len(reqs) % 3],
                   "seed": 1000 + len(reqs)}
            if j >= 2:
                req.update(mode="sample", temperature=0.8)
            reqs.append(req)
    return reqs


def post_all(url, requests):
    """POST every request at once, one thread each; (answers, wall s)."""
    results = [None] * len(requests)

    def fire(i):
        results[i] = post(url, requests[i])

    threads = [threading.Thread(target=fire, args=(i,))
               for i in range(len(requests))]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    return results, time.perf_counter() - t0


def pct(values, q):
    import numpy
    return float(numpy.percentile(numpy.asarray(values, float), q))


def phase_serve_continuous(card):
    """The bench LM behind GenerationAPI's continuous engine, against
    the window plane on the same 24 requests in the same run."""
    import torch
    from veles_tpu_torch.nn import sampling
    from veles_tpu_torch.restful_api import GenerationAPI
    from veles_tpu_torch.serving import ContinuousEngine, make_request
    from veles_tpu_torch.telemetry import counters

    model = bench_lm()
    n_blocks = sum(1 for c in BENCH_LAYERS
                   if c["type"] == "transformer_block")
    requests = continuous_load()
    # CUDA / cuBLAS warm-up for both planes, outside the measured runs
    sampling.generate(model, requests[0]["prompt"], 2, temperature=0)
    warm = ContinuousEngine(model, name="warm", **CONT_ENGINE).start()
    try:
        warm.serve([make_request(requests[0]["prompt"], 2),
                    make_request(requests[-1]["prompt"], 2,
                                 temperature=0.8)])
    finally:
        warm.stop()
    del warm
    torch.cuda.synchronize()

    planes = {}
    for kind in ("window", "continuous"):
        api = GenerationAPI(model, port=0, batch_window=0.5, engine=kind,
                            **CONT_ENGINE).initialize()
        engine = api._engine
        try:
            counters.counters.reset()
            torch.cuda.reset_peak_memory_stats()
            results, wall = post_all(
                "http://127.0.0.1:%d/generate" % api.port, requests)
            torch.cuda.synchronize()
            snap = counters.counters.snapshot()
            peak_bytes = torch.cuda.max_memory_allocated()
            stats = engine.stats() if engine is not None else None
        finally:
            api.stop()
        for i, res in enumerate(results):
            if res is None or res[0] != 200:
                raise AssertionError("%s request %d failed: %r"
                                     % (kind, i, res))
        planes[kind] = dict(results=results, wall=wall, snap=snap,
                            engine=engine, stats=stats, peak=peak_bytes,
                            tokens=sum(len(r[1]["tokens"])
                                       for r in results))

    win, cont = planes["window"], planes["continuous"]
    engine, snap = cont["engine"], cont["snap"]
    if engine is None:
        raise AssertionError("GenerationAPI built no continuous engine")
    for i, (w, c) in enumerate(zip(win["results"], cont["results"])):
        if c[1].get("engine") != "continuous":
            raise AssertionError("request %d was not served by the engine"
                                 % i)
        if c[1]["tokens"] != w[1]["tokens"]:
            raise AssertionError(
                "request %d (T=%d, %s): continuous tokens %r != window "
                "tokens %r" % (i, len(requests[i]["prompt"]),
                               requests[i].get("mode", "greedy"),
                               c[1]["tokens"], w[1]["tokens"]))
    n = len(requests)
    if not engine.admitted == engine.retired == n:
        raise AssertionError("admitted %d, retired %d, sent %d"
                             % (engine.admitted, engine.retired, n))
    prefills = snap.get("veles_serving_prefill_dispatches_total", 0)
    launches = snap.get("veles_flash_attention_launches_total", 0)
    if prefills != n or launches != n_blocks * prefills:
        raise AssertionError("flash launches %d, prefills %d: want %d x "
                             "%d" % (launches, prefills, n_blocks, n))
    want = {}
    for req in requests:
        b = engine.scheduler.bucket_for(len(req["prompt"]))
        want[b] = want.get(b, 0) + 1
    if engine.prefills_by_bucket != want:
        raise AssertionError("prefills by bucket %r, want %r"
                             % (engine.prefills_by_bucket, want))
    if not 2 <= engine.peak_slots <= CONT_ENGINE["max_slots"]:
        raise AssertionError("peak slots %d" % engine.peak_slots)
    if engine.page_pool.ledger() or engine.page_pool.in_use():
        raise AssertionError("pages left in use: %r"
                             % engine.page_pool.ledger())
    tps = {k: planes[k]["tokens"] / planes[k]["wall"] for k in planes}
    if not tps["continuous"] > tps["window"]:
        raise AssertionError("continuous %.1f tokens/s <= window %.1f"
                             % (tps["continuous"], tps["window"]))
    lat = {k: [r[2] for r in planes[k]["results"]] for k in planes}
    ttft = list(engine.ttft_ms)
    emit("serve_continuous", card=card, requests=n,
         engine=CONT_ENGINE, prompt_lengths=list(CONT_LENGTHS),
         n_new=list(CONT_N_NEW), tokens=cont["tokens"],
         wall_s=cont["wall"], tokens_per_s=tps["continuous"],
         window_wall_s=win["wall"], window_tokens_per_s=tps["window"],
         speedup=tps["continuous"] / tps["window"],
         request_ms_p50=pct(lat["continuous"], 50),
         request_ms_max=max(lat["continuous"]),
         window_request_ms_p50=pct(lat["window"], 50),
         window_request_ms_max=max(lat["window"]),
         ttft_ms_p50=pct(ttft, 50), ttft_ms_max=max(ttft),
         decode_tick_ms_p50=pct(engine.decode_ms, 50),
         decode_ticks=snap.get("veles_serving_decode_dispatches_total", 0),
         prefills=prefills, prefills_by_bucket=engine.prefills_by_bucket,
         flash_launches=launches, n_blocks=n_blocks,
         peak_slots=engine.peak_slots, peak_pages=engine.peak_pages,
         pages_total=engine.pages,
         kv_pool_bytes=cont["stats"]["kv_pool_bytes"],
         peak_memory_bytes=int(cont["peak"]),
         window_peak_memory_bytes=int(win["peak"]))
    phase_serve_continuous_breakdown(card, model, requests)
    return launches


def phase_serve_continuous_breakdown(card, model, requests):
    """torch.profiler over CONT_TICKS decode ticks of the engine while
    all eight rows are live: device ms by kernel, launches a tick, the
    device's idle share."""
    import torch
    from veles_tpu_torch.serving import ContinuousEngine, make_request
    from veles_tpu_torch.serving.scheduler import Ticket
    engine = ContinuousEngine(model, name="profiled", **CONT_ENGINE)
    try:
        for req in requests[:CONT_ENGINE["max_slots"]]:
            engine.submit(make_request(req["prompt"], CONT_TICKS + 8,
                                       temperature=req.get(
                                           "temperature", 0.0),
                                       seed=req["seed"]), Ticket())
        with torch.inference_mode():
            engine._tick()            # the admissions and one step
            live = engine.scheduler.busy_count()
            if live != CONT_ENGINE["max_slots"]:
                raise AssertionError("%d rows live, not %d"
                                     % (live, CONT_ENGINE["max_slots"]))

            def ticks():
                for _ in range(CONT_TICKS):
                    engine._tick()

            rec = profiled(ticks)
    finally:
        engine.stop()
    emit("serve_continuous_breakdown", card=card, live_rows=live,
         ticks=CONT_TICKS,
         tick_ms=rec["profiled_wall_ms"] / CONT_TICKS,
         launches_per_tick=(None if rec["kernel_launches"] is None
                            else rec["kernel_launches"] / CONT_TICKS),
         **rec)


def conv_cases():
    """(name, unit, input shape, parameter shapes) of the conv family, as
    tests/test_torch_gpu.py's."""
    from veles_tpu_torch.nn import activation, conv, deconv, depooling
    from veles_tpu_torch.nn import pooling

    def unit(cls, **kw):
        return cls(None, name="u", **kw)
    acts = [(c.MAPPING, unit(c), (8, 16, 16, 32), {}) for c in (
        activation.ForwardTanh, activation.ForwardRelu,
        activation.ForwardStrictRelu, activation.ForwardSigmoid,
        activation.ForwardLog)]
    acts.append(("activation_mul", unit(activation.ForwardMul, factor=0.37),
                 (8, 16, 16, 32), {}))
    return [
        ("conv_3x3_64", unit(conv.Conv, n_kernels=64, padding=(1, 1, 1, 1)),
         (8, 32, 32, 64), {"weights": (3, 3, 64, 64), "bias": (64,)}),
        ("conv_tanh_stride_asym", unit(
            conv.ConvTanh, n_kernels=32, kx=5, ky=3, sliding=(2, 1),
            padding=(2, 0, 1, 1)), (8, 33, 31, 16),
         {"weights": (3, 5, 16, 32), "bias": (32,)}),
        ("conv_relu_rgb_stem", unit(conv.ConvRelu, n_kernels=64, kx=5, ky=5,
                                    padding=(2, 2, 2, 2)), (8, 32, 32, 3),
         {"weights": (5, 5, 3, 64), "bias": (64,)}),
        ("conv_sigmoid_no_bias", unit(
            conv.ConvSigmoid, n_kernels=16, kx=3, ky=2, sliding=(1, 2),
            padding=(0, 1, 2, 0), include_bias=False), (4, 17, 19, 8),
         {"weights": (2, 3, 8, 16)}),
        ("deconv_3x3_128_64", unit(deconv.Deconv, n_channels=64,
                                   padding=(1, 1, 1, 1)), (8, 32, 32, 128),
         {"weights": (3, 3, 128, 64)}),
        ("deconv_s2_asym_bias", unit(
            deconv.Deconv, n_channels=16, kx=4, ky=3, sliding=(2, 2),
            padding=(1, 0, 2, 1), include_bias=True), (4, 15, 17, 32),
         {"weights": (3, 4, 32, 16), "bias": (16,)}),
        ("max_pool_3_2_ceil", unit(pooling.MaxPooling, kx=3, ky=3,
                                   sliding=(2, 2)), (8, 33, 32, 32), {}),
        ("max_pool_ties", unit(pooling.MaxPooling, kx=2, ky=2),
         (8, 16, 15, 32), {}),
        ("avg_pool_2_ceil", unit(pooling.AvgPooling, kx=2, ky=2),
         (8, 33, 31, 32), {}),
        ("avg_pool_k_below_s", unit(pooling.AvgPooling, kx=2, ky=2,
                                    sliding=(3, 3)), (4, 17, 17, 8), {}),
        ("depool_2", unit(depooling.Depooling), (8, 16, 16, 64), {}),
    ] + acts


def conv_inputs(name, x_shape, p_shapes, seed):
    import numpy
    rng = numpy.random.RandomState(seed)
    if name.endswith("ties"):
        x = (rng.rand(*x_shape) < 0.7).astype("float32")
    else:
        x = rng.randn(*x_shape).astype("float32")
    params = {k: (rng.randn(*s) * (0.1 if k == "bias" else 1.0 / numpy.sqrt(
        numpy.prod(s[:-1])))).astype("float32") for k, s in p_shapes.items()}
    return x, params


def unit_outputs(u, x, params, device, seed):
    """y and the gradients of sum(y · g) on ``device``, as CPU tensors."""
    import numpy
    import torch
    tp = {k: torch.from_numpy(v).to(device).requires_grad_(True)
          for k, v in params.items()}
    tx = torch.from_numpy(x).to(device).requires_grad_(True)
    y = u.apply(tp, tx)
    g = torch.from_numpy(numpy.random.RandomState(seed + 1).randn(
        *y.shape).astype("float32")).to(device)
    (y * g).sum().backward()
    out = {"y": y, "dx": tx.grad, **{"d" + k: t.grad for k, t in tp.items()}}
    return {k: v.detach().cpu() for k, v in out.items()}


def conv_error(got, want):
    return max(float((got[k] - w).abs().max()) / max(1.0, float(
        w.abs().max())) for k, w in want.items())


def kernel_launches():
    """Launches of every hand-written kernel since the counters' reset."""
    from veles_tpu_torch.telemetry import counters
    return int(sum(v for k, v in counters.counters.snapshot().items()
                   if "launches" in k))


def phase_conv_units(card):
    """Each conv-family unit, forward and backward, on the card against
    the port on the CPU; the TF32 control; relaunch bits."""
    import torch
    from veles_tpu_torch.telemetry import counters
    if torch.backends.cudnn.allow_tf32:
        raise AssertionError("cuDNN TF32 is on: the f32 policy was undone")
    counters.counters.reset()
    worst, same_bits_again = {}, {}
    cases = conv_cases()
    for i, (name, u, x_shape, p_shapes) in enumerate(cases):
        x, params = conv_inputs(name, x_shape, p_shapes, seed=100 + i)
        want = unit_outputs(u, x, params, "cpu", 100 + i)
        got = unit_outputs(u, x, params, "cuda", 100 + i)
        again = unit_outputs(u, x, params, "cuda", 100 + i)
        worst[name] = conv_error(got, want)
        same_bits_again[name] = all(torch.equal(got[k], again[k])
                                    for k in got)
        if i == 0:
            control = (u, x, params, want)
    u, x, params, want = control
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32_err = conv_error(unit_outputs(u, x, params, "cuda", 100), want)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    launches = kernel_launches()
    emit("conv_units", card=card, cases=len(worst), limit=TOL_CONV,
         worst_rel_err=worst, tf32_control_rel_err=tf32_err,
         tf32_control_case=cases[0][0],
         relaunch_bit_identical=same_bits_again,
         hand_written_kernel_launches=launches)
    bad = {k: v for k, v in worst.items() if not v <= TOL_CONV}
    if bad:
        raise AssertionError("conv units off the CPU's: %s" % bad)
    if not tf32_err > TOL_CONV:
        raise AssertionError("the TF32 control (%g) does not exceed the "
                             "limit: the test cannot tell a TF32 leak"
                             % tf32_err)
    if launches:
        raise AssertionError("the conv units launched %d hand-written "
                             "kernels" % launches)


def ae_workflow(amp, device=None):
    """The bench AE from AE_SEED, two epochs, initialised on ``device``
    (default: the card); ``amp``: the reference bench's mixed precision
    with a bf16 dataset."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.models import imagenet_ae
    root.common.engine.mixed_precision = amp
    root.common.engine.dataset_dtype = "bfloat16" if amp else None
    prng.seed_all(AE_SEED)
    wf = imagenet_ae.build_bench_workflow()
    wf.decision.max_epochs = 2          # the bench config never stops
    wf.initialize(device=device)
    return wf


def train_steps(wf, n):
    """The workflow's own train step over its first ``n`` train
    minibatches (the train rows in order), from its params, leaving them
    as they were: yields each step's loss and ``opt_state`` (for SGD, the
    step's delta)."""
    import torch
    ts = wf.train_step
    dataset, targets = ts._dataset()
    mb = wf.loader.max_minibatch_size
    start = wf.loader.class_lengths[0] + wf.loader.class_lengths[1]
    mask = torch.ones(mb, dtype=torch.float32, device=ts.device)
    params, opt = ts.params, ts.opt_state
    for k in range(n):
        idx = torch.arange(start + k * mb, start + (k + 1) * mb,
                           dtype=torch.int32, device=ts.device)
        params, opt, _, loss = ts._train_step(
            params, opt, ts._zero_accum(), dataset, targets, idx, mask, 1.0)
        yield loss, opt


def first_train_steps(wf, n=2):
    """The loss and the SGD delta of each of the first ``n`` train steps,
    on the host."""
    losses, deltas = [], []
    for loss, opt in train_steps(wf, n):
        losses.append(float(loss))
        deltas.append({u: {k: t.cpu() for k, t in p.items()}
                       for u, p in opt.items()})
    return losses, deltas


def conv_flops_per_sample(wf):
    """Forward FLOPs of one sample: 2 · MACs of each conv (at every
    output position) and deconv (at every input position)."""
    from veles_tpu_torch.nn.conv import Conv
    from veles_tpu_torch.nn.deconv import Deconv
    total = 0
    for f in wf.forwards:
        if isinstance(f, (Conv, Deconv)):
            ky, kx, c_in, c_out = f.param_arrays()["weights"].shape
            _, h, w, _ = (f.output if isinstance(f, Conv) else f.input).shape
            total += 2 * h * w * ky * kx * c_in * c_out
    return total


def stamp_epochs(wf):
    """Host-clock stamps at each epoch's end (after the device drains)."""
    import torch
    stamps = []
    finish = wf.decision._finish_epoch

    def stamped():
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        finish()
    wf.decision._finish_epoch = stamped
    return stamps


def one_more_epoch(wf):
    """Lift the stop and run one more epoch."""
    wf.decision.complete <<= False
    wf.decision.max_epochs = wf.decision.epoch_number + 1
    wf.run()


def phase_train_ae(card):
    """The bench AE two epochs in float32 and two under the bench's
    mixed precision; the float32 run's first steps against the CPU."""
    import torch
    from veles_tpu_torch.config import root
    from veles_tpu_torch.telemetry import counters
    records = {}
    try:
        for amp in (False, True):
            wf = ae_workflow(amp)
            name = "amp_bf16_data" if amp else "f32"
            rec = {}
            if not amp:
                host = ae_workflow(False, device="cpu")
                cpu_loss, cpu_d = first_train_steps(host)
                del host
                card_loss, card_d = first_train_steps(wf)
                rec["step_loss_cpu"] = cpu_loss
                rec["step_loss_card"] = card_loss
                rec["step_loss_rel_diff"] = max(
                    abs(a - b) / abs(b) for a, b in zip(card_loss, cpu_loss))
                rec["step_update_rel_diff"] = max(
                    float((c[n][k] - h[n][k]).abs().max())
                    / float(h[n][k].abs().max())
                    for c, h in zip(card_d, cpu_d) for n in h for k in h[n])
            fwd = conv_flops_per_sample(wf)
            lengths = wf.loader.class_lengths
            epoch_flops = (lengths[2] * 3 + lengths[1]) * fwd
            stamps = stamp_epochs(wf)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            counters.counters.reset()
            t0 = time.perf_counter()
            wf.run()
            epoch_s = [b - a for a, b in zip([t0] + stamps, stamps)]
            rec["hand_written_kernel_launches"] = kernel_launches()
            rec["peak_memory_bytes"] = int(torch.cuda.max_memory_allocated())
            prof = profiled(lambda: one_more_epoch(wf))
            d = wf.decision
            steady = epoch_s[-1]
            tflops = epoch_flops / steady / 1e12
            rec.update(
                epoch_ms=[t * 1e3 for t in epoch_s],
                rmse={"train": d.epoch_metrics[2],
                      "validation": d.epoch_metrics[1]},
                train_samples_per_s=lengths[2] / steady,
                model_tflops_per_s=tflops,
                share_of_bf16_peak=tflops / PEAK_TFLOPS["bf16"],
                share_of_f32_peak=tflops / PEAK_TFLOPS["f32"],
                fwd_gflop_per_sample=fwd / 1e9,
                epoch_tflop=epoch_flops / 1e12,
                master_dtypes=sorted({str(t.dtype) for p in
                                      wf.train_step.params.values()
                                      for t in p.values()}),
                dataset_dtype=str(wf.loader.original_data.mem.dtype),
                profiled_epoch=prof)
            records[name] = rec
    finally:
        root.common.engine.mixed_precision = False
        root.common.engine.dataset_dtype = None
    emit("train_ae", card=card, model="imagenet-ae-bench 128x128 "
         "conv5x5x64-pool-conv3x3x128-pool-conv3x3x128-depool-deconv3x3x64-"
         "depool-deconv5x5x3", mb=64, epochs=2,
         rows={"train": lengths[2], "validation": lengths[1]},
         peaks_tflops=PEAK_TFLOPS, **records)
    f32 = records["f32"]
    if not f32["step_loss_rel_diff"] <= TOL_AE_STEP_REL \
            or not f32["step_update_rel_diff"] <= TOL_AE_STEP_REL:
        raise AssertionError("the first AE train steps on the card differ "
                             "from the CPU's: loss %g, updates %g relative"
                             % (f32["step_loss_rel_diff"],
                                f32["step_update_rel_diff"]))
    if abs(f32["fwd_gflop_per_sample"] - 1.8245) > 5e-5:
        raise AssertionError("counted %r GFLOP a sample, want 1.8245"
                             % f32["fwd_gflop_per_sample"])
    for name, rec in records.items():
        valid = rec["rmse"]["validation"]
        if not all(math.isfinite(x) for x in valid + rec["rmse"]["train"]):
            raise AssertionError("%s: non-finite rmse" % name)
        if not valid[1] < valid[0]:
            raise AssertionError("%s: validation rmse did not fall: %s"
                                 % (name, valid))
        if rec["hand_written_kernel_launches"]:
            raise AssertionError("%s: the AE launched hand-written kernels"
                                 % name)
        if rec["master_dtypes"] != ["torch.float32"]:
            raise AssertionError("%s: masters %s" % (name,
                                                     rec["master_dtypes"]))
    if records["amp_bf16_data"]["dataset_dtype"] != "torch.bfloat16":
        raise AssertionError("the AMP run's dataset is not bf16")


def phase_train_cifar(card):
    """CIFAR-10 caffe quick, one epoch on the card, then a profiled
    window of train steps."""
    import torch
    from veles_tpu_torch import prng
    from veles_tpu_torch.models import cifar
    from veles_tpu_torch.telemetry import counters
    prng.seed_all(SEED)
    wf = cifar.build_workflow(epochs=1)
    wf.initialize()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters.counters.reset()
    t0 = time.perf_counter()
    wf.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    peak = int(torch.cuda.max_memory_allocated())
    # a window of the train segment: a whole epoch's trace (~117k
    # launches) takes the profiler about a minute to read back
    def window():
        for _ in train_steps(wf, CIFAR_STEPS):
            pass
    prof = profiled(window)
    d = wf.decision
    lengths = wf.loader.class_lengths
    emit("train_cifar", card=card, model="cifar10-caffe-quick",
         mb=wf.loader.max_minibatch_size,
         rows={"train": lengths[2], "validation": lengths[1]},
         valid_err=d.epoch_metrics[1], train_err=d.epoch_metrics[2],
         train_loss=d.epoch_losses[2], epoch_ms=wall * 1e3,
         train_samples_per_s=lengths[2] / wall, peak_memory_bytes=peak,
         fused_fc_engaged=wf.train_step._fused_fc is not None,
         hand_written_kernel_launches=launches,
         profiled_train_steps=CIFAR_STEPS, profiled=prof)
    errs = d.epoch_metrics[1] + d.epoch_metrics[2]
    if not all(math.isfinite(x) and 0 <= x <= 1 for x in errs) \
            or not all(math.isfinite(x) for x in d.epoch_losses[2]):
        raise AssertionError("CIFAR: non-finite metrics %s" % errs)
    if launches:
        raise AssertionError("CIFAR launched %d hand-written kernels"
                             % launches)


#: recurrent units on the card vs the port on the CPU, float32 (max abs
#: error over max(1, max|cpu|): cuBLAS sums in another order)
TOL_RECURRENT = 1e-4
#: (name, layer type, unit config, input shape (B, T, D)): BASELINE #5's
#: LSTM, the bench-width LSTM and SSM block of ``serve_recurrent``, and
#: small odd shapes
RECURRENT_CASES = [
    ("lstm_genre", "lstm", {"hidden_size": 64}, (60, 64, 24)),
    ("lstm_bench_seq", "lstm", {"hidden_size": 512,
                                "return_sequences": True}, (8, 16, 512)),
    ("lstm_odd_seq", "lstm", {"hidden_size": 33, "return_sequences": True,
                              "forget_bias": 0.5}, (3, 13, 7)),
    ("rnn_seq", "rnn", {"hidden_size": 64, "return_sequences": True},
     (4, 17, 32)),
    ("rnn_last", "rnn", {"hidden_size": 48}, (5, 9, 24)),
    ("ssm_bench", "ssm_block", {"n_heads": 4}, (8, 16, 512)),
    ("ssm_small", "ssm_block", {"n_heads": 2}, (3, 9, 8)),
]
#: BASELINE #5's first train steps, card vs CPU from the same weights
#: (relative), and its epochs on the card
TOL_GENRE_STEP_REL = 1e-4
GENRE_EPOCHS = 5
GENRE_SEED = 55
GENRE_PROFILED_STEPS = 4
#: the reference's serving defaults (``root.common.serving``), which
#: GenerationAPI takes when given none
RECURRENT_ENGINE = dict(max_slots=8, max_context=640, page_size=16,
                        decode_block=1)
RECURRENT_LENGTHS = (60, 120, 250, 512)
RECURRENT_N_NEW = (16, 32, 48)
RECURRENT_TICKS = 10
#: the reference's equal-HBM bar (bench.py O1_HBM_MULTIPLIER): a slot's
#: state must undercut the paged transformer's per-slot KV rows by this
#: factor at the same geometry
O1_HBM_MULTIPLIER = 4.0


def recurrent_case(kind, cfg, shape, seed):
    """A training unit of ``kind`` on an input of ``shape``, its input and
    parameters from a numpy seed (weights at 1/sqrt(fan_in), biases
    small and non-zero, ``a_log`` the reference's decay spread)."""
    import numpy
    from veles_tpu_torch.memory import Array
    from veles_tpu_torch.nn import rnn, ssm
    cls = {"lstm": rnn.LSTM, "rnn": rnn.RNN, "ssm_block": ssm.SSMBlock}[kind]
    rng = numpy.random.RandomState(seed)
    x = rng.randn(*shape).astype("float32")
    u = cls(None, name="u", **cfg)
    u.input = Array(x, name="x")
    d = shape[-1]
    if kind == "ssm_block":
        params = {k: rng.randn(d, d) / numpy.sqrt(d)
                  for k in ("wq", "wk", "wv", "wg", "wo")}
        params["a_log"] = ssm.decay_logits(cfg["n_heads"], 0.6, 0.95)
    else:
        h = cfg["hidden_size"]
        g = (4 if kind == "lstm" else 1) * h
        params = {"weights": rng.randn(d + h, g) / numpy.sqrt(d + h),
                  "bias": rng.randn(g) * 0.1}
    return u, x, {k: v.astype("float32") for k, v in params.items()}


def scan_step_equal(u, x, params, device):
    """Whether the unit's scan equals a loop of its step body bit for bit
    on ``device`` (outputs and final state)."""
    import torch
    tp = {k: torch.from_numpy(v).to(device) for k, v in params.items()}
    tx = torch.from_numpy(x).to(device)
    with torch.no_grad():
        st0 = u.init_state(x.shape[0], device=device)
        ys, st_scan = u.scan_state(tp, tx, st0)
        st, loop = st0, []
        for t in range(x.shape[1]):
            y, st = u.step_state(tp, tx[:, t].contiguous(), st)
            loop.append(y)
    return bool(torch.equal(ys, torch.stack(loop, dim=1))
                and all(torch.equal(st_scan[k], st[k]) for k in st))


def row_count_bits():
    """Whether a product's first row has the same bits at every row count
    on the card: the bench-width LSTM's input product (M, 512) @ (512,
    2048) and the SSM read (M·4 heads of (1, 128) @ (128, 128)), at M 1,
    2, 3 and 16 against M 8 (the recurrent lane's rows)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((16, 512), generator=g, device="cuda")
    w = torch.randn((512, 2048), generator=g, device="cuda")
    q = torch.randn((16, 4, 128), generator=g, device="cuda")
    s = torch.randn((16, 4, 128, 128), generator=g, device="cuda")
    out = {}
    for name, fn in (("lstm_gates", lambda m: (x[:m] @ w)[0]),
                     ("ssm_read", lambda m: torch.einsum(
                         "bhd,bhde->bhe", q[:m], s[:m])[0])):
        ref = fn(8)
        out[name] = {str(m): bool(torch.equal(fn(m), ref))
                     for m in (1, 2, 3, 16)}
    return out


def phase_recurrent_units(card):
    """LSTM, RNN and SSM block units, forward and the gradients of
    sum(y · g), on the card against the port on the CPU; scan ↔ step
    bit identity on the card; whether a product row's bits depend on
    the row count there."""
    from veles_tpu_torch.telemetry import counters
    t0 = time.perf_counter()
    counters.counters.reset()
    worst, identical = {}, {}
    for i, (name, kind, cfg, shape) in enumerate(RECURRENT_CASES):
        u, x, params = recurrent_case(kind, cfg, shape, seed=300 + i)
        want = unit_outputs(u, x, params, "cpu", 300 + i)
        got = unit_outputs(u, x, params, "cuda", 300 + i)
        worst[name] = conv_error(got, want)
        identical[name] = scan_step_equal(u, x, params, "cuda")
    launches = kernel_launches()
    rows = row_count_bits()
    emit("recurrent_units", card=card, cases=len(worst),
         limit=TOL_RECURRENT, worst_rel_err=worst,
         scan_equals_step=identical, row_bits_equal_to_m8=rows,
         hand_written_kernel_launches=launches,
         phase_s=time.perf_counter() - t0)
    bad = {k: v for k, v in worst.items() if not v <= TOL_RECURRENT}
    if bad:
        raise AssertionError("recurrent units off the CPU's: %s" % bad)
    if not all(identical.values()):
        raise AssertionError("scan differs from the step loop on the "
                             "card: %s" % identical)
    if launches:
        raise AssertionError("the recurrent units launched %d hand-written "
                             "kernels" % launches)


def genre_workflow(device=None):
    from veles_tpu_torch import prng
    from veles_tpu_torch.models import genre_recognition
    prng.seed_all(GENRE_SEED)
    wf = genre_recognition.build_workflow(epochs=GENRE_EPOCHS)
    wf.initialize(device=device)
    return wf


def phase_train_genre(card):
    """BASELINE #5 (LSTM 64 over T 64 × 24, mb 60, lr 0.05, 1,800 / 360
    rows) on the card: its first two train steps against the CPU from
    the same weights, then GENRE_EPOCHS epochs, then a profiled window
    of train steps."""
    import torch
    from veles_tpu_torch.telemetry import counters
    t_phase = time.perf_counter()
    host = genre_workflow("cpu")
    cpu_loss, cpu_d = first_train_steps(host)
    del host
    wf = genre_workflow()
    card_loss, card_d = first_train_steps(wf)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card_loss, cpu_loss))
    update_rel = max(float((c[n][k] - h[n][k]).abs().max())
                     / float(h[n][k].abs().max())
                     for c, h in zip(card_d, cpu_d) for n in h for k in h[n])
    stamps = stamp_epochs(wf)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters.counters.reset()
    t0 = time.perf_counter()
    wf.run()
    epoch_s = [b - a for a, b in zip([t0] + stamps, stamps)]
    launches = kernel_launches()
    peak = int(torch.cuda.max_memory_allocated())

    def window():
        for _ in train_steps(wf, GENRE_PROFILED_STEPS):
            pass
    prof = profiled(window)
    d = wf.decision
    lengths = wf.loader.class_lengths
    steady = epoch_s[-1]
    emit("train_genre", card=card, model="genre-lstm lstm64-softmax6",
         seq_len=64, features=24, mb=wf.loader.max_minibatch_size,
         rows={"train": lengths[2], "validation": lengths[1]},
         step_loss_cpu=cpu_loss, step_loss_card=card_loss,
         step_loss_rel_diff=loss_rel, step_update_rel_diff=update_rel,
         epochs=d.epoch_number, epoch_ms=[t * 1e3 for t in epoch_s],
         valid_err=d.epoch_metrics[1], train_err=d.epoch_metrics[2],
         train_loss=d.epoch_losses[2],
         train_samples_per_s=lengths[2] / steady, peak_memory_bytes=peak,
         hand_written_kernel_launches=launches,
         profiled_train_steps=GENRE_PROFILED_STEPS,
         launches_per_train_step=(
             None if prof["kernel_launches"] is None
             else prof["kernel_launches"] / GENRE_PROFILED_STEPS),
         profiled=prof, phase_s=time.perf_counter() - t_phase)
    if not loss_rel <= TOL_GENRE_STEP_REL \
            or not update_rel <= TOL_GENRE_STEP_REL:
        raise AssertionError("genre's first train steps on the card differ "
                             "from the CPU's: loss %g, updates %g relative"
                             % (loss_rel, update_rel))
    valid = d.epoch_metrics[1]
    if d.epoch_number != GENRE_EPOCHS or not all(
            math.isfinite(x) for x in valid + d.epoch_losses[2]):
        raise AssertionError("genre: %d epochs, metrics %s"
                             % (d.epoch_number, valid))
    if not valid[-1] < valid[0]:
        raise AssertionError("genre: validation error did not fall: %s"
                             % valid)
    if launches:
        raise AssertionError("genre launched %d hand-written kernels"
                             % launches)


def recurrent_lm(arch):
    """The char LM of ``arch`` at the bench LM's width (dim 512, 6
    blocks) through ``char_lm.build_workflow``, on the card, weights from
    numpy seed 0 in the reference's layout."""
    from veles_tpu_torch.convert import params_from_jax, random_params
    from veles_tpu_torch.models import char_lm
    from veles_tpu_torch.nn.standard_workflow import build_forwards
    layers = char_lm.build_workflow(arch=arch, dim=512,
                                    n_blocks=6).layers_config
    model = build_forwards(layers)
    return params_from_jax(model, random_params(model, seed=0))


def recurrent_load(vocab):
    import numpy
    rng = numpy.random.RandomState(4)
    reqs = []
    for length in RECURRENT_LENGTHS:
        for j in range(4):
            req = {"prompt": [int(x) for x in rng.randint(0, vocab, length)],
                   "n_new": RECURRENT_N_NEW[len(reqs) % 3],
                   "seed": 2000 + len(reqs)}
            if j >= 2:
                req.update(mode="sample", temperature=0.8)
            reqs.append(req)
    return reqs


def paged_kv_bytes_per_slot():
    """The paged transformer twin's KV rows a slot holds at the lane's
    geometry: the bench LM behind a ContinuousEngine of the same
    max_slots, max_context and page size (its pool built, not run)."""
    from veles_tpu_torch.serving import ContinuousEngine
    eng = ContinuousEngine(bench_lm(), max_slots=RECURRENT_ENGINE[
        "max_slots"], max_context=RECURRENT_ENGINE["max_context"],
        page_size=RECURRENT_ENGINE["page_size"], name="paged_twin")
    eng._ensure_pool()
    return sum(t.numel() * t.element_size() for pair in eng._caches
               for t in pair) // eng.max_slots


def phase_serve_recurrent(card):
    """The LSTM LM and the SSM LM at the bench LM's width behind
    GenerationAPI's default engine, which must land on the O(1)-state
    lane: 16 requests at once, pooled against solo, the state pool's
    bytes flat, slots at equal memory against the paged transformer,
    then a profiled admission and RECURRENT_TICKS decode ticks."""
    import torch
    from veles_tpu_torch.restful_api import GenerationAPI
    from veles_tpu_torch.serving import (RecurrentEngine,
                                         generate_recurrent, make_request)
    from veles_tpu_torch.telemetry import counters
    t_phase = time.perf_counter()
    kv_per_slot = paged_kv_bytes_per_slot()
    records = {}
    for arch in ("lstm", "ssm"):
        model = recurrent_lm(arch)
        requests = recurrent_load(model.layers["embedding0"].vocab_size)
        # CUDA / cuBLAS warm-up outside the measured run
        generate_recurrent(model, requests[0]["prompt"][:20], 2)
        api = GenerationAPI(model, port=0).initialize()
        engine = api._engine
        try:
            if not isinstance(engine, RecurrentEngine):
                raise AssertionError("%s: the default engine is %r, not the "
                                     "O(1)-state lane" % (arch, engine))
            counters.counters.reset()
            torch.cuda.reset_peak_memory_stats()
            results, wall = post_all(
                "http://127.0.0.1:%d/generate" % api.port, requests)
            torch.cuda.synchronize()
            snap = counters.counters.snapshot()
            peak = int(torch.cuda.max_memory_allocated())
            stats = engine.stats()
        finally:
            api.stop()
        for i, res in enumerate(results):
            if res is None or res[0] != 200 \
                    or res[1].get("engine") != "recurrent":
                raise AssertionError("%s request %d: %r" % (arch, i, res))
        checked = {"greedy": [], "sample": []}
        for req, res in zip(requests, results):
            mode = req.get("mode", "greedy")
            if len(checked[mode]) == 4:
                continue
            solo = generate_recurrent(
                model, req["prompt"], req["n_new"],
                temperature=req.get("temperature", 0.0), seed=req["seed"],
                mode=mode)
            checked[mode].append(solo == res[1]["tokens"])
        # the state pool before and after an 11x longer decode
        eng = RecurrentEngine(model, name="flat", **RECURRENT_ENGINE).start()
        try:
            eng.serve([make_request(requests[0]["prompt"], 4)])
            short_bytes = eng.stats()["kv_pool_bytes"]
            eng.serve([make_request(requests[0]["prompt"], 44)])
            long_stats = eng.stats()
        finally:
            eng.stop()
        breakdown = recurrent_breakdown(model, requests)
        tokens = sum(len(r[1]["tokens"]) for r in results)
        lat = [r[2] for r in results]
        ttft = list(engine.ttft_ms)
        state_per_slot = engine.state_bytes_per_slot()
        rec = dict(
            tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
            request_ms_p50=pct(lat, 50), request_ms_max=max(lat),
            ttft_ms_p50=pct(ttft, 50), ttft_ms_max=max(ttft),
            decode_tick_ms_p50=pct(engine.decode_ms, 50),
            decode_ticks=snap.get("veles_serving_decode_dispatches_total",
                                  0),
            chunk_dispatches=snap.get(
                "veles_serving_prefill_dispatches_total", 0),
            admitted=engine.admitted, retired=engine.retired,
            peak_slots=engine.peak_slots, stats=stats,
            pooled_equals_solo=checked,
            pool_bytes_short=short_bytes,
            pool_bytes_long=long_stats["kv_pool_bytes"],
            pages_total=long_stats["pages_total"],
            state_bytes_per_slot=state_per_slot,
            paged_kv_bytes_per_slot=kv_per_slot,
            hbm_multiplier=kv_per_slot / state_per_slot,
            hand_written_kernel_launches=int(sum(
                v for k, v in snap.items() if "launches" in k)),
            peak_memory_bytes=peak, **breakdown)
        records[arch] = rec
        if not engine.admitted == engine.retired == len(requests):
            raise AssertionError("%s: admitted %d, retired %d of %d"
                                 % (arch, engine.admitted, engine.retired,
                                    len(requests)))
        if not all(checked["greedy"] + checked["sample"]) \
                or len(checked["greedy"] + checked["sample"]) != 8:
            raise AssertionError("%s: pooled tokens differ from the solo "
                                 "decode on the card: %s" % (arch, checked))
        if not short_bytes == long_stats["kv_pool_bytes"] > 0 \
                or long_stats["pages_total"]:
            raise AssertionError("%s: state pool %d bytes at 4 tokens, %d at "
                                 "44, %d pages" % (
                                     arch, short_bytes,
                                     long_stats["kv_pool_bytes"],
                                     long_stats["pages_total"]))
        if rec["hbm_multiplier"] < O1_HBM_MULTIPLIER:
            raise AssertionError("%s: equal-memory multiplier %.2f under "
                                 "%.0f" % (arch, rec["hbm_multiplier"],
                                           O1_HBM_MULTIPLIER))
        if rec["hand_written_kernel_launches"]:
            raise AssertionError("%s: the lane launched hand-written "
                                 "kernels" % arch)
    emit("serve_recurrent", card=card, engine=RECURRENT_ENGINE,
         requests=len(requests), prompt_lengths=list(RECURRENT_LENGTHS),
         n_new=list(RECURRENT_N_NEW), width={"dim": 512, "blocks": 6},
         hbm_bar=O1_HBM_MULTIPLIER, phase_s=time.perf_counter() - t_phase,
         **records)


def recurrent_breakdown(model, requests):
    """torch.profiler over one admission (a 64-token prompt: launches a
    prefill token) and over RECURRENT_TICKS decode ticks while all the
    slots are live: launches a tick, tick ms, the device's idle share."""
    import torch
    from veles_tpu_torch.serving import RecurrentEngine, make_request
    from veles_tpu_torch.serving.scheduler import Ticket
    slots = RECURRENT_ENGINE["max_slots"]
    long = [r for r in requests if len(r["prompt"]) >= 64]
    engine = RecurrentEngine(model, name="profiled", **RECURRENT_ENGINE)
    try:
        with torch.inference_mode():
            engine.submit(make_request(long[0]["prompt"][:64], 1),
                          Ticket())
            prefill = profiled(engine._tick)
            for req in long[:slots]:
                engine.submit(make_request(
                    req["prompt"][:16], RECURRENT_TICKS + 8,
                    temperature=req.get("temperature", 0.0),
                    seed=req["seed"]), Ticket())
            engine._tick()            # the admissions and one step
            live = engine.scheduler.busy_count()
            if live != slots:
                raise AssertionError("%d rows live, not %d" % (live, slots))

            def ticks():
                for _ in range(RECURRENT_TICKS):
                    engine._tick()
            decode = profiled(ticks)
    finally:
        engine.stop()
    n = RECURRENT_TICKS
    return dict(
        prefill_launches_per_token=(
            None if prefill["kernel_launches"] is None
            else prefill["kernel_launches"] / 64),
        prefill_ms_per_token=prefill["profiled_wall_ms"] / 64,
        prefill_idle_share=prefill["device_idle_share"],
        decode_live_rows=live, decode_ticks_profiled=n,
        decode_tick_ms=decode["profiled_wall_ms"] / n,
        decode_launches_per_tick=(
            None if decode["kernel_launches"] is None
            else decode["kernel_launches"] / n),
        decode_idle_share=decode["device_idle_share"],
        decode_top_kernels=decode["top_kernels"][:6])


#: snapshot: the general path's resumed run vs its straight run on
#: cuBLAS (the reference's limits, tests/test_snapshot.py:224-225)
TOL_SNAP_RTOL, TOL_SNAP_ATOL = 1e-5, 1e-6
SNAP_EPOCHS, SNAP_PER_DISPATCH = 4, 2
#: baseline2: MeanDispNormalizer on the card vs its numpy_run
#: (tests/test_aux_units.py:29)
TOL_NORM_RTOL, TOL_NORM_ATOL = 1e-5, 1e-6
#: published HBM3 rate of one H100 SXM (bytes/s)
PEAK_BYTES_PER_S = 3.35e12
#: train_zoo: the first two adam steps, card vs CPU (relative)
TOL_ZOO_STEP_REL = 1e-4
ZOO_EPOCHS = 3
ZOO_SEED = 31


def mnist_trees(wf):
    """The train step's params and momenta on the host, flat by path."""
    out = {}
    for attr in ("params", "opt_state"):
        for name, p in getattr(wf.train_step, attr).items():
            for k, t in p.items():
                out["%s/%s/%s" % (attr, name, k)] = t.detach().cpu()
    return out


def snapshot_pair(fused, directory):
    """MNIST straight for SNAP_EPOCHS, and the same split at half way by
    a snapshot: the first half writes it, a fresh workflow resumes its
    ``_current`` file and runs on. Returns both runs' records."""
    import torch
    from veles_tpu_torch.snapshotter import Snapshotter, load_snapshot, \
        resume
    from veles_tpu_torch.telemetry import counters
    name = "veles_fused_fc_launches_total"
    counters.counters.reset()
    straight = mnist_workflow(fused, SNAP_EPOCHS, SNAP_PER_DISPATCH)
    counters.counters.reset()
    straight.run()
    launches_a = counters.get(name)
    first = mnist_workflow(fused, SNAP_EPOCHS // 2, SNAP_PER_DISPATCH,
                           snapshot_dir=directory)
    counters.counters.reset()
    first.run()
    launches_b1 = counters.get(name)
    cur = os.path.join(directory, "mnist_current.pickle.gz")
    # the file on the host against the card's tensors, bit for bit
    state = load_snapshot(cur)
    saved = {("params", n, k): v for n, p in state["__units__"].items()
             if n in first.train_step.params for k, v in p.items()}
    saved.update({("opt_state", n, k): v for n, p in state["__units__"][
        "TrainStep"]["opt_state"].items() for k, v in p.items()})
    file_equal = all(numpy_equal(v, getattr(first.train_step, attr)[n][k])
                     for (attr, n, k), v in saved.items()) \
        and len(saved) == 8
    # one more export of the same state, timed, and its file's size
    probe = Snapshotter(first, prefix="probe", directory=directory)
    export_ms = host_ms(probe.export)
    file_bytes = os.path.getsize(probe.destination)
    resumed = mnist_workflow(fused, SNAP_EPOCHS, SNAP_PER_DISPATCH)
    resume_ms = host_ms(lambda: resume(resumed, cur))
    resumed.decision.complete <<= False
    counters.counters.reset()
    resumed.run()
    launches_b2 = counters.get(name)
    a, b = mnist_trees(straight), mnist_trees(resumed)
    return dict(
        straight=straight, resumed=resumed,
        launches={"straight": launches_a, "first_half": launches_b1,
                  "resumed_half": launches_b2},
        active=bool(straight.train_step._fused_fc_active
                    and first.train_step._fused_fc_active
                    and resumed.train_step._fused_fc_active),
        bit_identical=all(torch.equal(a[k], b[k]) for k in a),
        max_abs_diff=max(float((a[k] - b[k]).abs().max()) for k in a),
        close=all(torch.allclose(b[k], a[k], rtol=TOL_SNAP_RTOL,
                                 atol=TOL_SNAP_ATOL) for k in a),
        valid_straight=list(straight.decision.epoch_metrics[1]),
        valid_resumed=list(resumed.decision.epoch_metrics[1]),
        file_equals_card=file_equal, export_ms=export_ms,
        file_bytes=file_bytes, resume_ms=resume_ms,
        resumed_at=int(state["__units__"]["DecisionGD"]["epoch_number"]))


def numpy_equal(host, tensor):
    import numpy
    return numpy.array_equal(host, tensor.detach().cpu().numpy())


def phase_snapshot(card):
    """MNIST-784 (BASELINE #1) through the fused-FC kernel, snapshotted
    and resumed between two epoch blocks: the resumed run equals the
    straight one bit for bit, and the kernel trained every epoch of
    both; then the general path the same way, within the reference's
    resume limits. Returns the fused run's kernel launches."""
    import shutil
    directory = os.path.join(REPO, "build", "smoke_snapshots")
    shutil.rmtree(directory, ignore_errors=True)
    try:
        runs = {fused: snapshot_pair(fused, os.path.join(
            directory, "fused" if fused else "general"))
            for fused in (True, False)}
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    f, g = runs[True], runs[False]
    emit("snapshot", card=card, model="mnist-784 784-100-10", mb=100,
         epochs=SNAP_EPOCHS, epochs_per_dispatch=SNAP_PER_DISPATCH,
         resumed_at_epoch=f["resumed_at"],
         fused_fc_active=f["active"], fused_fc_launches=f["launches"],
         fused_bit_identical=f["bit_identical"],
         fused_max_abs_diff=f["max_abs_diff"],
         fused_valid_straight=f["valid_straight"],
         fused_valid_resumed=f["valid_resumed"],
         fused_file_equals_card=f["file_equals_card"],
         general_launches=g["launches"],
         general_bit_identical=g["bit_identical"],
         general_max_abs_diff=g["max_abs_diff"],
         general_within_limits=g["close"],
         general_valid_straight=g["valid_straight"],
         general_valid_resumed=g["valid_resumed"],
         general_file_equals_card=g["file_equals_card"],
         export_ms=f["export_ms"], file_bytes=f["file_bytes"],
         resume_ms=f["resume_ms"], general_export_ms=g["export_ms"],
         general_resume_ms=g["resume_ms"])
    half = SNAP_EPOCHS // 2
    if not f["active"] or f["launches"] != {
            "straight": SNAP_EPOCHS, "first_half": half,
            "resumed_half": SNAP_EPOCHS - half}:
        raise AssertionError("snapshot: the fused-FC kernel did not train "
                             "every epoch: %s" % f["launches"])
    if any(g["launches"].values()):
        raise AssertionError("snapshot: the general path launched the "
                             "fused kernel: %s" % g["launches"])
    if f["resumed_at"] != half:
        raise AssertionError("snapshot: resumed at epoch %d" % f["resumed_at"])
    if not f["bit_identical"] or f["valid_straight"] != f["valid_resumed"]:
        raise AssertionError("snapshot: the resumed fused run differs from "
                             "the straight one (max %g; errors %s vs %s)"
                             % (f["max_abs_diff"], f["valid_resumed"],
                                f["valid_straight"]))
    if not g["close"] or len(g["valid_resumed"]) != SNAP_EPOCHS:
        raise AssertionError("snapshot: the resumed general run differs "
                             "from the straight one by %g"
                             % g["max_abs_diff"])
    if not (f["file_equals_card"] and g["file_equals_card"]):
        raise AssertionError("snapshot: the file read on the host differs "
                             "from the card's tensors")
    return f["launches"]["straight"] + f["launches"]["first_half"] \
        + f["launches"]["resumed_half"]


def phase_baseline2(card):
    """BASELINE #2's units on the CIFAR-10 surrogate's 50,000 training
    rows (32×32×3, float32 on the card): compute_mean_rdisp on the host,
    MeanDispNormalizer on the card against its numpy_run (its ms beside
    the bound of the bytes it must move), then InputJoiner of two card
    arrays — the normalised rows and their one-hot labels — against
    numpy's concatenation."""
    import numpy
    import torch
    from veles_tpu_torch import InputJoiner, MeanDispNormalizer, datasets
    from veles_tpu_torch.memory import Array
    from veles_tpu_torch.telemetry import counters
    from veles_tpu_torch.workflow import Workflow
    t_phase = time.perf_counter()
    counters.counters.reset()
    tx, ty = datasets.load_cifar10()[:2]
    t0 = time.perf_counter()
    mean, rdisp = MeanDispNormalizer.compute_mean_rdisp(tx)
    stats_ms = (time.perf_counter() - t0) * 1e3
    wf = Workflow(name="baseline2")
    unit = MeanDispNormalizer(wf)
    unit.input = Array(tx)
    unit.mean, unit.rdisp = Array(mean), Array(rdisp)
    unit.initialize(device="cuda")
    unit.run()
    card_y = unit.output.devmem
    ms = cuda_time_ms(unit.run, 20)
    y = card_y.cpu().numpy()
    unit.numpy_run()
    oracle = unit.output.map_read()
    err = float(numpy.abs(y - oracle).max())
    close = bool(numpy.allclose(y, oracle, rtol=TOL_NORM_RTOL,
                                atol=TOL_NORM_ATOL))
    y_max = float(numpy.abs(y).max())
    # each input read once, the output written once
    nbytes = 2 * tx.nbytes + mean.nbytes + rdisp.nbytes
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    labels = torch.nn.functional.one_hot(
        torch.from_numpy(ty).long().cuda(), 10).float()
    joiner = InputJoiner(wf, inputs=[Array(tx), Array(numpy.zeros(
        (len(ty), 10), numpy.float32))])
    joiner.initialize(device="cuda")
    joiner.inputs[0].assign_devmem(card_y)
    joiner.inputs[1].assign_devmem(labels)
    joiner.run()
    joined = joiner.output.devmem
    want = numpy.concatenate([y.reshape(len(y), -1), labels.cpu().numpy()],
                             axis=1)
    join_exact = bool(numpy.array_equal(joined.cpu().numpy(), want))
    join_ms = cuda_time_ms(joiner.run, 20)
    launches = kernel_launches()
    emit("baseline2", card=card, rows=int(len(tx)),
         sample_shape=list(tx.shape[1:]), stats_ms_host=stats_ms,
         normalizer_ms=ms, normalizer_bytes=nbytes,
         normalizer_bound_ms=bound_ms, normalizer_bound_by="bytes",
         normalizer_share_of_bound=bound_ms / ms, max_abs_err=err,
         within_limits=close, max_abs_y=y_max,
         joiner_shape=list(joined.shape), joiner_exact=join_exact,
         joiner_ms=join_ms, hand_written_kernel_launches=launches,
         phase_s=time.perf_counter() - t_phase)
    if not close or y_max > 1.0 + 1e-5:
        raise AssertionError("MeanDispNormalizer on the card vs numpy_run: "
                             "max err %g, max |y| %g" % (err, y_max))
    if not join_exact or tuple(joined.shape) != (len(ty), 3082):
        raise AssertionError("InputJoiner on the card is not exact")
    if launches:
        raise AssertionError("baseline2 launched %d hand-written kernels"
                             % launches)


def zoo_workflow(name, device=None):
    from veles_tpu_torch import prng
    from veles_tpu_torch.models import kanji, video_ae
    prng.seed_all(ZOO_SEED)
    wf = {"kanji": kanji, "video_ae": video_ae}[name].build_workflow(
        epochs=ZOO_EPOCHS)
    wf.initialize(device=device)
    return wf


def tree_to(tree, device):
    """Nested dicts and tuples of tensors, on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_to(v, device) for v in tree)
    return tree.to(device)


def adam_first_steps(wf, starts=None, n=2):
    """The first ``n`` train steps of the workflow's own step (the train
    rows in order), leaving its params as they were: step k from
    ``starts[k]`` (a host (params, opt_state) pair) if given, else from
    the previous step's result. Returns, per step, (loss, {(unit, "m" |
    "v" | "update", param): host tensor}, the host state it started
    from) — adam's moments and the step's weight update."""
    import torch
    ts = wf.train_step
    dataset, targets = ts._dataset()
    mb = wf.loader.max_minibatch_size
    start = wf.loader.class_lengths[0] + wf.loader.class_lengths[1]
    mask = torch.ones(mb, dtype=torch.float32, device=ts.device)
    params, opt = ts.params, ts.opt_state
    out = []
    for k in range(n):
        if starts is not None:
            params, opt = tree_to(starts[k], ts.device)
        before = (tree_to(params, "cpu"), tree_to(opt, "cpu"))
        idx = torch.arange(start + k * mb, start + (k + 1) * mb,
                           dtype=torch.int32, device=ts.device)
        new, opt, _, loss = ts._train_step(
            params, opt, ts._zero_accum(), dataset, targets, idx, mask, 1.0)
        leaves = {(u, m, key): t.cpu() for u, st in opt.items()
                  for m in ("m", "v") for key, t in st[m].items()}
        leaves.update({(u, "update", key): (new[u][key] - t).cpu()
                       for u, p in params.items() for key, t in p.items()})
        out.append((float(loss), leaves, before))
        params = new
    return out


def phase_train_zoo(card):
    """kanji (576 → 256 → 576 tanh, adam, MSE on targets) and video_ae
    (256 → 96 → 24 → 96 → 256 tanh, adam, MSE on the input) at the
    reference's sizes: the first two adam steps on the card against the
    CPU from the same weights, then ZOO_EPOCHS epochs with the
    validation rmse falling and no hand-written kernel launched."""
    import torch
    from veles_tpu_torch.telemetry import counters
    for name in ("kanji", "video_ae"):
        t_phase = time.perf_counter()
        host = adam_first_steps(zoo_workflow(name, "cpu"))
        wf = zoo_workflow(name)
        # each step on the card from the state the CPU's step started
        # from: an earlier step's rounding, which adam's normalised step
        # can blow up to ±lr at an element, does not reach the next
        mine = adam_first_steps(wf, starts=[h[2] for h in host])
        loss_rel = max(abs(a[0] - b[0]) / abs(b[0])
                       for a, b in zip(mine, host))
        rel = {}
        for (_, got, _), (_, want, _) in zip(mine, host):
            for key, w in want.items():
                d = float((got[key] - w).abs().max()) / max(
                    float(w.abs().max()), 1e-30)
                rel[key[1]] = max(rel.get(key[1], 0.0), d)
        stamps = stamp_epochs(wf)
        torch.cuda.synchronize()
        counters.counters.reset()
        t0 = time.perf_counter()
        wf.run()
        epoch_s = [b - a for a, b in zip([t0] + stamps, stamps)]
        launches = kernel_launches()
        d = wf.decision
        lengths = wf.loader.class_lengths
        valid = d.epoch_metrics[1]
        emit("train_zoo", card=card, model=name,
             widths=[f.weights.shape[0] for f in wf.forwards]
             + [wf.forwards[-1].weights.shape[1]],
             mb=wf.loader.max_minibatch_size,
             rows={"train": lengths[2], "validation": lengths[1]},
             target_mode=wf.train_step.target_mode,
             step_loss_rel_diff=loss_rel, step_m_rel_diff=rel["m"],
             step_v_rel_diff=rel["v"], step_update_rel_diff=rel["update"],
             epochs=d.epoch_number, epoch_ms=[t * 1e3 for t in epoch_s],
             valid_rmse=valid, train_rmse=d.epoch_metrics[2],
             train_samples_per_s=lengths[2] / epoch_s[-1],
             hand_written_kernel_launches=launches,
             phase_s=time.perf_counter() - t_phase)
        if not max(loss_rel, rel["m"], rel["v"]) <= TOL_ZOO_STEP_REL:
            raise AssertionError("%s: the first adam steps on the card "
                                 "differ from the CPU's: loss %g, m %g, v %g"
                                 % (name, loss_rel, rel["m"], rel["v"]))
        if d.epoch_number != ZOO_EPOCHS or not all(
                math.isfinite(x) for x in valid) or not valid[-1] < valid[0]:
            raise AssertionError("%s: validation rmse %s" % (name, valid))
        if launches:
            raise AssertionError("%s launched %d hand-written kernels"
                                 % (name, launches))


def host_ms(fn):
    """Host-clock time of ``fn()`` ending in a device synchronise."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def profiled(fn, match=()):
    """Host wall ms of ``fn()`` under torch.profiler, and the device's
    busy ms, idle share, kernel launches and top kernels by device time
    (null when the profiler sees no device time); ``matched_ms`` sums the
    device ms of every kernel whose name holds each of ``match``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms = host_ms(fn)
    kernels = [(getattr(e, "self_device_time_total", 0) / 1e3, e.key,
                e.count) for e in prof.key_averages()
               if getattr(e, "device_type", None) is not None
               and "CUDA" in str(e.device_type)]
    busy_ms = sum(k[0] for k in kernels)
    kernels.sort(reverse=True)
    return dict(
        profiled_wall_ms=wall_ms,
        device_busy_ms=busy_ms if kernels else None,
        device_idle_share=(1 - busy_ms / wall_ms) if kernels else None,
        kernel_launches=sum(k[2] for k in kernels) if kernels else None,
        top_kernels=[{"name": k[1][:80], "ms": k[0], "calls": k[2]}
                     for k in kernels[:12]],
        matched_ms={m: sum(k[0] for k in kernels if m in k[1])
                    for m in match})


def phase_breakdown(card, model, prompts):
    """Where one batched greedy decode spends its time: prefill (the
    n_new=1 call) vs the per-step decode, and the device's busy share
    and top kernels from torch.profiler."""
    from veles_tpu_torch.nn import sampling

    def run(n):
        return lambda: sampling.generate(model, prompts, n, temperature=0)

    prefill_ms = min(host_ms(run(1)) for _ in range(3))
    total_ms = min(host_ms(run(N_NEW)) for _ in range(3))
    emit("breakdown", card=card, batch=len(prompts),
         prompt_len=len(prompts[0]), n_new=N_NEW,
         prefill_ms=prefill_ms, decode_total_ms=total_ms,
         decode_step_ms=(total_ms - prefill_ms) / (N_NEW - 1),
         **profiled(run(N_NEW)))


def phase_train_breakdown(card):
    """Where one fused MNIST epoch block (4 epochs, one dispatch) spends
    its time: the device's busy share and top kernels, the fused
    kernel's share among them."""
    wf = mnist_workflow(True, epochs=4, per_dispatch=4)
    rec = profiled(wf.run)
    ffc_ms = sum(k["ms"] for k in rec["top_kernels"]
                 if "fused_fc_sgd" in k["name"])
    emit("train_breakdown", card=card, epochs=wf.decision.epoch_number,
         epoch_ms=rec["profiled_wall_ms"] / wf.decision.epoch_number,
         fused_kernel_ms=ffc_ms,
         fused_kernel_share=ffc_ms / rec["profiled_wall_ms"], **rec)


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
    from veles_tpu_torch.ops import fused_fc as ff

    device_for("cuda")          # applies the f32 (no TF32) policy
    card = nvidia_smi()
    emit("device", card=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    seconds = _build.build_all()
    for name in sorted(seconds):
        emit("build", source="veles_tpu_torch/csrc/%s.cu" % name,
             seconds=seconds[name], wall_s=time.perf_counter() - t0,
             ptxas=_build.build_log(name).splitlines())

    worst = phase_kernels(fa)
    worst_ffc = phase_kernels_fused_fc(ff)
    timing = phase_timing(fa, card)[(4, 512)]
    timing_ffc = phase_timing_fused_fc(ff, card)
    launches = phase_serve(card)
    launches_cont = phase_serve_continuous(card)
    launches_ffc = phase_train(card)
    phase_train_breakdown(card)
    worst_bwd = phase_kernels_bwd(fa)
    timing_bwd = phase_timing_bwd(fa, card)
    lm_wf, launches_lm, lm_f32 = phase_train_lm(card)
    phase_train_lm_breakdown(card, lm_wf)
    worst_amp, share_amp = phase_kernels_amp(fa)
    timing_amp = phase_timing_amp(fa, card)
    launches_amp = phase_train_lm_amp(card, lm_f32)
    phase_conv_units(card)
    phase_train_ae(card)
    phase_train_cifar(card)
    phase_recurrent_units(card)
    phase_train_genre(card)
    phase_serve_recurrent(card)
    launches_snap = phase_snapshot(card)
    phase_baseline2(card)
    phase_train_zoo(card)

    def bwd_entry(name, what):
        rec = timing_bwd[name]
        return {"name": "flash_attention_bwd_" + name, "route": "cuda",
                "source": "veles_tpu_torch/csrc/flash_attention_bwd.cu",
                "replaces": "veles_tpu/ops/flash_attention.py:%d" % what,
                "launches": launches_lm[name],
                "max_abs_err": worst_bwd[name], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"],
                # the kernels' products run on the tensor cores in 3xTF32
                "bound_ms": rec["bound_tc_ms"], "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"], "pair_ms": rec["pair_ms"],
                "launches_by_path": {"train_lm": launches_lm[name],
                                     "train_lm_amp": launches_amp[
                                         ("f32_f32", name)]},
                "ok": True}

    def amp_entry(inst, kern):
        """A mixed-precision instance's entry: its launches in the AMP
        bench-LM epochs (the RoPE one takes f32_bf16, the RoPE-less one
        bf16_bf16; no model path of the port gives q/k bf16 and v
        float32), its worst error here, its times at the bench shape."""
        rec = timing_amp[(inst, kern, 16)]
        launches = launches_amp.get((inst, kern), 0)
        return {"name": "flash_attention_%s[%s]" % (
                    "fwd" if kern == "fwd" else "bwd_" + kern, inst),
                "route": "cuda",
                "source": "veles_tpu_torch/csrc/flash_attention_%s.cu"
                          % ("fwd" if kern == "fwd" else "bwd"),
                "replaces": "veles_tpu/ops/flash_attention.py:%d"
                            % {"fwd": 77, "dkv": 248, "dq": 309}[kern],
                "instance": inst, "launches": launches,
                "main_path": launches > 0,
                "max_abs_err": worst_amp[(inst, kern)],
                "share_of_limit": share_amp[(inst, kern)],
                "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"], "library": rec["library"],
                "ok": True}

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "veles_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "veles_tpu/ops/flash_attention.py:77",
        "launches": launches, "max_abs_err": worst,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        # the kernel's products run on the tensor cores in 3xTF32
        "bound_ms": timing["bound_tc_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
        "launches_by_path": {"serve": launches,
                             "serve_continuous": launches_cont,
                             "train_lm": launches_lm["fwd"],
                             "train_lm_amp": launches_amp[("f32_f32",
                                                           "fwd")]},
        "ok": True}, {
        "name": "fused_fc_sgd_epoch", "route": "cuda",
        "source": "veles_tpu_torch/csrc/fused_fc_sgd.cu",
        "replaces": "veles_tpu/ops/fused_fc.py:55",
        "launches": launches_ffc,
        "max_abs_err": max(worst_ffc, timing_ffc["max_abs_err"]),
        "ms": timing_ffc["ms"], "plain_ms": timing_ffc["plain_ms"],
        # layer 0's products run on the tensor cores in 3xTF32
        "bound_ms": timing_ffc["bound_tc_ms"],
        "bound_by": timing_ffc["bound_by"], "library_ms": None,
        "general_path_ms": timing_ffc["general_path_ms"],
        "us_per_step": timing_ffc["us_per_step"],
        "launches_by_path": {"train": launches_ffc,
                             "snapshot": launches_snap}, "ok": True},
        bwd_entry("dkv", 248), bwd_entry("dq", 309)] + [
        amp_entry(inst, kern) for inst in AMP_INSTANCES
        for kern in ("fwd", "dkv", "dq")]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
             flash_attention_fwd (3xTF32 on the tensor cores): 28 cases
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
             tensor cores) against the plain backward on 20 cases (the
             bench shape, the text char LMs' H4 D12 and H4 D128, GQA 8/2
             and 8/1, windows, ragged T 1, 65, 127,
             129, D 8..256 including 33, 40, 72 and 160, strided q/k/v
             and views offset by one element, so that no row is 16-byte
             aligned): max abs error of each gradient <= 1e-4 *
             max(1, max|plain|), relaunches bit-identical, each call
             counted once by each kernel's launch counter, and autograd
             through ``flash_attention`` against autograd through the
             plain attention;
10. timing_bwd — each backward kernel at the bench shape (and, in
             records of their own, at the bench-width text LM's B16 T512
             H4 D128 causal) with CUDA
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
             Phases 23–24 launch no hand-written kernel;
25. telemetry — the telemetry plane on the ported paths
             (``veles_tpu_torch/telemetry``). Serving: the bench LM behind
             the default continuous engine (``serve_continuous``'s
             geometry and its 24 requests), once with spans off and once
             with spans on under ``devtime.measure`` (a torch.profiler
             capture): greedy tokens and the flash launch counter equal
             off and on; ``source`` "profiler", device time > 0,
             ``serving.prefill`` and ``serving.decode_step`` each with
             device time > 0, 24 ``serving.prefill`` spans, 24
             ``request`` spans each retired, flash-forward kernel events
             in the capture = the launch counter's delta (6 x 24), the
             live ``/metrics`` page's ttft and e2e histogram counts 24
             each, the spans' Chrome trace valid; tokens/s of the three
             runs and the idle share reported. Training: MNIST-784 through the
             fused-FC kernel, one 4-epoch block under ``devtime.measure``:
             fused-FC kernel events = the launch counter's delta (4), the
             ``train_step.epoch_block`` span's device time >= the
             kernel's. Cost: the analytic costs the flash kernel noted
             over the serving load (``telemetry/cost.py`` collectors)
             total the sum of ``ops/flash_attention.analytic_cost`` over
             the 24 prefills' 6 launches each; their FLOP/s over the
             kernel's device time and over the load's wall time, and the
             share of the float32 and TF32 peaks from ``cost.py``.
26. cli    — the CLI front door (``python -m veles_tpu_torch MODEL.py
             [overrides] [flags]``) on model files written to a
             temporary directory, as users write them. MNIST-784 at 2
             epochs a dispatch, 4 epochs, through
             ``veles_tpu_torch.__main__.main`` in process with
             ``root.common.engine.fused_fc_scan=true --random-seed 4321
             --result-file R`` (a seed other than the default
             ``root.common.random_seed``): the fused-FC kernel launched
             once per epoch (4, as the same workflow built and run
             directly from 4321), the final weights, biases and momenta
             (saved by the model file's ``gather_results``) and the
             results' validation errors equal the direct run's bit for
             bit, the launcher logged the cuda device. The bench LM of
             ``train_lm`` with a Snapshotter, trained in a
             ``python -m veles_tpu_torch`` subprocess (``--snapshot-dir D
             --random-seed 77 --result-file R``): exit 0, launches 6 x 72
             / 6 x 64 / 6 x 64, NLL/token within 1e-4 relative of
             ``train_lm``'s kernel run (bits reported), a
             ``benchlm_current.pickle.gz`` written. The same model file
             served from that snapshot in a subprocess
             (``--serve-generate 0`` with serve_continuous's slots,
             buckets, context and pages, ``--blackbox``,
             ``--trace-file``): 12 requests at once (8 greedy, 4 sampled
             with seeds, prompts 60–1,800, n_new 16/32/48) all 200, their
             tokens equal to the same snapshot served in this process by
             ``GenerationAPI``'s default engine, the flash launch
             counter on ``/metrics`` up by 6 x 12, ``/healthz`` and
             ``/readyz`` 200, SIGTERM drains to exit 0 within the grace
             with "drain complete" logged; tokens/s, the time to the
             SERVING line and the resume time reported. Then ``trace
             export`` of the server's trace file (a valid Chrome trace,
             12 ``serving.prefill`` spans), ``blackbox inspect`` of the
             dump its SIGTERM wrote, and ``--backend auto --dry-run`` of a
             tiny model, which logs the cuda device.
27. znicz_units — the rest of Znicz's layer set on the card against
             the port on the CPU, TF32 off: LRN at n 5 and 3 over odd
             channel counts and the cutter (forward and the gradients of
             sum(y · g)), channel split and merge (exact), ``som_step``
             (16×16 neurons over 784 features; winners equal),
             ``cd1_step`` (784 → 256, mb 64) with given uniforms, and
             adagrad, rmsprop, adadelta and the clipping knobs on an
             update, each within 1e-4 · max(1, max|cpu|); dropout (eval
             the identity; one seed one mask; 10^6 elements keep 0.7
             within 0.002, each kept one x/keep) and stochastic pooling
             (eval max pooling; one seed one pick; every pick a finite
             element of its window);
28. train_alexnet — ``models/alexnet.build_workflow`` at 224 px
             (five convs through ``mcdnnic_topology``; adam lr 0.001, mb
             64, 1,600 / 320 rows): every layer at its own shapes on the
             card against the CPU (8 rows, <= 1e-4 · max(1, max|cpu|));
             conv2's weight gradient against float64 through cuDNN
             (default, deterministic, benchmark) and the port's path;
             the first two train steps against the CPU from the same
             weights and rows: the loss within 1e-4 relative, the first
             step's gradients of the layers above the last max pooling
             (‖card − cpu‖ / ‖cpu‖ <= 1e-4), and every layer's gradient
             no further from the card's float64 one than twice the
             CPU's float32 one; adam's updates reported (a max
             pooling's near-ties pick other elements under other
             rounding, and adam's normalised step turns a
             rounding-noise gradient into ±lr); two epochs with finite
             metrics and the train loss falling; epoch ms, train
             samples/s, TFLOP/s of the counted work
             (``FlopCounterMode``) and its share of the float32 peak,
             peak memory, the last tanh layer's saturated share, 4
             profiled train steps; then one STL-10 epoch at 96 px;
29. train_unsupervised — DemoKohonen (8 epochs, mb 100, 600 rows) on
             the card: its quantisation errors beside the CPU's, the
             final one below 0.25 and below the first epoch's; an RBM
             784 → 256 on MNIST's rows (``models/rbm_mnist.py``, mb 64):
             its first 5 CD-1 steps against the CPU's from the same
             uniforms (params and error within 1e-4 relative), then
             200 steps with the error falling; ms a step of each.
             Phases 27–29 launch no hand-written kernel.
30. serve_spec_beam — speculative and beam decoding and SSE streaming
             (run after phase 7): the bench LM behind ``GenerationAPI``'s
             default continuous engine (serve_continuous's slots,
             buckets, context and pages; ``spec_gamma`` 4, ``beam_width``
             4) with a 1-block draft of the bench width
             (``char_lm.build_bench_workflow(n_blocks=1)``, random weights
             from numpy seed 1). 16 requests posted at once, a seed each:
             4 greedy speculative (prompts 60, 250, 900, 1800, n_new 48),
             4 speculative sampled at 0.8, 2 beam requests of width 4
             (prompts 120 and 480, n_new 32), 4 plain greedy or sampled
             co-tenants and 2 ``stream: true`` requests (one plain greedy,
             one greedy speculative). Checks: every answer the pool's;
             every greedy speculative answer equal to the same engine's
             plain greedy one; sampled speculative answers equal to the
             port's solo ``generate_speculative`` under the same seed;
             beam tokens equal to solo ``beam_generate``, scores within
             1e-5; the streamed events' tokens equal the terminal answer
             and the buffered one, the first event before the terminal
             one; admitted = retired = 16; flash launches = 6 x target
             prefills + 1 x draft prefills, every prefill at its bucket;
             the page ledger empty. Then a second engine whose draft is
             the target itself: acceptance exactly 1.0 and the plain
             greedy tokens. Prints the mixed load's tokens/s, greedy
             speculative against plain greedy tokens/s, acceptance,
             rounds, TTFT, the median speculative round, beam step and
             decode tick, and whether the bench LM's products give their
             first 8 rows the same bits inside 32 rows.
31. serve_qos_handoff — the QoS plane, token-level resume and drain by
             handoff (run right after phase 30, ~16 s): (a) the bench LM
             behind a continuous engine with serve_continuous's knobs and
             ``root.common.serving.qos`` on: 8 batch requests (4 greedy,
             4 sampled at 0.8, prompts 60–1,800, n_new 48) fill the pool,
             and once every row has emitted 8 tokens 4 interactive greedy
             ones arrive (prompts 60–480, n_new 16). Checks: preemptions
             >= 4 and the preempted-token count equal to the tokens the
             victims had emitted; every batch answer equal to the same
             request served alone on a QoS-off engine and to the same mix
             with QoS off, a greedy one also to plain ``generate``; every
             interactive answer plain greedy; admitted = retired = 12 and
             12 end-to-end and queue-wait samples; flash launches = 6 x
             (prefills + resumed prefills), each at its bucket (a resumed
             one at prompt + emitted tokens); no page left. Reports the
             interactive TTFT p50 with QoS on and off over the same mix,
             the resumed prefills' ms and tokens/s. (b) one greedy and one
             sampled request cut by ``serve.decode_step:raise:after=8,
             times=1`` on one ``GenerationAPI`` answer 503 with
             ``resume.tokens``; a second API fed ``resume_tokens`` + the
             remaining ``n_new`` gives the uninterrupted answers, and the
             advanced generator's state (Philox offset arithmetic) equals
             one that replayed the draws. (c) 8 requests in flight and 2
             queued over HTTP, then ``api.drain()`` with the defaults:
             the 8 answered 503 with ``resume``, the 2 without, the
             handoff counter up by 8, the drain's wall time below the
             time left in the longest generation (reported beside what
             ``drain_grace`` would have waited). (d) a greedy and a
             sampled batch row preempted on the LSTM char LM at
             serve_recurrent's 512 x 6 equal solo ``generate_recurrent``.
32. train_text — the training library's real-text path (after phase 29):
             (a) the reference's real-text anchor: CPython's pydoc topics
             cut to 120,000 characters, ``char_lm.build_workflow(epochs=
             24, minibatch_size=64, n_blocks=2, dim=48, text_file=...)``
             from seed 11 (4 heads of 12) reaches best_err <= 0.48 and
             beats the trigram-argmax error of the same split by more
             than 0.05; each flash kernel's launches equal 2 blocks x the
             steps the epochs imply (forward: train + evaluation steps).
             (b) the uncut corpus at the bench LM's width (d 512, 6
             blocks, 4 heads of 128, T 512, mb 16) one epoch from one
             seed, tensormon off and then on: the same parameters and
             optimiser state (``torch.equal``), the same flash launches
             (6 x the steps), the same synchronising calls under
             ``torch.cuda.set_sync_debug_mode("warn")``, the
             ``veles_model_*`` gauges on ``counters.metrics_text`` and one
             ``tensormon.sample`` span per drained sample; the epoch ms
             on and off and the launches a step.
33. train_library — (c) the NaN sentinel on the reference's poisoned
             blobs: warn counts and completes, halt raises
             ``ModelHealthError`` with ``/readyz`` 503, snapshot_and_halt
             leaves one committed, verified snapshot and one black box
             ("nan sentinel", a ``tensormon.nan`` event); (d) MNIST with
             tensormon on: 0 fused-FC launches, the reference's reason
             logged, finite epochs; (e) MNIST 2 epochs through the
             fused-FC kernel (2 launches), snapshotted, resumed into LoRA
             rank 8 on both layers for 2 more (0 launches): the output at
             step 0 equals the base's, the base stays bit for bit, the
             adapters move, the first two steps within 1e-4 relative of
             the CPU's from the same state; (f) label smoothing 0.1 with
             the confusion matrix: the first two SGD steps within 1e-4 of
             the CPU's, each set's matrix summing to n_samples with n_err
             off its diagonal; (g) ``engine.fused_epilogue`` on against
             off on a chain of standalone activation layers, bit for bit;
             (h) MNIST's rows through ``MinibatchesSaver`` and back
             through ``MinibatchesLoader`` and ``PicklesLoader``, 2
             fused-FC epochs each (2 launches) ending on the in-memory
             run's weights bit for bit.
34. lm_family — the rest of the LM family (after phase 33):
             ``tiny_transformer`` through the flash kernels at H 4 D 8,
             the MHA unit and MoE at the bench width against the CPU,
             the MoE and RProp workflows, the O(1)-state lane's state
             cache, the recurrent units under AMP.
35. rest_serving — classic REST serving of a trained classifier and
             the image loaders (after phase 34): (a) MNIST-784, BASELINE
             #1 (seed 1234), 2 epochs through the fused-FC kernel (2
             launches), then served as ``docs/examples.md`` §5 wires it,
             ``Repeater → RestfulLoader(sample_shape=(784,),
             minibatch_size=8) → All2AllTanh(100) → All2AllSoftmax(10) →
             RESTfulAPI`` on the card with the trained parameters: 256
             validation rows POSTed over HTTP from 32 threads (in a
             process of their own), all 200,
             each within 1e-5 of the trained forward of that row alone
             on the card, the argmax equal (a differing one only on a
             near-tie, printed with its margin), the served error count
             equal to the workflow's own evaluation of the rows, fewer
             dispatches than requests and at most 8 rows a dispatch,
             ``veles_rest_requests_served 256`` on ``/metrics``; a bad
             shape 400 then 200, an unknown path 404, ``max_pending=0``
             503 + Retry-After, ``loader.close()`` ending the workflow,
             ``stop()`` settling an outstanding ticket once with 503.
             (b) BASELINE #4's caffe-quick stack from a class tree of
             5,000 uint8 ``.npy`` files (the CIFAR surrogate's rows, 10
             classes, ``ClassImageLoader``, valid ratio 0.1): one epoch
             with host augmentation (mirror, multiplicity 2), one with
             ``device_augmentation`` (mirror, crop 28×28): every row of
             a step's batch a window of its source or its mirror, the
             mirrored share of 4,000 rows in 0.5 ± 0.1, one key one
             draw, the evaluation crop exact, ``minibatch_data`` 28×28×3,
             the fused-FC gate refusing an FC chain on that loader with
             the reference's reason and 0 launches; the host-augmented
             model served through ``RestfulImageLoader(sample_shape=(32,
             32, 3), minibatch_size=16)``: 64 ``input`` requests within
             1e-5 of the forward alone (PNG payloads too where Pillow
             imports). Reports requests/s, per-request wall p50/p99,
             dispatches and rows a dispatch, the decode seconds of the
             5,000 files, each epoch's ms.
36. quant_serving — int8 serving (after phase 35): (a) the bench LM
             (seed 0) under serve_continuous's 24 requests on four
             engines (float, ``quant_weights``, ``quant_kv``, both) and
             the float engine serving the dequantized twin: every
             eligible weight's int8 values and scales, and the longest
             prompt's K/V rows', on the card equal to the CPU quantizer's
             bit for bit; the int8-weights tokens, greedy and sampled,
             equal to the twin's; ``kv_pool_bytes`` equal to the shapes'
             (payload and scales), int8 / float = 1,032 / 4,096; 8 of the
             24 served alone on each int8 engine equal to their concurrent
             answers; flash launches = 6 x prefills, each at its bucket;
             admitted = retired = 24, no page left; the quant counters 0
             on the float engine, 1 calibration, 37 tensors and the
             shapes' bytes saved on the int8-weights ones;
             ``quant.calibrate:raise:times=1`` fails one tick and the
             queued request is answered as the int8-weights engine
             answered it. Reported: greedy agreement with float, the
             first flip's two logits and margin, the twin's max logit
             delta, tokens/s, peak memory, tick ms, launches a tick and
             idle share of every engine. (b) the reference's drill
             (``bench.py:3021-3070``, trained on the card through the
             flash kernels): int8 greedy answers token-exact against
             float, max logit delta < 0.25. (c) MNIST (2 fused-FC epochs)
             and the bench LM exported by the Snapshotter and quantized
             by ``python -m veles_tpu_torch quantize`` subprocesses: the
             manifests verify, the records are the eligible tensors with
             the bytes the shapes give, ``load_snapshot`` returns ``q ·
             s`` bit for bit; MNIST resumed from its int8 snapshot counts
             the dequantized weights' validation errors; the LM's int8
             snapshot served by ``--serve-generate --quant-weights
             --quant-kv`` in another process answers 8 of (a)'s requests
             as (a)'s int8 (both) engine did, its ``/metrics`` modes 1.

``profiled`` (the breakdown phases' profiler window) reads the capture
through ``telemetry.devtime.measure``: ``device_busy_ms`` is the union
of each stream's kernel, memcpy and memset intervals, summed over the
streams, so overlapping kernels count once.

Then the card's line, the kernels line (``{"kernels": [...]}``; the
flash kernels' AMP instances as entries of their own, each with its
launches in the AMP epochs; the fused-FC kernel's launches in ``train``
and, under ``launches_by_path``, in ``snapshot``, ``telemetry`` and
``cli``, ``train_library``, ``rest_serving`` and ``quant_serving``
too; the flash kernels' f32 entries count ``cli`` and ``train_text``
too, the forward's ``serve_spec_beam``, ``serve_qos_handoff`` and
``quant_serving`` too) and,
last, the device line ``{"ok": true, "device": {...}}``. Any failure
raises and the run exits non-zero without the last line; without a card
it exits 1 at once.
"""

import gc
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
        # the text char LMs (train_text): the real-text anchor's 4 heads
        # of 12 and the bench-width text epoch's 4 heads of 128
        ("text_anchor_b64_t32_d12", 64, 32, 4, 4, 12, True, 0, None),
        ("text_bench_b16_t512_d128", 16, 512, 4, 4, 128, True, 0, None),
        # tiny_transformer's blocks (lm_family): 4 heads of 8, not causal
        ("tiny_transformer_b64_t16_d8", 64, 16, 4, 4, 8, False, 0, None),
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
        # the text char LMs (train_text): 4 heads of 12 and of 128
        ("text_anchor_b64_t32_d12", 64, 32, 4, 4, 12, True, 0, None),
        ("text_bench_b16_t512_d128", 16, 512, 4, 4, 128, True, 0, None),
        # tiny_transformer's blocks (lm_family): 4 heads of 8, not causal
        ("tiny_transformer_b64_t16_d8", 64, 16, 4, 4, 8, False, 0, None),
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
    """Each backward kernel at the bench shape (B16 T512 H8 D64 causal)
    and at the bench-width text LM's (B16 T512 H4 D128 causal): CUDA
    events, its bound, the plain backward and SDPA's backward. Returns
    the bench shape's records (the kernels line's)."""
    timing_bwd_at(fa, card, 16, 512, 4, 4, 128, "text_d128")
    return timing_bwd_at(fa, card, 16, 512, 8, 8, 64, "bench")


def timing_bwd_at(fa, card, b, t, h, kv, d, what):
    """The backward pair's times at one causal shape (``what`` names it
    in the records)."""
    import torch
    import torch.nn.functional as F
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
        emit("timing_bwd", kernel="flash_attention_bwd_" + name,
             shape_name=what, **rec)
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


#: the serve_spec_beam phase's engine: serve_continuous's with the
#: reference's speculation round and beam group widths
SPEC_ENGINE = dict(CONT_ENGINE, spec_gamma=4, beam_width=4)
SPEC_N_NEW = 48
BEAM_N_NEW = 32
#: the sampled speculative requests' temperature
SPEC_TEMP = 0.8


def spec_beam_load():
    """serve_spec_beam's 16 requests, a seed each: 4 greedy speculative
    (prompts 60, 250, 900, 1800), 4 speculative sampled at 0.8, 2 beam
    requests of width 4 (prompts 120, 480), 4 plain co-tenants (2
    greedy, 2 sampled) and 2 streamed (one plain greedy, one greedy
    speculative)."""
    import numpy
    rng = numpy.random.RandomState(11)

    def prompt(n):
        return [int(x) for x in rng.randint(0, 256, n)]

    reqs = []
    for n in (60, 250, 900, 1800):
        reqs.append({"prompt": prompt(n), "n_new": SPEC_N_NEW,
                     "mode": "speculative", "seed": 2000 + len(reqs)})
    for n in (120, 480, 900, 1800):
        reqs.append({"prompt": prompt(n), "n_new": SPEC_N_NEW,
                     "mode": "speculative", "temperature": SPEC_TEMP,
                     "seed": 2000 + len(reqs)})
    for n in (120, 480):
        reqs.append({"prompt": prompt(n), "n_new": BEAM_N_NEW,
                     "mode": "beam", "seed": 2000 + len(reqs)})
    for n, mode in ((60, "greedy"), (250, "greedy"), (120, "sample"),
                    (480, "sample")):
        req = {"prompt": prompt(n), "n_new": 32, "mode": mode,
               "seed": 2000 + len(reqs)}
        if mode == "sample":
            req["temperature"] = SPEC_TEMP
        reqs.append(req)
    reqs.append({"prompt": prompt(250), "n_new": 32, "stream": True,
                 "seed": 2000 + len(reqs)})
    reqs.append({"prompt": prompt(480), "n_new": SPEC_N_NEW,
                 "mode": "speculative", "stream": True,
                 "seed": 2000 + len(reqs)})
    return reqs


def post_stream(url, payload, timeout=600.0):
    """POST a ``stream: true`` request and read its SSE events: (status,
    events, seconds to the first event, seconds to the terminal one)."""
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    events, first = [], None
    with urllib.request.urlopen(req, timeout=timeout) as r:
        if "text/event-stream" not in r.headers.get("Content-Type", ""):
            raise AssertionError("stream answered %s"
                                 % r.headers.get("Content-Type"))
        while True:
            line = r.readline()
            if not line:
                break
            if line.startswith(b"data: "):
                if first is None:
                    first = time.perf_counter() - t0
                events.append(json.loads(line[6:]))
        return r.status, events, first, time.perf_counter() - t0


def post_mixed(url, requests):
    """POST every request at once, a streamed one through
    :func:`post_stream`; (answers, wall s). A streamed answer is
    (status, its terminal event, ms, its events, first s, last s)."""
    results = [None] * len(requests)

    def fire(i):
        if requests[i].get("stream"):
            code, events, first, last = post_stream(url, requests[i])
            results[i] = (code, events[-1] if events else {}, last * 1e3,
                          events, first, last)
        else:
            results[i] = post(url, requests[i])

    threads = [threading.Thread(target=fire, args=(i,))
               for i in range(len(requests))]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    return results, time.perf_counter() - t0


def spec_row_bits():
    """Whether a product's first 8 rows have the same bits inside 32
    rows as alone on the card, for each product of the bench LM's
    decode: the verify pass multiplies 8 rows x 4 positions where the
    decode step multiplies 8 rows."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for name, (k, n) in (("qkvo_512x512", (512, 512)),
                         ("ffn_in_512x2048", (512, 2048)),
                         ("ffn_out_2048x512", (2048, 512)),
                         ("head_512x256", (512, 256))):
        x = torch.randn((32, k), generator=g, device="cuda")
        w = torch.randn((k, n), generator=g, device="cuda")
        out[name] = bool(torch.equal((x @ w)[:8], x[:8] @ w))
    return out


def first_divergence(model, prompt, got, want):
    """Where two greedy token lists part: the step, both tokens, and the
    prefill logits of both at that step with their margin (the plain
    prefill of prompt + the common prefix on the card)."""
    from veles_tpu_torch.nn import sampling
    step = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    logits = sampling.prompt_logits(model, list(prompt) + want[:step])
    return {"step": step, "got": got[step], "want": want[step],
            "logit_got": float(logits[got[step]]),
            "logit_want": float(logits[want[step]]),
            "margin": float(logits[want[step]] - logits[got[step]])}


def phase_serve_spec_beam(card):
    """Speculative and beam decoding and SSE streaming on the bench LM
    behind GenerationAPI's default continuous engine, with a 1-block
    draft; then a second engine whose draft is the target itself."""
    import numpy
    import torch
    from veles_tpu_torch.convert import params_from_jax, random_params
    from veles_tpu_torch.models import char_lm
    from veles_tpu_torch.nn.beam import beam_generate
    from veles_tpu_torch.nn.speculative import generate_speculative
    from veles_tpu_torch.nn.standard_workflow import build_forwards
    from veles_tpu_torch.restful_api import GenerationAPI
    from veles_tpu_torch.telemetry import counters

    t_phase = time.perf_counter()
    model = bench_lm()
    draft = build_forwards(
        char_lm.build_bench_workflow(n_blocks=1).layers_config)
    draft = params_from_jax(draft, random_params(draft, seed=1))
    n_blocks = sum(1 for c in BENCH_LAYERS
                   if c["type"] == "transformer_block")
    requests = spec_beam_load()
    modes = [r.get("mode", "greedy") for r in requests]
    greedy_spec = [i for i, r in enumerate(requests)
                   if modes[i] == "speculative"
                   and not r.get("temperature")]
    sampled_spec = [i for i, r in enumerate(requests)
                    if modes[i] == "speculative" and r.get("temperature")]
    beams = [i for i, m in enumerate(modes) if m == "beam"]
    streamed = [i for i, r in enumerate(requests) if r.get("stream")]
    api = GenerationAPI(model, port=0, batch_window=0.5, draft=draft,
                        **SPEC_ENGINE).initialize()
    engine = api._engine
    url = "http://127.0.0.1:%d/generate" % api.port
    try:
        if engine is None or engine.draft_stack is None:
            raise AssertionError("no continuous engine with a draft")
        # CUDA / cuBLAS warm-up of every mode, outside the measured runs
        warm = requests[0]["prompt"][:40]
        for mode, extra in (("greedy", {}), ("speculative", {}),
                            ("speculative", {"temperature": 0.8}),
                            ("beam", {})):
            code, body, _ = post(url, dict({"prompt": warm, "n_new": 4,
                                            "mode": mode}, **extra))
            if code != 200:
                raise AssertionError("warm-up %s: %r" % (mode, body))
        torch.cuda.synchronize()
        admitted0, retired0 = engine.admitted, engine.retired
        engine.prefills_by_bucket.clear()
        engine.draft_prefills_by_bucket.clear()
        engine.ttft_ms.clear()
        counters.counters.reset()
        results, wall = post_mixed(url, requests)
        torch.cuda.synchronize()
        snap = counters.counters.snapshot()
        n_admitted = engine.admitted - admitted0
        n_retired = engine.retired - retired0
        ttft = list(engine.ttft_ms)
        by_bucket = dict(engine.prefills_by_bucket)
        draft_by_bucket = dict(engine.draft_prefills_by_bucket)
        # the same engine's buffered plain greedy answers to the greedy
        # speculative prompts and the two streamed ones, then the greedy
        # speculative requests alone: tokens/s of each
        spec_prompts = greedy_spec + [streamed[1]]
        plain_reqs = [{"prompt": requests[i]["prompt"],
                       "n_new": requests[i]["n_new"]}
                      for i in spec_prompts + [streamed[0]]]
        plain, plain_wall = post_all(url, plain_reqs)
        alone, alone_wall = post_all(url, [dict(requests[i], stream=False)
                                           for i in greedy_spec])
        stats = engine.stats()
    finally:
        api.stop()
    for i, res in enumerate(results + plain + alone):
        if res is None or res[0] != 200:
            raise AssertionError("request %d failed: %r" % (i, res))
    for i, res in enumerate(results):
        if res[1].get("engine") != "continuous":
            raise AssertionError("request %d (%s) was not served by the "
                                 "pool: %r" % (i, modes[i], res[1]))
    # greedy speculative == the same engine's plain greedy
    plain_of = {i: plain[k][1]["tokens"]
                for k, i in enumerate(spec_prompts + [streamed[0]])}
    for i in spec_prompts:
        got = results[i][1]["tokens"]
        if got != plain_of[i]:
            raise AssertionError(
                "request %d: greedy speculative tokens differ from plain "
                "greedy: %r" % (i, first_divergence(
                    model, requests[i]["prompt"], got, plain_of[i])))
    for k, i in enumerate(greedy_spec):
        if alone[k][1]["tokens"] != plain_of[i]:
            raise AssertionError("request %d alone differs" % i)
    # sampled speculative == solo generate_speculative, one seed
    for i in sampled_spec:
        req = requests[i]
        solo, _ = generate_speculative(
            model, draft, req["prompt"], SPEC_N_NEW, gamma=4,
            temperature=SPEC_TEMP, seed=req["seed"])
        if results[i][1]["tokens"] != solo:
            raise AssertionError("request %d: sampled speculative tokens "
                                 "differ from solo" % i)
    # beam == solo beam_generate
    beam_err = 0.0
    for i in beams:
        solo, st = beam_generate(model, requests[i]["prompt"], BEAM_N_NEW,
                                 beam=4)
        if results[i][1]["tokens"] != solo:
            raise AssertionError("request %d: beam tokens %r != solo %r"
                                 % (i, results[i][1]["tokens"], solo))
        beam_err = max(beam_err, float(numpy.abs(
            numpy.asarray(results[i][1]["scores"])
            - numpy.asarray(st["scores"])).max()))
    if beam_err > 1e-5:
        raise AssertionError("beam scores pooled vs solo differ by %g"
                             % beam_err)
    # SSE: the events' tokens are the terminal answer and the buffered
    # one, the first event arrives before the terminal one
    stream_rec = []
    for i in streamed:
        code, final, _, events, first, last = results[i]
        toks = [t for ev in events if not ev.get("done")
                for t in ev["tokens"]]
        if not final.get("done") or toks != final["tokens"]:
            raise AssertionError("request %d: streamed tokens %r != the "
                                 "answer %r" % (i, toks, final))
        if toks != plain_of[i]:
            raise AssertionError("request %d: streamed tokens differ from "
                                 "the buffered answer" % i)
        if not (len(events) >= 2 and first < last):
            raise AssertionError("request %d: %d events, first %.3f s, "
                                 "last %.3f s" % (i, len(events), first,
                                                  last))
        stream_rec.append({"mode": modes[i],
                           "events": len(events), "first_event_s": first,
                           "terminal_s": last})
    # admission and launches: one target prefill a request (a beam's
    # lead only), one draft prefill a speculative request
    n = len(requests)
    if not n_admitted == n_retired == n:
        raise AssertionError("admitted %d, retired %d, sent %d"
                             % (n_admitted, n_retired, n))
    want_t, want_d = {}, {}
    for req, mode in zip(requests, modes):
        b = engine.scheduler.bucket_for(len(req["prompt"]))
        want_t[b] = want_t.get(b, 0) + 1
        if mode == "speculative":
            want_d[b] = want_d.get(b, 0) + 1
    if by_bucket != want_t or draft_by_bucket != want_d:
        raise AssertionError("prefills by bucket %r / draft %r, want %r "
                             "/ %r" % (by_bucket, draft_by_bucket, want_t,
                                       want_d))
    t_prefills, d_prefills = sum(by_bucket.values()), sum(
        draft_by_bucket.values())
    launches = snap.get("veles_flash_attention_launches_total", 0)
    if launches != n_blocks * t_prefills + 1 * d_prefills:
        raise AssertionError("flash launches %d != %d x %d + %d"
                             % (launches, n_blocks, t_prefills,
                                d_prefills))
    if engine.page_pool.ledger() or engine.page_pool.in_use():
        raise AssertionError("pages left in use: %r"
                             % engine.page_pool.ledger())

    # the target as its own draft: every draft token verifies
    self_api = GenerationAPI(model, port=0, batch_window=0.5, draft=model,
                             name="self_draft", **SPEC_ENGINE).initialize()
    self_engine = self_api._engine
    try:
        self_url = "http://127.0.0.1:%d/generate" % self_api.port
        self_reqs = [dict(requests[i], stream=False)
                     for i in greedy_spec[:2]]
        self_res, self_wall = post_all(self_url, self_reqs)
    finally:
        self_api.stop()
    for k, i in enumerate(greedy_spec[:2]):
        code, body, _ = self_res[k]
        if code != 200 or body.get("engine") != "continuous":
            raise AssertionError("self-draft request %d: %r" % (i, body))
        if body["acceptance"] != 1.0:
            raise AssertionError("self-draft acceptance %r (rounds %r)"
                                 % (body["acceptance"], body["rounds"]))
        if body["tokens"] != plain_of[i]:
            raise AssertionError(
                "self-draft request %d differs from plain greedy: %r"
                % (i, first_divergence(model, requests[i]["prompt"],
                                       body["tokens"], plain_of[i])))
    if self_engine.page_pool.ledger() or self_engine.page_pool.in_use():
        raise AssertionError("self-draft pages left in use")

    spec_tokens = sum(len(r[1]["tokens"]) for r in alone)
    plain_tokens = sum(len(r[1]["tokens"]) for r in plain)
    spec_stats = [results[i][1] for i in greedy_spec + sampled_spec]
    emit("serve_spec_beam", card=card, engine=SPEC_ENGINE,
         draft_blocks=1, requests=n,
         modes={m: modes.count(m)
                for m in ("greedy", "sample", "speculative", "beam")},
         streamed=len(streamed), wall_s=wall,
         tokens=sum(len(r[1]["tokens"]) for r in results),
         tokens_per_s=sum(len(r[1]["tokens"]) for r in results) / wall,
         spec_greedy_tokens_per_s=spec_tokens / alone_wall,
         plain_greedy_tokens_per_s=plain_tokens / plain_wall,
         spec_greedy_requests=len(alone), plain_greedy_requests=len(plain),
         spec_greedy_wall_s=alone_wall, plain_greedy_wall_s=plain_wall,
         acceptance=[s["acceptance"] for s in spec_stats],
         rounds=[s["rounds"] for s in spec_stats],
         self_draft_acceptance=[r[1]["acceptance"] for r in self_res],
         self_draft_rounds=[r[1]["rounds"] for r in self_res],
         self_draft_tokens_per_s=sum(len(r[1]["tokens"])
                                     for r in self_res) / self_wall,
         ttft_ms_p50=pct(ttft, 50), ttft_ms_max=max(ttft),
         spec_round_ms_p50=pct(engine.spec_ms, 50),
         beam_step_ms_p50=pct(engine.beam_ms, 50),
         decode_tick_ms_p50=pct(engine.decode_ms, 50),
         spec_rounds=snap.get("veles_serving_spec_rounds_total", 0),
         beam_steps=snap.get("veles_serving_beam_steps_total", 0),
         beam_score_max_abs_err=beam_err, stream=stream_rec,
         prefills=t_prefills, draft_prefills=d_prefills,
         prefills_by_bucket=by_bucket,
         draft_prefills_by_bucket=draft_by_bucket,
         flash_launches=launches, n_blocks=n_blocks,
         peak_slots=engine.peak_slots, peak_pages=engine.peak_pages,
         kv_pool_bytes=stats["kv_pool_bytes"],
         row_bits_8_in_32=spec_row_bits(),
         phase_s=time.perf_counter() - t_phase)
    return launches


#: serve_qos_handoff's preemption mix: 8 batch requests (greedy and
#: sampled at 0.8 in turn) that fill the pool, then 4 interactive greedy
#: ones once every row has emitted QOS_MIN_EMITTED tokens
QOS_BATCH_LENGTHS = (60, 250, 900, 1800, 120, 480, 1024, 1500)
QOS_BATCH_N_NEW = 48
QOS_INTER_LENGTHS = (60, 120, 250, 480)
QOS_INTER_N_NEW = 16
QOS_MIN_EMITTED = 8
QOS_TEMP = 0.8
#: the wire resume: the decode fault's clause (the 9th decode dispatch
#: raises once)
QOS_WIRE_FAULT = "serve.decode_step:raise:after=8,times=1"
#: the drain: 8 requests in flight and 2 queued, each asking this many
#: tokens
HANDOFF_N_NEW = 200
HANDOFF_REQUESTS = 10
#: the lane's preempted rows and their interactive arrivals
LANE_QOS_N_NEW = 16
LANE_QOS_MIN_EMITTED = 4


def qos_load():
    """The preemption mix as engine requests, a seed each."""
    import numpy
    from veles_tpu_torch.serving import make_request
    rng = numpy.random.RandomState(16)
    batch = []
    for i, n in enumerate(QOS_BATCH_LENGTHS):
        sampled = bool(i % 2)
        req = make_request(rng.randint(0, 256, n).tolist(), QOS_BATCH_N_NEW,
                           temperature=QOS_TEMP if sampled else 0.0,
                           seed=3000 + i,
                           mode="sample" if sampled else "greedy")
        req["priority"] = "batch"
        batch.append(req)
    inter = []
    for n in QOS_INTER_LENGTHS:
        req = make_request(rng.randint(0, 256, n).tolist(), QOS_INTER_N_NEW)
        req["priority"] = "interactive"
        inter.append(req)
    return batch, inter


def wait_until(cond, limit, what):
    deadline = time.perf_counter() + limit
    while not cond():
        if time.perf_counter() > deadline:
            raise AssertionError("timed out waiting for %s" % what)
        time.sleep(0.0005)


def qos_mix(model, qos, batch, inter, count=False):
    """The mix on a started continuous engine built with
    ``root.common.serving.qos = qos``: the batch tickets fill the pool,
    the interactive ones arrive once every row has emitted
    QOS_MIN_EMITTED tokens. ``count`` zeroes the counters just before
    and snapshots them just after. Each admission of a preempted
    request is timed on the host (it ends in the first token's copy)."""
    import torch
    from veles_tpu_torch.config import root
    from veles_tpu_torch.serving import ContinuousEngine
    from veles_tpu_torch.serving.scheduler import Ticket
    from veles_tpu_torch.telemetry import counters

    root.common.serving.qos = qos
    try:
        engine = ContinuousEngine(model, name="qos_" + str(qos).lower(),
                                  **CONT_ENGINE)
    finally:
        root.common.serving.qos = False
    resumed_ms = []
    admit = engine._admit

    def timed_admit(slot):
        t0 = time.perf_counter()
        admit(slot)
        if slot.req.get("_requeued"):
            resumed_ms.append((time.perf_counter() - t0) * 1e3)
    engine._admit = timed_admit
    engine.start()
    try:
        if count:
            counters.counters.reset()
        hist = counters.histograms
        e2e0 = hist.count("veles_serving_e2e_seconds")
        qw0 = hist.count("veles_serving_queue_wait_seconds")
        tb = [Ticket(mode=r["mode"]) for r in batch]
        t0 = time.perf_counter()
        for req, ticket in zip(batch, tb):
            if not engine.submit(dict(req), ticket):
                raise AssertionError("batch request refused")

        def rows_ready():
            rows = engine.scheduler.active()
            return len(rows) == len(batch) and all(
                len(s.tokens) >= QOS_MIN_EMITTED for s in rows)
        wait_until(rows_ready, 120, "the batch rows' first tokens")
        emitted = sorted(len(s.tokens) for s in engine.scheduler.active())
        # stamped enqueued here, as they arrive
        ti = [Ticket() for _ in inter]
        for req, ticket in zip(inter, ti):
            if not engine.submit(dict(req), ticket):
                raise AssertionError("interactive request refused")
        wait_until(lambda: all(t.event.is_set() for t in tb + ti), 300,
                   "the mix's answers")
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        snap = counters.counters.snapshot() if count else None
        e2e = hist.count("veles_serving_e2e_seconds") - e2e0
        qw = hist.count("veles_serving_queue_wait_seconds") - qw0
    finally:
        engine.stop()
    for ticket in tb + ti:
        if ticket.error is not None:
            raise AssertionError("qos=%s: %s (%d)" % (qos, ticket.error,
                                                      ticket.code))
    return dict(engine=engine, batch=tb, inter=ti, wall=wall, snap=snap,
                e2e=e2e, qw=qw, resumed_ms=resumed_ms,
                emitted_at_arrival=emitted,
                ttft=[(t.first_token - t.enqueued) * 1e3 for t in ti],
                tokens=sum(len(t.result["tokens"]) for t in tb + ti))


def check_tokens(model, req, got, want, what):
    """Fail on a token mismatch; a greedy one prints where the lists
    part, both tokens' logits and their margin."""
    if got == want:
        return
    detail = (first_divergence(model, req["prompt"], got, want)
              if not req.get("temperature") else {"got": got, "want": want})
    raise AssertionError("%s: %r" % (what, detail))


def qos_wire(model):
    """(b): one greedy and one sampled request answered 503 with
    ``resume.tokens`` by an API whose decode fault fires once; a second
    API finishes each from ``resume_tokens`` + the remaining ``n_new``.
    Returns per request (tokens done, the generator states' equality)."""
    import numpy
    import torch
    from veles_tpu_torch.nn import sampling
    from veles_tpu_torch.restful_api import GenerationAPI
    rng = numpy.random.RandomState(17)
    reqs = [{"prompt": rng.randint(0, 256, 250).tolist(), "n_new": 32,
             "seed": 4001},
            {"prompt": rng.randint(0, 256, 480).tolist(), "n_new": 32,
             "mode": "sample", "temperature": QOS_TEMP, "seed": 4002}]
    a = GenerationAPI(model, port=0, batch_window=0.5, name="qos_wire_a",
                      **CONT_ENGINE).initialize()
    b = GenerationAPI(model, port=0, batch_window=0.5, name="qos_wire_b",
                      **CONT_ENGINE).initialize()
    try:
        url_b = "http://127.0.0.1:%d/generate" % b.port
        full, _ = post_all(url_b, reqs)
        os.environ["VELES_FAULTS"] = QOS_WIRE_FAULT
        try:
            cut, _ = post_all("http://127.0.0.1:%d/generate" % a.port,
                              reqs)
        finally:
            del os.environ["VELES_FAULTS"]
        done = []
        for i, res in enumerate(cut):
            if res is None or res[0] != 503 or "resume" not in res[1]:
                raise AssertionError("wire request %d was not cut with "
                                     "progress: %r" % (i, res))
            toks = res[1]["resume"]["tokens"]
            if not 0 < len(toks) < reqs[i]["n_new"] \
                    or res[1]["resume"]["tokens_done"] != len(toks):
                raise AssertionError("wire request %d: resume %r"
                                     % (i, res[1]["resume"]))
            done.append(toks)
        rest, _ = post_all(url_b, [
            dict(r, n_new=r["n_new"] - len(d), resume_tokens=d)
            for r, d in zip(reqs, done)])
    finally:
        a.stop()
        b.stop()
    out = []
    for i, req in enumerate(reqs):
        if full[i][0] != 200 or rest[i][0] != 200 \
                or rest[i][1].get("engine") != "continuous":
            raise AssertionError("wire request %d: %r / %r"
                                 % (i, full[i], rest[i]))
        check_tokens(model, req, done[i] + rest[i][1]["tokens"],
                     full[i][1]["tokens"], "wire request %d resumed" % i)
        rec = {"mode": req.get("mode", "greedy"), "tokens_done": len(done[i])}
        if req.get("temperature"):
            # the resumed row's generator (offset arithmetic on the card)
            # against one that replayed the k draws
            k, device = len(done[i]), model.device
            replayed = torch.Generator(device=device)
            replayed.manual_seed(req["seed"])
            sampling.replay_draws(replayed, k, 256)
            adv = sampling.advanced_generator(req["seed"], k, 256, device)
            if not torch.equal(adv.get_state(), replayed.get_state()):
                raise AssertionError("the advanced generator's state after "
                                     "%d draws differs from the replay" % k)
            rec["generator_state_equal"] = True
            if device.type == "cuda":
                rec["draw_offset"] = sampling._draw_offset(256, device)
        out.append(rec)
    return out


def qos_drain(model):
    """(c): 8 requests in flight and 2 queued over HTTP, then
    ``api.drain()`` with the default settings (handoff on)."""
    import numpy
    from veles_tpu_torch.config import root
    from veles_tpu_torch.restful_api import GenerationAPI
    from veles_tpu_torch.telemetry import counters
    rng = numpy.random.RandomState(18)
    reqs = [{"prompt": rng.randint(0, 256, CONT_LENGTHS[i % 4]).tolist(),
             "n_new": HANDOFF_N_NEW, "seed": 4100 + i}
            for i in range(HANDOFF_REQUESTS)]
    api = GenerationAPI(model, port=0, batch_window=0.5, name="qos_drain",
                        **CONT_ENGINE).initialize()
    engine = api._engine
    url = "http://127.0.0.1:%d/generate" % api.port
    results = [None] * len(reqs)

    def fire(i):
        results[i] = post(url, reqs[i])
    threads = []
    try:
        for i in range(len(reqs)):
            threads.append(threading.Thread(target=fire, args=(i,)))
            threads[-1].start()
        n_slots = CONT_ENGINE["max_slots"]

        def in_flight():
            # past a decode tick (not just the prefills' first tokens),
            # so the tick's time is known
            rows = engine.scheduler.active()
            return (len(rows) == n_slots and engine.decode_ms
                    and all(len(s.tokens) >= 2 for s in rows)
                    and engine.scheduler.queue_depth()
                    == len(reqs) - n_slots)
        wait_until(in_flight, 120, "8 rows decoding and 2 queued")
        left = max(HANDOFF_N_NEW - len(s.tokens)
                   for s in engine.scheduler.active())
        tick_ms = pct(engine.decode_ms, 50)
        ho0 = counters.get("veles_handoff_requests_total")
        shed0 = counters.get("veles_shed_requests_total")
        t0 = time.perf_counter()
        drained = api.drain()
        drain_s = time.perf_counter() - t0
    finally:
        for th in threads:
            th.join(timeout=120)
        api.stop()
    handed = counters.get("veles_handoff_requests_total") - ho0
    shed = counters.get("veles_shed_requests_total") - shed0
    with_resume = [r for r in results if r and r[0] == 503
                   and r[1].get("resume", {}).get("tokens")]
    without = [r for r in results if r and r[0] == 503
               and "resume" not in r[1]]
    time_left_s = left * tick_ms / 1e3
    grace = float(root.common.serving.get("drain_grace", 30.0))
    if not drained or len(with_resume) != n_slots \
            or len(without) != len(reqs) - n_slots or handed != n_slots \
            or shed < len(reqs) - n_slots:
        raise AssertionError("drain: drained %s, %d handed back with "
                             "progress, %d shed without, counter %d / shed "
                             "%d: %r" % (drained, len(with_resume),
                                         len(without), handed, shed,
                                         [r and r[:2] for r in results]))
    if not drain_s < time_left_s:
        raise AssertionError("the drain took %.3f s, the longest "
                             "generation had %.3f s left" % (drain_s,
                                                             time_left_s))
    return dict(requests=len(reqs), handed_back=handed,
                shed_without_progress=len(without), drain_s=drain_s,
                tokens_left_longest=left, decode_tick_ms_p50=tick_ms,
                time_left_longest_s=time_left_s,
                grace_s=grace, grace_would_wait_s=min(grace, time_left_s),
                resume_tokens_done=sorted(len(r[1]["resume"]["tokens"])
                                          for r in with_resume))


def qos_lane():
    """(d): a greedy and a sampled batch row on the LSTM char LM at
    serve_recurrent's 512 x 6, preempted by two interactive arrivals on a
    2-slot lane driven tick by tick; both equal solo
    ``generate_recurrent``."""
    import numpy
    import torch
    from veles_tpu_torch.config import root
    from veles_tpu_torch.serving import (RecurrentEngine, generate_recurrent,
                                         make_request)
    from veles_tpu_torch.serving.recurrent import split_recurrent_stack
    from veles_tpu_torch.serving.scheduler import Ticket
    model = recurrent_lm("lstm")
    vocab = split_recurrent_stack(list(model))["head"].vocab_size
    rng = numpy.random.RandomState(19)
    batch = []
    for i, mode in enumerate(("greedy", "sample")):
        req = make_request(rng.randint(0, vocab, 60).tolist(),
                           LANE_QOS_N_NEW,
                           temperature=QOS_TEMP if mode == "sample" else 0.0,
                           seed=5000 + i, mode=mode)
        req["priority"] = "batch"
        batch.append(req)
    inter = [make_request(rng.randint(0, vocab, 30).tolist(), 4)
             for _ in batch]
    root.common.serving.qos = True
    try:
        engine = RecurrentEngine(model, name="qos_lane",
                                 **dict(RECURRENT_ENGINE, max_slots=2))
    finally:
        root.common.serving.qos = False
    tb = [Ticket(mode=r["mode"]) for r in batch]
    ti = [Ticket() for _ in inter]
    t0 = time.perf_counter()
    with torch.inference_mode():
        for req, ticket in zip(batch, tb):
            engine.submit(dict(req), ticket)
        for _ in range(200):
            rows = engine.scheduler.active()
            if len(rows) == 2 and all(len(s.tokens) >= LANE_QOS_MIN_EMITTED
                                      for s in rows):
                break
            engine._tick()
        for req, ticket in zip(inter, ti):
            engine.submit(dict(req), ticket)
        for _ in range(400):
            if all(t.event.is_set() for t in tb + ti):
                break
            engine._tick()
    wall = time.perf_counter() - t0
    engine.stop()
    for ticket in tb + ti:
        if ticket.error is not None or not ticket.event.is_set():
            raise AssertionError("lane: %r" % ticket.error)
    if engine.preemptions != 2:
        raise AssertionError("lane preemptions %d" % engine.preemptions)
    for req, ticket in zip(batch, tb):
        solo = generate_recurrent(model, req["prompt"], req["n_new"],
                                  temperature=req["temperature"],
                                  seed=req["seed"], mode=req["mode"])
        if ticket.result["tokens"] != solo:
            raise AssertionError("lane %s row after preemption %r != solo "
                                 "%r" % (req["mode"], ticket.result["tokens"],
                                         solo))
    return dict(preemptions=engine.preemptions,
                preempted_tokens=engine.preempted_tokens, wall_s=wall)


def phase_serve_qos_handoff(card):
    """The QoS plane, token-level resume and drain by handoff on the
    bench LM behind the default continuous engine, and preemption on the
    O(1)-state lane."""
    from veles_tpu_torch.nn import sampling
    from veles_tpu_torch.serving import ContinuousEngine, make_request

    t_phase = time.perf_counter()
    model = bench_lm()
    n_blocks = sum(1 for c in BENCH_LAYERS
                   if c["type"] == "transformer_block")
    batch, inter = qos_load()
    warm = ContinuousEngine(model, name="qos_warm", **CONT_ENGINE).start()
    try:
        warm.serve([make_request(batch[0]["prompt"], 2),
                    make_request(batch[1]["prompt"], 2,
                                 temperature=QOS_TEMP, mode="sample")])
    finally:
        warm.stop()

    # (a) preemption: QoS on (counted), QoS off over the same mix, then
    # each batch request alone on a QoS-off engine
    on = qos_mix(model, True, batch, inter, count=True)
    off = qos_mix(model, False, batch, inter)
    engine, snap = on["engine"], on["snap"]
    alone_engine = ContinuousEngine(model, name="qos_alone", **CONT_ENGINE)
    alone_engine.start()
    try:
        alone = [alone_engine.serve([dict(r)])[0] for r in batch]
    finally:
        alone_engine.stop()
    preempted = [t for t in on["batch"] if t.progress is not None]
    if engine.preemptions < len(inter) \
            or len(preempted) != engine.preemptions \
            or snap.get("veles_qos_preemptions_total", 0) \
            != engine.preemptions:
        raise AssertionError("preemptions %d (counter %s), %d tickets "
                             "with progress" % (
                                 engine.preemptions,
                                 snap.get("veles_qos_preemptions_total"),
                                 len(preempted)))
    victim_tokens = sum(len(t.progress) for t in preempted)
    if not victim_tokens == engine.preempted_tokens == snap.get(
            "veles_qos_preempted_tokens_total", 0):
        raise AssertionError("preempted tokens %d (counter %s), the victims "
                             "had emitted %d" % (
                                 engine.preempted_tokens,
                                 snap.get("veles_qos_preempted_tokens_total"),
                                 victim_tokens))
    if off["engine"].preemptions:
        raise AssertionError("the QoS-off engine preempted")
    for i, req in enumerate(batch):
        got = on["batch"][i].result["tokens"]
        check_tokens(model, req, got, alone[i],
                     "batch request %d (%s) vs alone" % (i, req["mode"]))
        check_tokens(model, req, off["batch"][i].result["tokens"], alone[i],
                     "batch request %d on the QoS-off mix" % i)
        if req["mode"] == "greedy":
            check_tokens(model, req, got, sampling.generate(
                model, req["prompt"], req["n_new"], temperature=0),
                "batch request %d vs plain greedy" % i)
    for i, req in enumerate(inter):
        check_tokens(model, req, on["inter"][i].result["tokens"],
                     sampling.generate(model, req["prompt"], req["n_new"],
                                       temperature=0),
                     "interactive request %d" % i)
    n = len(batch) + len(inter)
    if not (engine.admitted == engine.retired == on["e2e"] == on["qw"] == n):
        raise AssertionError("admitted %d, retired %d, e2e %d, queue wait %d;"
                             " want %d" % (engine.admitted, engine.retired,
                                          on["e2e"], on["qw"], n))
    want = {}
    for req in batch + inter:
        b = engine.scheduler.bucket_for(len(req["prompt"]))
        want[b] = want.get(b, 0) + 1
    for req, ticket in zip(batch, on["batch"]):
        if ticket.progress is not None:
            b = engine.scheduler.bucket_for(len(req["prompt"])
                                            + len(ticket.progress))
            want[b] = want.get(b, 0) + 1
    prefills = snap.get("veles_serving_prefill_dispatches_total", 0)
    launches = snap.get("veles_flash_attention_launches_total", 0)
    if engine.prefills_by_bucket != want \
            or prefills != n + engine.preemptions \
            or launches != n_blocks * prefills:
        raise AssertionError("prefills %d by bucket %r (want %r), flash "
                             "launches %d" % (prefills,
                                              engine.prefills_by_bucket,
                                              want, launches))
    for eng in (engine, off["engine"]):
        if eng.page_pool.ledger() or eng.page_pool.in_use():
            raise AssertionError("pages left in use: %r"
                                 % eng.page_pool.ledger())
    preemption_s = time.perf_counter() - t_phase

    wire = qos_wire(model)
    drain = qos_drain(model)
    lane = qos_lane()
    emit("serve_qos_handoff", card=card, engine=CONT_ENGINE,
         batch_prompts=list(QOS_BATCH_LENGTHS), batch_n_new=QOS_BATCH_N_NEW,
         interactive_prompts=list(QOS_INTER_LENGTHS),
         interactive_n_new=QOS_INTER_N_NEW,
         emitted_at_arrival=on["emitted_at_arrival"],
         preemptions=engine.preemptions,
         preempted_tokens=engine.preempted_tokens,
         interactive_ttft_ms_p50=pct(on["ttft"], 50),
         interactive_ttft_ms_p50_qos_off=pct(off["ttft"], 50),
         interactive_ttft_ms_max=max(on["ttft"]),
         interactive_ttft_ms_max_qos_off=max(off["ttft"]),
         resumed_prefill_ms_p50=pct(on["resumed_ms"], 50),
         resumed_prefill_ms_max=max(on["resumed_ms"]),
         resumed_prefill_buckets=sorted(
             engine.scheduler.bucket_for(len(r["prompt"]) + len(t.progress))
             for r, t in zip(batch, on["batch"]) if t.progress is not None),
         tokens_per_s=on["tokens"] / on["wall"],
         tokens_per_s_qos_off=off["tokens"] / off["wall"],
         wall_s=on["wall"], wall_s_qos_off=off["wall"],
         decode_tick_ms_p50=pct(engine.decode_ms, 50),
         admitted=engine.admitted, retired=engine.retired,
         prefills=prefills, prefills_by_bucket=engine.prefills_by_bucket,
         flash_launches=launches, n_blocks=n_blocks,
         preemption_s=preemption_s,
         wire=wire, drain=drain, lane=lane,
         phase_s=time.perf_counter() - t_phase)
    return launches


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
    from veles_tpu_torch.telemetry import cost, counters
    # the card's published dense peaks (telemetry/cost.py), TFLOP/s
    peaks = {"bf16": cost.peak_flops("bfloat16", "H100") / 1e12,
             "f32": cost.peak_flops("float32", "H100") / 1e12}
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
                share_of_bf16_peak=tflops / peaks["bf16"],
                share_of_f32_peak=tflops / peaks["f32"],
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
         peaks_tflops=peaks, **records)
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
    from veles_tpu_torch.telemetry import cost
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
    bound_ms = nbytes / cost.hbm_bandwidth("H100") * 1e3
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
    """Host wall ms of ``fn()`` (synchronised on both sides) under
    torch.profiler, read through ``telemetry.devtime.measure``: the
    device's busy ms (each stream's kernel, memcpy and memset intervals
    unioned, summed over the streams), its idle share, the device events
    (kernel launches, copies and fills) and the top kernels by device
    time; ``matched_ms`` sums the device ms of every kernel whose name
    holds each of ``match``. A capture with no device event raises."""
    from veles_tpu_torch.telemetry import devtime
    rec = devtime.measure(fn, span_records=[])
    kernels = sorted(((r["device_time_s"] * 1e3, name, r["events"])
                      for name, r in rec["by_kernel"].items()),
                     reverse=True)
    return dict(
        profiled_wall_ms=rec["wall_time_s"] * 1e3,
        device_busy_ms=rec["device_time_s"] * 1e3,
        device_idle_share=rec["idle_share"],
        kernel_launches=sum(k[2] for k in kernels),
        top_kernels=[{"name": k[1][:80], "ms": k[0], "calls": k[2]}
                     for k in kernels[:12]],
        matched_ms={m: sum(k[0] for k in kernels if m in k[1])
                    for m in match})


def kernel_events(rec, name):
    """(events, device s) of the kernels holding ``name`` in a
    ``devtime.measure`` record."""
    rows = [r for k, r in rec["by_kernel"].items() if name in k]
    return (sum(r["events"] for r in rows),
            sum(r["device_time_s"] for r in rows))


def phase_telemetry(card):
    """The telemetry plane on the serving and training paths: spans off
    vs on, a devtime capture of each, the flash kernel's noted costs."""
    import torch
    from veles_tpu_torch.config import root
    from veles_tpu_torch.ops import flash_attention as fa
    from veles_tpu_torch.restful_api import GenerationAPI
    from veles_tpu_torch.telemetry import chrome_trace, cost, devtime
    from veles_tpu_torch.telemetry import counters
    from veles_tpu_torch.telemetry.spans import recorder

    model = bench_lm()
    requests = continuous_load()
    n_blocks = sum(1 for c in BENCH_LAYERS
                   if c["type"] == "transformer_block")
    heads = BENCH_LAYERS[1]["n_heads"]
    head_dim = BENCH_LAYERS[0]["dim"] // heads
    greedy = [i for i, r in enumerate(requests) if "mode" not in r]
    runs = {}
    prev = root.common.trace.spans
    try:
        # off, on, off: an order effect shows as the two off runs apart
        for spans in (False, True, None):
            root.common.trace.spans = bool(spans)
            api = GenerationAPI(model, port=0, **CONT_ENGINE).initialize()
            url = "http://127.0.0.1:%d" % api.port
            out = {}
            try:
                counters.counters.reset()
                counters.histograms.reset()
                if spans:
                    cursor = recorder.cursor()
                    with cost.collecting_kernel_costs() as notes:
                        rec = devtime.measure(lambda: out.update(
                            zip(("results", "wall"),
                                post_all(url + "/generate", requests))))
                    with urllib.request.urlopen(url + "/metrics",
                                                timeout=60) as r:
                        page = r.read().decode()
                    records, _ = recorder.records_since(cursor)
                else:
                    out["results"], out["wall"] = post_all(
                        url + "/generate", requests)
                torch.cuda.synchronize()
                snap = counters.counters.snapshot()
                buckets = [api._engine.scheduler.bucket_for(
                    len(r["prompt"])) for r in requests]
            finally:
                api.stop()
            for i, res in enumerate(out["results"]):
                if res is None or res[0] != 200 \
                        or res[1].get("engine") != "continuous":
                    raise AssertionError("spans %s: request %d: %r"
                                         % (spans, i, res))
            out.update(snap=snap, tokens=sum(len(r[1]["tokens"])
                                             for r in out["results"]))
            runs[spans] = out
    finally:
        root.common.trace.spans = prev
    on = runs[True]
    order = [runs[False], on, runs[None]]
    launches = [run["snap"].get(fa.FWD_LAUNCHES, 0) for run in order]
    n = len(requests)
    if launches != [n_blocks * n] * 3:
        raise AssertionError("flash launches off/on/off %r, want %d each"
                             % (launches, n_blocks * n))
    for run in (runs[False], runs[None]):
        for i in greedy:
            if run["results"][i][1]["tokens"] \
                    != on["results"][i][1]["tokens"]:
                raise AssertionError("greedy request %d: tokens differ "
                                     "with spans on" % i)
    sampled_equal = all(runs[False]["results"][i][1]["tokens"]
                        == on["results"][i][1]["tokens"]
                        for i in range(n) if i not in greedy)
    if rec["source"] != "profiler" or not rec["device_time_s"] > 0:
        raise AssertionError("devtime record %r" % {
            k: rec.get(k) for k in ("source", "device_time_s")})
    per_span = rec.get("spans", {})
    for name in ("serving.prefill", "serving.decode_step"):
        if not per_span.get(name, {}).get("device_time_s", 0) > 0:
            raise AssertionError("no device time under %s: %r"
                                 % (name, per_span.get(name)))
    if per_span["serving.prefill"]["spans"] != n:
        raise AssertionError("%d serving.prefill spans, want %d"
                             % (per_span["serving.prefill"]["spans"], n))
    req_spans = [r for r in records if r["name"] == "request"]
    if len(req_spans) != n or any(r["outcome"] != "retired"
                                  for r in req_spans):
        raise AssertionError("request spans %r" % [
            r.get("outcome") for r in req_spans])
    flash_events, flash_s = kernel_events(rec, "flash_fwd_kernel")
    if flash_events != launches[1]:
        raise AssertionError("%d flash-forward kernel events in the "
                             "capture, %d launches counted"
                             % (flash_events, launches[1]))
    metric = {}
    for line in page.splitlines():
        for name in ("veles_serving_ttft_seconds_count",
                     "veles_serving_e2e_seconds_count"):
            if line.startswith(name + " "):
                metric[name] = float(line.split()[1])
    if metric != {"veles_serving_ttft_seconds_count": n,
                  "veles_serving_e2e_seconds_count": n}:
        raise AssertionError("/metrics histogram counts %r" % metric)
    trace_errors = chrome_trace.validate(
        {"traceEvents": chrome_trace.to_trace_events(records)})
    if trace_errors:
        raise AssertionError("chrome trace: %r" % trace_errors[:3])
    # the analytic costs the kernel noted at its launches
    model_cost = cost.CostModel(peak_flops=cost.peak_flops("float32"))
    for note in notes:
        model_cost.record("flash_attention_fwd", note)
    total = model_cost.total()
    want = n_blocks * sum(fa.analytic_cost(1, b, heads, head_dim, True)[0]
                          for b in buckets)
    if len(notes) != launches[1] or total.flops != want:
        raise AssertionError("noted %d costs, %.6g FLOPs; want %d, %.6g"
                             % (len(notes), total.flops, launches[1],
                                want))
    report = model_cost.report({"flash_attention_fwd": flash_s})
    row = report["flash_attention_fwd"]
    emit("telemetry", card=card, path="serve_continuous", requests=n,
         tokens=on["tokens"],
         tokens_per_s_off_on_off=[run["tokens"] / run["wall"]
                                  for run in order],
         greedy_tokens_equal=True, sampled_tokens_equal=sampled_equal,
         flash_launches=launches, source=rec["source"],
         clock=rec["clock"], device_time_s=rec["device_time_s"],
         wall_time_s=rec["wall_time_s"], idle_share=rec["idle_share"],
         by_stream=rec["by_stream"],
         spans={k: v for k, v in per_span.items()
                if k.startswith("serving.") or k == "request"},
         span_records=len(records), flash_kernel_events=flash_events,
         flash_device_s=flash_s, metrics_counts=metric,
         noted_flops=total.flops, noted_bytes=total.bytes_accessed,
         flash_tflops_per_s=row["tflops_per_sec"],
         share_of_f32_peak=row["mfu"],
         share_of_tf32_peak=total.flops / flash_s
         / cost.peak_flops("tf32"),
         flash_flops_per_wall_s=total.flops / rec["wall_time_s"],
         peak_entries=[cost.peak_flops_entry("float32"),
                       cost.peak_flops_entry("tf32")])

    # training: one fused-FC epoch block under the capture
    wf = mnist_workflow(True, epochs=4, per_dispatch=4)
    counters.counters.reset()
    train = devtime.measure(wf.run)
    ffc_launches = counters.get("veles_fused_fc_launches_total")
    ffc_events, ffc_s = kernel_events(train, "fused_fc_sgd_kernel")
    block = train.get("spans", {}).get("train_step.epoch_block", {})
    if train["source"] != "profiler" or ffc_launches != 4 \
            or ffc_events != ffc_launches:
        raise AssertionError("fused-FC events %d, launches %d (%s)"
                             % (ffc_events, ffc_launches,
                                train["source"]))
    if not block.get("device_time_s", 0) >= ffc_s > 0:
        raise AssertionError("train_step.epoch_block device time %r < "
                             "the fused-FC kernel's %.6f s"
                             % (block, ffc_s))
    emit("telemetry", card=card, path="train", epochs=4,
         fused_fc_launches=ffc_launches, fused_fc_kernel_events=ffc_events,
         fused_fc_device_s=ffc_s, epoch_block=block,
         device_time_s=train["device_time_s"],
         wall_time_s=train["wall_time_s"], idle_share=train["idle_share"],
         clock=train["clock"])
    return launches[1], ffc_launches


#: cli: the model files a user would write, run through
#: ``python -m veles_tpu_torch`` (in process for MNIST, to read its
#: launch counter; as subprocesses for the bench LM)
CLI_MNIST_MODEL = """
import os

import torch

from veles_tpu_torch.models import mnist

#: the run's final weights, biases and momenta, saved beside this file
STATE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "mnist_state.pt")


def build_workflow():
    wf = mnist.build_workflow(epochs=4, epochs_per_dispatch=2)
    gather = wf.gather_results

    def gather_results():
        torch.save({"%s/%s/%s" % (attr, name, k): t.detach().cpu()
                    for attr in ("params", "opt_state")
                    for name, p in getattr(wf.train_step, attr).items()
                    for k, t in p.items()}, STATE)
        return gather()
    wf.gather_results = gather_results
    return wf
"""
#: the MNIST CLI run's seed: not the default root.common.random_seed
#: (SEED), so a --random-seed that went unapplied shows in the weights
CLI_MNIST_SEED = 4321
#: the bench LM of ``train_lm`` with a Snapshotter; its results also
#: carry the per-epoch NLL/token and this process's kernel launches
CLI_LM_MODEL = """
from veles_tpu_torch.models import char_lm
from veles_tpu_torch.snapshotter import Snapshotter
from veles_tpu_torch.telemetry import counters


def build_workflow():
    wf = char_lm.build_bench_workflow(
        snapshotter_unit=Snapshotter(None, prefix="benchlm"))
    wf.decision.max_epochs = 1
    gather = wf.gather_results

    def gather_results():
        out = gather()
        out["nll_per_token"] = {str(c): list(wf.decision.epoch_losses[c])
                                for c in (1, 2)}
        out["launches"] = {k: v for k, v in
                           counters.counters.snapshot().items()
                           if "launches" in k}
        return out
    wf.gather_results = gather_results
    return wf
"""
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
#: the serving knobs of serve_continuous as CLI flags
CLI_SERVE_FLAGS = ["--serve-slots", "8",
                   "--serve-buckets", "128,256,512,1024,2048",
                   "--serve-max-context", "2048", "--serve-page-size", "16"]
CLI_DRAIN_GRACE = 30.0


def cli_load():
    """12 requests: 8 greedy and 4 sampled with seeds, prompts of 60 to
    1,800 tokens, n_new 16/32/48 (serve_continuous's mix, halved)."""
    import numpy
    rng = numpy.random.RandomState(4)
    reqs = []
    for i, length in enumerate(CONT_LENGTHS * 2):
        req = {"prompt": [int(x) for x in rng.randint(0, 256, length)],
               "n_new": CONT_N_NEW[i % 3], "seed": 2000 + i}
        if i >= 8:
            req.update(mode="sample", temperature=0.8)
        reqs.append(req)
    return reqs


def cli_command(*argv):
    return [sys.executable, "-m", "veles_tpu_torch", *argv]


def cli_env():
    return dict(os.environ, PYTHONPATH=REPO)


def cli_run(argv, timeout):
    """Run ``python -m veles_tpu_torch ARGV``; (rc, stdout, stderr)."""
    r = subprocess.run(cli_command(*argv), cwd=REPO, capture_output=True,
                       text=True, timeout=timeout, env=cli_env())
    return r.returncode, r.stdout, r.stderr


def metric_value(text, name):
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    return 0.0


def phase_cli(card, lm_losses):
    """The CLI on the card: MNIST through the fused-FC kernel in process;
    the bench LM trained, snapshotted, resumed and served in
    ``python -m veles_tpu_torch`` subprocesses; the subcommands. Returns
    the phase's launches per kernel."""
    import shutil
    import signal
    import tempfile
    import torch
    from veles_tpu_torch import prng
    from veles_tpu_torch.__main__ import main as cli_main
    from veles_tpu_torch.config import root
    from veles_tpu_torch.models import char_lm
    from veles_tpu_torch.nn.standard_workflow import forwards_of
    from veles_tpu_torch.ops import flash_attention as fa
    from veles_tpu_torch.restful_api import GenerationAPI
    from veles_tpu_torch.snapshotter import resume
    from veles_tpu_torch.telemetry import counters
    from veles_tpu_torch.telemetry import chrome_trace

    tmp = tempfile.mkdtemp(prefix="veles_cli_")
    procs = []
    spans, trace_violations = None, ["not exported"]
    try:
        paths = {}
        for name, text in (("mnist_model.py", CLI_MNIST_MODEL),
                           ("lm_model.py", CLI_LM_MODEL),
                           ("tiny_model.py", CLI_TINY_MODEL)):
            paths[name] = os.path.join(tmp, name)
            with open(paths[name], "w") as fout:
                fout.write(text)
        # 4. --backend auto --dry-run, beside the in-process run
        dry = subprocess.Popen(
            cli_command(paths["tiny_model.py"], "--backend", "auto",
                        "--dry-run", "-v"), cwd=REPO, env=cli_env(),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        procs.append(dry)

        # 1. MNIST in process: the fused-FC kernel, bits of the direct run
        import logging
        log = []
        handler = logging.Handler(logging.INFO)
        handler.emit = lambda rec: log.append(rec.getMessage())
        launcher_log = logging.getLogger("Launcher")
        launcher_log.addHandler(handler)
        prev_level = launcher_log.level
        launcher_log.setLevel(logging.INFO)
        mnist_res = os.path.join(tmp, "mnist.json")
        try:
            counters.counters.reset()
            t0 = time.perf_counter()
            cli_main([paths["mnist_model.py"],
                      "root.common.engine.fused_fc_scan=true",
                      "--random-seed", str(CLI_MNIST_SEED),
                      "--result-file", mnist_res])
            torch.cuda.synchronize()
            mnist_s = time.perf_counter() - t0
            ffc_cli = int(counters.get("veles_fused_fc_launches_total"))
        finally:
            launcher_log.removeHandler(handler)
            launcher_log.setLevel(prev_level)
        with open(mnist_res) as fin:
            mnist_out = json.load(fin)
        cli_state = torch.load(os.path.join(tmp, "mnist_state.pt"))
        direct = mnist_workflow(True, epochs=4, per_dispatch=2,
                                seed=CLI_MNIST_SEED)
        counters.counters.reset()
        direct.run()
        ffc_direct = int(counters.get("veles_fused_fc_launches_total"))
        root.common.engine.fused_fc_scan = False
        direct_valid = list(direct.decision.epoch_metrics[1])
        direct_state = mnist_trees(direct)
        # the final weights, biases and momenta, bit for bit
        mnist_state_equal = cli_state.keys() == direct_state.keys() \
            and len(cli_state) == 8 \
            and all(torch.equal(cli_state[k], direct_state[k])
                    for k in cli_state)
        cuda_logged = any(m.startswith("initialized mnist-784 on cuda")
                          for m in log)

        # 2. the bench LM trained in a subprocess, with a snapshot
        snaps = os.path.join(tmp, "snaps")
        lm_res = os.path.join(tmp, "lm.json")
        t0 = time.perf_counter()
        rc, _out, err = cli_run([paths["lm_model.py"], "--snapshot-dir",
                                 snaps, "--random-seed", str(LM_SEED),
                                 "--result-file", lm_res, "-v"], 600)
        train_s = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError("cli: bench LM training exited %d:\n%s"
                                 % (rc, err[-3000:]))
        with open(lm_res) as fin:
            lm_out = json.load(fin)
        current = os.path.join(snaps, "benchlm_current.pickle.gz")
        nll = {int(c): v for c, v in lm_out["nll_per_token"].items()}
        nll_rel = max(abs(a - b) / abs(b) for c in (1, 2)
                      for a, b in zip(nll[c], lm_losses[c]))
        nll_bits = all(a == b for c in (1, 2)
                       for a, b in zip(nll[c], lm_losses[c]))
        lm_launches = lm_out["launches"]

        # 3. the same model file served from its snapshot
        trace = os.path.join(tmp, "serve.jsonl")
        box = os.path.join(tmp, "box")
        t0 = time.perf_counter()
        server = subprocess.Popen(
            cli_command(paths["lm_model.py"], "--snapshot", current,
                        "--snapshot-dir", box, "--blackbox",
                        "--trace-file", trace, "--serve-generate", "0",
                        "--serve-drain-grace", str(CLI_DRAIN_GRACE),
                        "-v", *CLI_SERVE_FLAGS),
            cwd=REPO, env=cli_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        procs.append(server)
        head = []
        port = None
        while port is None:
            line = server.stdout.readline()
            if not line:
                raise AssertionError("cli: the server exited %s before "
                                     "serving:\n%s" % (server.poll(),
                                                       "".join(head[-40:])))
            if line.startswith("SERVING port="):
                port = int(line.split("=", 1)[1])
            else:
                head.append(line)
        startup_s = time.perf_counter() - t0
        # keep reading: a full pipe would stall the server's logging
        reader = threading.Thread(target=lambda: head.extend(
            iter(server.stdout.readline, "")), daemon=True)
        reader.start()
        base = "http://127.0.0.1:%d" % port
        requests = cli_load()
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            flash_before = metric_value(r.read().decode(), fa.FWD_LAUNCHES)
        results, wall = post_all(base + "/generate", requests)
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            flash_after = metric_value(r.read().decode(), fa.FWD_LAUNCHES)
        probes = {}
        for path in ("/healthz", "/readyz"):
            with urllib.request.urlopen(base + path, timeout=60) as r:
                probes[path] = r.status
        t0 = time.perf_counter()
        server.send_signal(signal.SIGTERM)
        server.wait(timeout=CLI_DRAIN_GRACE + 60)
        drain_s = time.perf_counter() - t0
        reader.join(timeout=60)
        served_log = "".join(head)
        resume_s = None
        for line in served_log.splitlines():
            if "resumed from" in line and line.rstrip().endswith(" s)"):
                resume_s = float(line.rsplit("(", 1)[1].split()[0])

        # 4. the subcommands, beside the in-process serving below
        trace_out = os.path.join(tmp, "serve_trace.json")
        exporter = subprocess.Popen(
            cli_command("trace", "export", trace, trace_out), cwd=REPO,
            env=cli_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        procs.append(exporter)
        dumps = sorted(f for f in os.listdir(box)
                       if f.startswith("blackbox-")) \
            if os.path.isdir(box) else []
        inspector = subprocess.Popen(
            cli_command("blackbox", "inspect", os.path.join(
                box, dumps[0]) if dumps else os.path.join(box, "none")),
            cwd=REPO, env=cli_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        procs.append(inspector)

        # the same snapshot served in this process, the default engine
        prng.seed_all(LM_SEED)
        wf = char_lm.build_bench_workflow()
        wf.decision.max_epochs = 1
        wf.initialize()
        resume(wf, current)
        api = GenerationAPI(forwards_of(wf), port=0, **CONT_ENGINE)
        api.initialize()
        try:
            local, _ = post_all("http://127.0.0.1:%d/generate" % api.port,
                                requests)
        finally:
            api.stop()
        del wf
        _, ex_err = exporter.communicate(timeout=300)
        in_out, in_err = inspector.communicate(timeout=300)
        _, dry_err = dry.communicate(timeout=300)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        root.common.engine.fused_fc_scan = False
        root.common.random_seed = SEED
    if exporter.returncode == 0:
        with open(trace_out) as fin:
            doc = json.load(fin)
        spans = sum(1 for e in doc["traceEvents"]
                    if e.get("name") == "serving.prefill"
                    and e.get("ph") == "X")
        trace_violations = chrome_trace.validate(doc)
    shutil.rmtree(tmp, ignore_errors=True)
    answered = [r for r in results if r is not None and r[0] == 200]
    tokens = sum(len(r[1]["tokens"]) for r in answered)
    prefills = len(requests)
    n_blocks = sum(1 for c in BENCH_LAYERS
                   if c["type"] == "transformer_block")
    same_tokens = [r is not None and l is not None
                   and r[1].get("tokens") == l[1].get("tokens")
                   for r, l in zip(results, local)]
    flash_served = int(flash_after - flash_before)
    emit("cli", card=card,
         mnist={"launches": ffc_cli, "launches_direct": ffc_direct,
                "validation_err": mnist_out["err_history"]["validation"],
                "validation_err_direct": direct_valid,
                "bit_identical": mnist_out["err_history"]["validation"]
                == direct_valid, "state_bit_identical": mnist_state_equal,
                "state_tensors": len(cli_state),
                "cuda_logged": cuda_logged,
                "run_s": mnist_s},
         lm_train={"rc": rc, "wall_s": train_s,
                   # Launcher.run's wall: the epoch and the snapshot export
                   "run_s": lm_out.get("elapsed_sec"),
                   "nll_per_token": nll,
                   "nll_max_rel_diff": nll_rel, "nll_bits_equal": nll_bits,
                   "launches": lm_launches,
                   "snapshot": os.path.basename(current)},
         serve={"answers_200": len(answered), "requests": len(requests),
                "tokens_equal_in_process": sum(same_tokens),
                "tokens": tokens, "wall_s": wall,
                "tokens_per_s": tokens / wall if wall else None,
                "startup_to_serving_s": startup_s, "resume_s": resume_s,
                "flash_launches": flash_served, "prefills": prefills,
                "probes": probes, "exit_code": server.returncode,
                "drain_s": drain_s,
                "drain_complete": "drain complete" in served_log},
         subcommands={"trace_export_rc": exporter.returncode,
                      "serving_prefill_spans": spans,
                      "blackbox_dumps": len(dumps),
                      "blackbox_inspect_rc": inspector.returncode,
                      "dry_run_rc": dry.returncode})
    if ffc_cli != 4 or ffc_direct != 4 or not cuda_logged:
        raise AssertionError("cli: MNIST fused-FC launches %d (direct %d), "
                             "cuda logged %s" % (ffc_cli, ffc_direct,
                                                 cuda_logged))
    if not mnist_state_equal:
        raise AssertionError("cli: MNIST weights, biases and momenta %s "
                             "differ from the direct run's %s" % (
                                 sorted(cli_state), sorted(direct_state)))
    if mnist_out["err_history"]["validation"] != direct_valid:
        raise AssertionError("cli: MNIST validation errors %s differ from "
                             "the direct run's %s" % (
                                 mnist_out["err_history"]["validation"],
                                 direct_valid))
    want = {fa.FWD_LAUNCHES: n_blocks * 72, fa.DKV_LAUNCHES: n_blocks * 64,
            fa.DQ_LAUNCHES: n_blocks * 64}
    if any(lm_launches.get(k) != v for k, v in want.items()):
        raise AssertionError("cli: bench LM launches %s, want %s"
                             % (lm_launches, want))
    if nll_rel > TOL_LM_LOSS_REL:
        raise AssertionError("cli: bench LM NLL/token differs from "
                             "train_lm's by %g relative" % nll_rel)
    if len(answered) != len(requests) or not all(same_tokens):
        raise AssertionError("cli: %d of %d answered, %d equal to the "
                             "in-process engine's" % (
                                 len(answered), len(requests),
                                 sum(same_tokens)))
    if flash_served != n_blocks * prefills:
        raise AssertionError("cli: flash launches %d, want %d x %d"
                             % (flash_served, n_blocks, prefills))
    if probes != {"/healthz": 200, "/readyz": 200}:
        raise AssertionError("cli: probes %s" % probes)
    if server.returncode != 0 or "drain complete" not in served_log \
            or drain_s > CLI_DRAIN_GRACE + 30:
        raise AssertionError("cli: SIGTERM gave exit %s in %.1f s:\n%s"
                             % (server.returncode, drain_s,
                                served_log[-3000:]))
    if exporter.returncode != 0 or spans != prefills or trace_violations:
        raise AssertionError("cli: trace export rc %s, %s serving.prefill "
                             "spans, %s" % (exporter.returncode, spans,
                                            ex_err[-2000:]))
    if inspector.returncode != 0 or len(dumps) != 1 \
            or "reason:  SIGTERM" not in in_out:
        raise AssertionError("cli: blackbox inspect rc %s on %s:\n%s%s"
                             % (inspector.returncode, dumps, in_out,
                                in_err[-2000:]))
    if dry.returncode != 0 or "on cuda:" not in dry_err:
        raise AssertionError("cli: --backend auto --dry-run exited %s:\n%s"
                             % (dry.returncode, dry_err[-2000:]))
    return {"fwd": lm_launches[fa.FWD_LAUNCHES] + flash_served,
            "dkv": lm_launches[fa.DKV_LAUNCHES],
            "dq": lm_launches[fa.DQ_LAUNCHES], "fused_fc": ffc_cli}


#: the Znicz units on the card vs the port on the CPU, float32 (max abs
#: error over max(1, max|cpu|): cuDNN and cuBLAS sum in another order)
TOL_ZNICZ = 1e-4
#: dropout's kept share of 10^6 elements against keep
TOL_KEEP_SHARE = 0.002
ALEX_SEED = 41
ALEX_EPOCHS = 2
TOL_ALEX_STEP_REL = 1e-4
#: a card gradient's distance to float64 over the CPU's float32 one
ALEX_GRAD_GRADE = 2.0
ALEX_PROFILED_STEPS = 4
UNSUP_SEED = 1234
RBM_STEPS = 200
TOL_RBM_STEP_REL = 1e-4


def cached_loads(module, name):
    """Patch ``module.name`` (a dataset loader) with a cache of its
    results for the phase, so a card and a CPU workflow load the same
    rows once; returns the undo."""
    import functools
    real = getattr(module, name)
    setattr(module, name, functools.lru_cache(maxsize=2)(real))
    return lambda: setattr(module, name, real)


def znicz_unit_cases():
    """(name, unit, input shape) of the Znicz units with a gradient:
    LRN at n 5 and 3 over odd channel counts, the cutter."""
    from veles_tpu_torch.nn import cutter, normalization

    def lrn(n):
        return normalization.LRNormalizerForward(None, name="u", n=n,
                                                 alpha=1e-4, beta=0.75, k=2.0)
    return [("lrn_n5_c95", lrn(5), (16, 27, 27, 95)),
            ("lrn_n3_c33", lrn(3), (16, 13, 13, 33)),
            ("lrn_n5_c3", lrn(5), (8, 55, 55, 3)),
            ("cutter_asym", cutter.Cutter(None, name="u",
                                          padding=(2, 1, 3, 0)),
             (8, 32, 31, 16))]


def solver_updates(device, solver, kw, seed):
    """One update of an All2All GD unit's ``solver`` with the knobs
    ``kw`` from a state two steps old, on ``device``: the new params and
    state, flattened to {path: CPU tensor}."""
    import numpy
    import torch
    from veles_tpu_torch.nn import all2all
    from veles_tpu_torch.workflow import Workflow
    rng = numpy.random.RandomState(seed)
    gd = all2all.GradientDescent(Workflow(name="s"), solver=solver,
                                 learning_rate=0.01, **kw)
    params = {"weights": torch.from_numpy(rng.randn(784, 100).astype(
        "float32") * 0.05).to(device),
        "bias": torch.from_numpy(rng.randn(100).astype("float32")).to(device)}
    state = gd.init_state(params)
    out = {}
    for step in range(3):
        grads = {k: torch.from_numpy(rng.randn(*v.shape).astype("float32")
                                     * (1 + step)).to(device)
                 for k, v in params.items()}
        params, state = gd.update(params, grads, state, 0.9)

    def flat(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                flat(v, prefix + "/" + k)
        else:
            out[prefix] = tree.float().cpu()
    flat({"params": params, "state": state}, "")
    return out


def phase_znicz_units(card):
    """The rest of the Znicz layer set on the card against the port on
    the CPU: LRN and the cutter (forward and the gradients of sum(y·g)),
    channel split and merge, ``som_step``, ``cd1_step`` with given
    uniforms, each new solver and clipping knob on an update; dropout
    and stochastic pooling by their semantics (evaluation exact,
    seed determinism, dropout's kept share and scale, picks inside
    their windows). No hand-written kernel launches."""
    import numpy
    import torch
    from veles_tpu_torch.memory import Array
    from veles_tpu_torch.nn import channel_split, dropout, kohonen, pooling
    from veles_tpu_torch.nn import rbm
    from veles_tpu_torch.telemetry import counters
    from veles_tpu_torch.workflow import Workflow
    if torch.backends.cudnn.allow_tf32 or \
            torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the f32 policy was undone")
    t0 = time.perf_counter()
    counters.counters.reset()
    worst = {}
    for i, (name, u, shape) in enumerate(znicz_unit_cases()):
        x = numpy.random.RandomState(500 + i).randn(*shape).astype(
            "float32") * 3
        want = unit_outputs(u, x, {}, "cpu", 500 + i)
        worst[name] = conv_error(unit_outputs(u, x, {}, "cuda", 500 + i),
                                 want)
    # channel split and merge through the units' own runs
    x = numpy.random.RandomState(510).rand(16, 27, 27, 96).astype("float32")
    split_merge = {}
    for dev in ("cpu", "cuda"):
        wf = Workflow(name="split")
        sp = channel_split.ChannelSplitter(wf, sizes=(17, 31, 48))
        sp.input = Array(x)
        sp.initialize(device=dev)
        sp.run()
        mg = channel_split.ChannelMerger(wf, inputs=sp.outputs)
        mg.initialize(device=dev)
        mg.run()
        split_merge[dev] = [o.map_read() for o in sp.outputs] + [
            mg.output.map_read()]
    split_exact = all(numpy.array_equal(a, b) for a, b in zip(
        split_merge["cpu"], split_merge["cuda"])) and numpy.array_equal(
        split_merge["cuda"][-1], x)
    # som_step: 16×16 neurons over 784 features, 100 samples
    rng = numpy.random.RandomState(520)
    w0 = rng.rand(256, 784).astype("float32")
    xs = rng.rand(100, 784).astype("float32")
    grid = kohonen._grid_coords(16, 16)
    som = {}
    for dev in ("cpu", "cuda"):
        w, win, q = kohonen.som_step(
            torch.from_numpy(w0).to(dev), torch.from_numpy(grid).to(dev),
            torch.from_numpy(xs).to(dev), 0.3, 2.5)
        som[dev] = {"w": w.cpu(), "q": q.reshape(1).cpu(),
                    "winners": win.cpu()}
    worst["som_step"] = conv_error(
        {k: som["cuda"][k] for k in ("w", "q")},
        {k: som["cpu"][k] for k in ("w", "q")})
    som_winners_equal = bool(torch.equal(som["cuda"]["winners"],
                                          som["cpu"]["winners"]))
    # cd1_step with given uniforms: 784 → 256, mb 64
    p0 = {"weights": rng.randn(784, 256).astype("float32") * 0.01,
          "vbias": rng.randn(784).astype("float32") * 0.01,
          "hbias": rng.randn(256).astype("float32") * 0.01}
    v0 = rng.rand(64, 784).astype("float32")
    uni = rng.rand(64, 256).astype("float32")
    cd = {}
    for dev in ("cpu", "cuda"):
        new, err = rbm.cd1_step(
            {k: torch.from_numpy(v).to(dev) for k, v in p0.items()},
            torch.from_numpy(v0).to(dev), torch.from_numpy(uni).to(dev),
            0.1)
        cd[dev] = {k: v.cpu() for k, v in dict(new, err=err.reshape(1))
                   .items()}
    worst["cd1_step"] = conv_error(cd["cuda"], cd["cpu"])
    solvers = [("adagrad", {}), ("rmsprop", {}), ("adadelta", {}),
               ("sgd", {"gradient_clip": 0.5, "gradient_moment": 0.9}),
               ("adam", {"gradient_clip_norm": 1.0}),
               ("adadelta", {"gradient_clip": 0.2,
                             "gradient_clip_norm": 5.0})]
    for i, (solver, kw) in enumerate(solvers):
        name = "_".join([solver] + [k.replace("gradient_", "")
                                    for k in sorted(kw) if "clip" in k])
        worst[name] = conv_error(
            solver_updates("cuda", solver, kw, 530 + i),
            solver_updates("cpu", solver, kw, 530 + i))
    # dropout: evaluation, seeds, kept share and scale
    keep = 0.7
    drop = dropout.DropoutForward(None, dropout_ratio=1 - keep)
    xd = torch.rand((1000, 1000), device="cuda") + 0.5

    def dgen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)
    yd = drop.apply({}, xd, train=True, generator=dgen(3))
    kept = yd != 0
    dropout_rec = dict(
        eval_identity=bool(torch.equal(drop.apply({}, xd), xd)),
        same_seed_same_mask=bool(torch.equal(
            yd, drop.apply({}, xd, train=True, generator=dgen(3)))),
        other_seed_other_mask=not bool(torch.equal(
            yd, drop.apply({}, xd, train=True, generator=dgen(4)))),
        kept_share=float(kept.float().mean()), keep=keep,
        kept_equal_x_over_keep=bool(torch.equal(yd[kept], xd[kept] / keep)))
    # stochastic pooling: evaluation, seeds, picks inside their windows
    xs4 = torch.from_numpy(numpy.random.RandomState(540).randn(
        8, 27, 27, 32).astype("float32")).to("cuda")
    sp = pooling.StochasticPooling(None, kx=3, ky=3, sliding=(2, 2))
    ys = sp.apply({}, xs4, train=True, generator=dgen(5))
    wins = sp._padded(xs4, float("-inf")).unfold(2, 3, 2).unfold(3, 3, 2)
    wins = wins.reshape(wins.shape[:4] + (9,)).permute(0, 2, 3, 4, 1)
    stochastic_rec = dict(
        eval_equals_max_pooling=bool(torch.equal(
            sp.apply({}, xs4), pooling.MaxPooling(
                None, kx=3, ky=3, sliding=(2, 2)).apply({}, xs4))),
        same_seed_same_picks=bool(torch.equal(ys, sp.apply(
            {}, xs4, train=True, generator=dgen(5)))),
        picks_in_window=bool((wins == ys[:, :, :, None, :]).any(
            dim=3).all()),
        picks_finite=bool(torch.isfinite(ys).all()))
    torch.cuda.synchronize()
    launches = kernel_launches()
    emit("znicz_units", card=card, limit=TOL_ZNICZ, worst_rel_err=worst,
         som_winners_equal=som_winners_equal,
         split_merge_exact=split_exact, dropout=dropout_rec,
         stochastic_pooling=stochastic_rec,
         hand_written_kernel_launches=launches,
         phase_s=time.perf_counter() - t0)
    bad = {k: v for k, v in worst.items() if not v <= TOL_ZNICZ}
    if bad:
        raise AssertionError("Znicz units off the CPU's: %s" % bad)
    if not (split_exact and som_winners_equal):
        raise AssertionError("split/merge exact %s, SOM winners equal %s"
                             % (split_exact, som_winners_equal))
    if not all(v for k, v in dropout_rec.items()
               if isinstance(v, bool)) or not abs(
                   dropout_rec["kept_share"] - keep) <= TOL_KEEP_SHARE:
        raise AssertionError("dropout: %s" % dropout_rec)
    if not all(stochastic_rec.values()):
        raise AssertionError("stochastic pooling: %s" % stochastic_rec)
    if launches:
        raise AssertionError("the Znicz units launched %d hand-written "
                             "kernels" % launches)


def alexnet_workflow(device=None, image_size=224):
    """The reference's AlexNet at ``image_size`` with its defaults (mb 64,
    1,600 / 320 rows, adam lr 0.001), ALEX_EPOCHS epochs from
    ALEX_SEED, initialised on ``device`` (default: the card)."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.models import alexnet
    prng.seed_all(ALEX_SEED)
    wf = alexnet.build_workflow(epochs=ALEX_EPOCHS, image_size=image_size)
    wf.initialize(device=device)
    return wf


def norm_rel(got, want):
    """‖got − want‖₂ / ‖want‖₂."""
    return float((got.double() - want.double()).norm()
                 / max(float(want.double().norm()), 1e-30))


def counted_flops(wf):
    """(forward FLOPs of one sample, FLOPs of one train step at the
    loader's minibatch) of the workflow's own step, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` on the card; the
    step's result is dropped."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    ts = wf.train_step
    dataset, targets = ts._dataset()
    mb = wf.loader.max_minibatch_size
    idx = torch.arange(mb, dtype=torch.int32, device=ts.device)
    mask = torch.ones(mb, dtype=torch.float32, device=ts.device)
    with FlopCounterMode(display=False) as fwd:
        with torch.no_grad():
            ts._forward(ts.params, dataset[idx[:1].long()])
    with FlopCounterMode(display=False) as step:
        ts._train_step(ts.params, ts.opt_state, ts._zero_accum(), dataset,
                       targets, idx, mask, 1.0, step=0)
    return fwd.get_total_flops(), step.get_total_flops()


def fc_saturation(wf):
    """The share of the last tanh layer's outputs within 1 % of its
    bound ±A (1.7159) on the first 64 validation rows (the reference's
    defaults saturate it at 224 px: adam's first ±lr step moves each of
    its 512 pre-activations by up to lr · Σ|x| over 73,728 inputs)."""
    import torch
    ts = wf.train_step
    dataset, _ = ts._dataset()
    x = dataset[:64]
    with torch.no_grad():
        for f in wf.forwards[:-1]:
            x = f.apply(ts.params.get(f.name, {}), x)
    return float((x.abs() > 0.99 * wf.forwards[-2].A).float().mean())


def alexnet_layer_parity(wf, rows=8):
    """Each layer of the workflow at its own 224 px shapes, on ``rows``
    samples of random input and its initial parameters: forward and the
    gradients of sum(y · g) on the card against the CPU, max abs error
    over max(1, max|cpu|) per layer (identical inputs: no upstream
    rounding reaches a layer, nor a max pooling's choice of element)."""
    import numpy
    ts = wf.train_step
    shape = (rows,) + tuple(wf.loader.original_data.shape[1:])
    worst = {}
    for i, f in enumerate(wf.forwards):
        x = numpy.random.RandomState(600 + i).randn(*shape).astype(
            "float32")
        params = {k: v.cpu().numpy() for k, v in ts.params.get(
            f.name, {}).items()}
        want = unit_outputs(f, x, params, "cpu", 600 + i)
        worst[f.name] = conv_error(unit_outputs(f, x, params, "cuda",
                                                600 + i), want)
        shape = tuple(want["y"].shape)
    return worst


#: AlexNet's conv2 at 224 px: (rows, H, W, C_in) and (ky, kx, C_in, C_out)
CONV2_SHAPES = ((8, 109, 109, 48), (5, 5, 48, 128))


def conv_wgrad_record():
    """AlexNet's conv2 weight gradient on the card against the float64
    one (max abs error over max|f64|): cuDNN's under its default,
    deterministic and benchmark flags, and the port's path (cuDNN off
    for the weight gradient, ``nn/conv._CardConv2d``); and the ms of a
    64-row forward and backward through each."""
    import numpy
    import torch
    import torch.nn.functional as F
    from veles_tpu_torch.nn.conv import _CardConv2d
    (b, h, w, c), (ky, kx, _, o) = CONV2_SHAPES
    rng = numpy.random.RandomState(700)
    x = torch.from_numpy(rng.randn(b, c, h, w)).cuda().contiguous(
        memory_format=torch.channels_last)
    wt = torch.from_numpy(rng.randn(o, c, ky, kx) / numpy.sqrt(ky * kx * c)
                          ).cuda()
    gy = torch.from_numpy(rng.randn(b, o, h - ky + 1, w - kx + 1)).cuda()
    want = torch.nn.grad.conv2d_weight(x, wt.shape, gy)
    xb = x.float().repeat(8, 1, 1, 1).contiguous(
        memory_format=torch.channels_last)
    gyb = gy.float().repeat(8, 1, 1, 1)

    def grad(fn, xx, g):
        ww = wt.float().requires_grad_(True)
        fn(xx, ww).backward(g)
        return ww.grad

    def library(a, ww):
        return F.conv2d(a, ww)

    def port(a, ww):
        return _CardConv2d.apply(a, ww, (1, 1), (0, 0))
    rec = {}
    for name, fn, flags in (
            ("cudnn", library, {}),
            ("cudnn_deterministic", library, {"deterministic": True}),
            ("cudnn_benchmark", library, {"benchmark": True}),
            ("port", port, {})):
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False,
                                        **flags):
            got = grad(fn, x.float(), gy.float())
            rec[name] = dict(
                max_rel_err=float((got.double() - want).abs().max()
                                  / want.abs().max()),
                ms_mb64=cuda_time_ms(lambda: grad(fn, xb, gyb), 5))
    return rec


def first_step_grads(wf, dtype):
    """The gradients of the workflow's first train minibatch at its
    initial parameters in ``dtype`` on its device, as float64 CPU
    tensors."""
    import torch
    ts = wf.train_step
    dataset, targets = ts._dataset()
    mb = wf.loader.max_minibatch_size
    start = wf.loader.class_lengths[0] + wf.loader.class_lengths[1]
    idx = torch.arange(start, start + mb, device=ts.device)
    params = {n: {k: v.to(dtype) for k, v in p.items()}
              for n, p in ts.params.items()}
    _, _, grads = ts._grads(params, dataset[idx].to(dtype), targets[idx],
                            torch.ones(mb, dtype=dtype, device=ts.device))
    return {(n, k): v.double().cpu()
            for n, g in grads.items() for k, v in g.items()}


def phase_train_alexnet(card):
    """AlexNet at 224 px through ``mcdnnic_topology`` (five convs): the
    first two adam steps on the card against the CPU, ALEX_EPOCHS epochs
    with the validation error finite and not rising, the counted work's
    TFLOP/s, peak memory, 4 profiled train steps; then one epoch of the
    STL-10 workflow at 96 px."""
    import torch
    from veles_tpu_torch import prng
    from veles_tpu_torch.models import alexnet, cifar
    from veles_tpu_torch.nn.conv import Conv
    from veles_tpu_torch.telemetry import cost, counters
    t_phase = time.perf_counter()
    undo = cached_loads(alexnet, "load_synthetic")
    try:
        host = adam_first_steps(alexnet_workflow("cpu"))
        wf = alexnet_workflow()
        mine = adam_first_steps(wf, starts=[h[2] for h in host])
    finally:
        undo()
    layer_parity = alexnet_layer_parity(wf)
    wgrad = conv_wgrad_record()
    # the float32 gradient's own spread: the card in float32 and in
    # float64 against the CPU in float32 (adam's first m is (1 − β1)·g)
    beta1 = wf.train_step._gd_for[wf.forwards[0].name].beta1
    grads_cpu = {(u, k): v.double() / (1 - beta1)
                 for (u, m, k), v in host[0][1].items() if m == "m"}
    grads_card = first_step_grads(wf, torch.float32)
    grads_f64 = first_step_grads(wf, torch.float64)
    below_pool = set()
    for f in wf.forwards:
        if f.MAPPING == "max_pooling":
            below_pool = {g.name for g in wf.forwards[:wf.forwards.index(f)]}
    loss_rel = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(mine, host))
    update, grad_spread = {}, {}
    for (_, got, _), (_, want, _) in zip(mine, host):
        for key, w in want.items():
            if key[1] != "update":
                continue
            name = "%s.%s" % (key[0], key[2])
            rel = (norm_rel(got[key], w), float(
                (got[key] - w).abs().max() / w.abs().max()))
            old = update.get(name, (0.0, 0.0))
            update[name] = (max(old[0], rel[0]), max(old[1], rel[1]))
    for key, w in grads_cpu.items():
        grad_spread["%s.%s" % key] = dict(
            card_vs_cpu=norm_rel(grads_card[key], w),
            card_f64_vs_card=norm_rel(grads_card[key], grads_f64[key]),
            cpu_vs_card_f64=norm_rel(w, grads_f64[key]))
    # held: the gradients of the layers above the last max pooling
    # against the CPU's, and every layer's against float64 no further
    # than twice the CPU's float32 one
    held = {k: v["card_vs_cpu"] for k, v in grad_spread.items()
            if k.split(".")[0] not in below_pool}
    grade = {k: v["card_f64_vs_card"] / max(v["cpu_vs_card_f64"], 1e-12)
             for k, v in grad_spread.items()}
    del host
    fwd_flops, step_flops = counted_flops(wf)
    lengths = wf.loader.class_lengths
    mb = wf.loader.max_minibatch_size
    epoch_flops = (lengths[2] // mb * step_flops
                   + lengths[2] % mb * step_flops / mb
                   + lengths[1] * fwd_flops)
    peak_f32 = cost.peak_flops("float32", "H100")
    stamps = stamp_epochs(wf)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters.counters.reset()
    t0 = time.perf_counter()
    wf.run()
    epoch_s = [b - a for a, b in zip([t0] + stamps, stamps)]
    launches = kernel_launches()
    peak = int(torch.cuda.max_memory_allocated())
    d = wf.decision
    valid = d.epoch_metrics[1]

    def window():
        for _ in train_steps(wf, ALEX_PROFILED_STEPS):
            pass
    prof = profiled(window)
    convs = [f for f in wf.forwards if isinstance(f, Conv)]
    saturated = fc_saturation(wf)
    steady = epoch_s[-1]
    tflops = epoch_flops / steady / 1e12
    rec = dict(
        model="alexnet " + alexnet.topology(wf.loader.image_size),
        convs=len(convs),
        mb=mb, rows={"train": lengths[2], "validation": lengths[1]},
        solver=wf.train_step._gd_for[convs[0].name].solver,
        step_loss_rel_diff=loss_rel,
        first_grad_rel_diff_above_pooling=held,
        first_grad_f64_err_card_over_cpu=grade,
        step_update_norm_and_max_rel_diff=update,
        first_grad_norm_rel=grad_spread, layer_parity=layer_parity,
        conv2_wgrad=wgrad,
        below_a_max_pooling=sorted(below_pool),
        fwd_gflop_per_sample=fwd_flops / 1e9,
        train_step_gflop=step_flops / 1e9, epoch_tflop=epoch_flops / 1e12,
        epoch_ms=[t * 1e3 for t in epoch_s], valid_err=valid,
        valid_loss=d.epoch_losses[1], train_err=d.epoch_metrics[2],
        train_loss=d.epoch_losses[2], fc_saturated_share=saturated,
        train_samples_per_s=lengths[2] / steady, model_tflops_per_s=tflops,
        share_of_f32_peak=tflops / (peak_f32 / 1e12),
        peak_memory_bytes=peak, hand_written_kernel_launches=launches,
        profiled_train_steps=ALEX_PROFILED_STEPS,
        launches_per_step=prof["kernel_launches"] / ALEX_PROFILED_STEPS,
        profiled=prof)
    del wf
    torch.cuda.empty_cache()
    # the conv family's STL-10 workflow, one epoch at 96 px
    prng.seed_all(ALEX_SEED)
    stl = cifar.build_stl10_workflow(epochs=1)
    stl.initialize()
    counters.counters.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stl.run()
    torch.cuda.synchronize()
    stl_s = time.perf_counter() - t0
    stl_launches = kernel_launches()
    sl = stl.loader.class_lengths
    rec["stl10"] = dict(image_size=96, mb=stl.loader.max_minibatch_size,
                        rows={"train": sl[2], "validation": sl[1]},
                        epoch_ms=stl_s * 1e3,
                        train_samples_per_s=sl[2] / stl_s,
                        valid_err=stl.decision.epoch_metrics[1],
                        hand_written_kernel_launches=stl_launches)
    emit("train_alexnet", card=card, phase_s=time.perf_counter() - t_phase,
         **rec)
    if not max([loss_rel] + list(held.values())) <= TOL_ALEX_STEP_REL:
        raise AssertionError("the first AlexNet steps on the card differ "
                             "from the CPU's: loss %g, gradients %s relative"
                             % (loss_rel, held))
    bad = {k: v for k, v in grade.items() if not v <= ALEX_GRAD_GRADE}
    if bad:
        raise AssertionError("AlexNet gradients on the card further from "
                             "float64 than the CPU's float32: %s" % bad)
    bad = {k: v for k, v in layer_parity.items() if not v <= TOL_ZNICZ}
    if bad:
        raise AssertionError("AlexNet layers off the CPU's: %s" % bad)
    if len(convs) != 5 or d.epoch_number != ALEX_EPOCHS:
        raise AssertionError("AlexNet: %d convs, %d epochs"
                             % (len(convs), d.epoch_number))
    losses = d.epoch_losses[2]
    if not all(math.isfinite(x) for x in valid + d.epoch_losses[1]
               + losses) or not losses[-1] < losses[0]:
        raise AssertionError("AlexNet: validation error %s, train loss %s"
                             % (valid, losses))
    if not all(math.isfinite(x) for x in stl.decision.epoch_metrics[1]):
        raise AssertionError("STL-10: %s" % stl.decision.epoch_metrics)
    if launches or stl_launches:
        raise AssertionError("AlexNet / STL-10 launched %d / %d "
                             "hand-written kernels" % (launches,
                                                       stl_launches))


def phase_train_unsupervised(card):
    """DemoKohonen at the reference's CI anchor and an RBM 784 → 256 on
    MNIST's surrogate rows, on the card: the SOM's final quantisation
    error below 0.25 and below its first epoch's; the RBM's first 5
    CD-1 steps against the CPU's from the same uniforms, its
    reconstruction error falling over RBM_STEPS steps; ms a step."""
    import torch
    from veles_tpu_torch import datasets, prng
    from veles_tpu_torch.models import kohonen_demo, rbm_mnist
    from veles_tpu_torch.telemetry import counters
    t_phase = time.perf_counter()
    counters.counters.reset()
    qerr = {}
    for dev in ("cpu", "cuda"):
        prng.seed_all(UNSUP_SEED)
        som = kohonen_demo.build_workflow(epochs=8, minibatch_size=100,
                                          n_train=600)
        som.initialize(device=dev)
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        som.run()
        if dev == "cuda":
            torch.cuda.synchronize()
            som_ms = (time.perf_counter() - t0) * 1e3 / som.trainer.time
        qerr[dev] = som.gather_results()["qerr_history"]
    som_rel = max(abs(a - b) / b for a, b in zip(qerr["cuda"], qerr["cpu"]))
    undo = cached_loads(datasets, "load_mnist")
    try:
        steps = {}
        for dev in ("cpu", "cuda"):
            prng.seed_all(UNSUP_SEED)
            wf = rbm_mnist.build_workflow(n_train=RBM_STEPS * 64)
            wf.initialize(device=dev)
            out = []
            for _ in range(5):
                wf.loader.run()
                wf.trainer.run()
                out.append(dict({k: a.map_read().copy() for k, a in
                                 wf.trainer.param_arrays().items()},
                                err=wf.trainer.reconstruction_error))
            steps[dev] = out
        rbm_rel = max(
            max(abs(g["err"] - w["err"]) / w["err"],
                max(float(abs(g[k] - w[k]).max() / abs(w[k]).max())
                    for k in ("weights", "vbias", "hbias")))
            for g, w in zip(steps["cuda"], steps["cpu"]))
        prng.seed_all(UNSUP_SEED)
        rb = rbm_mnist.build_workflow(n_train=RBM_STEPS * 64 // 4)
        rb.initialize()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rb.run()
        torch.cuda.synchronize()
        rbm_ms = (time.perf_counter() - t0) * 1e3 / rb.trainer.steps
    finally:
        undo()
    res = rb.gather_results()
    launches = kernel_launches()
    emit("train_unsupervised", card=card,
         kohonen=dict(shape=[6, 6], epochs=len(qerr["cuda"]), mb=100,
                      rows=600, qerr_history=qerr["cuda"],
                      qerr_history_cpu=qerr["cpu"], rel_diff_vs_cpu=som_rel,
                      ms_per_step=som_ms),
         rbm=dict(visible=784, hidden=rb.trainer.n_hidden,
                  mb=rb.loader.max_minibatch_size, steps=rb.trainer.steps,
                  first_error=res["first_error"],
                  error_history=res["error_history"],
                  first5_rel_diff_vs_cpu=rbm_rel, ms_per_step=rbm_ms),
         hand_written_kernel_launches=launches,
         phase_s=time.perf_counter() - t_phase)
    q = qerr["cuda"]
    if not (len(q) == 8 and q[-1] < 0.25 and q[-1] < q[0]):
        raise AssertionError("DemoKohonen on the card: qerr %s" % q)
    if not rbm_rel <= TOL_RBM_STEP_REL:
        raise AssertionError("the RBM's first steps on the card differ from "
                             "the CPU's by %g" % rbm_rel)
    if rb.trainer.steps != RBM_STEPS or not (
            res["final_error"] < res["first_error"]):
        raise AssertionError("RBM: %d steps, error %s → %s" % (
            rb.trainer.steps, res["first_error"], res["final_error"]))
    if launches:
        raise AssertionError("the unsupervised phase launched %d "
                             "hand-written kernels" % launches)


# -- phases 32-33: the rest of the training library --------------------------

#: the real-text anchor (the reference's tests/test_quality_real_data.py
#: :214-256): CPython's pydoc topics cut to 120,000 characters, a
#: 2-block d 48 char transformer (4 heads of 12), 24 epochs from seed 11
TEXT_CHARS = 120_000
TEXT_SEED = 11
TEXT_EPOCHS = 24
TEXT_MAX_ERR = 0.48
TEXT_MARGIN = 0.05
#: the bench-width text epoch: d 512, 6 blocks (4 heads of 128), T 512
TEXT_BENCH_SEED = 77
#: LoRA, label smoothing: the first two train steps, card vs CPU
TOL_LIBRARY_STEP_REL = 1e-4
LORA_RANK = 8


def pydoc_corpus(directory, limit=None):
    """CPython's pydoc topics joined in key order (cut to ``limit``
    characters), written to ``directory``; returns the path and the
    text."""
    import pydoc_data.topics as topics
    text = "".join(v for _, v in sorted(topics.topics.items()))
    if limit:
        text = text[:limit]
    path = os.path.join(directory, "pydoc_%d.txt" % len(text))
    with open(path, "w", encoding="utf-8") as fout:
        fout.write(text)
    return path, text


def trigram_error(text):
    """The trigram-argmax next-character error on the loader's tail
    split (train on the first 90 % of the characters, score the rest),
    as the reference's anchor computes it."""
    from collections import Counter, defaultdict
    cut = int(len(text) * 0.9)
    train, valid = text[:cut], text[cut:]
    tri = defaultdict(Counter)
    for a, b, c in zip(train, train[1:], train[2:]):
        tri[a + b][c] += 1
    hits = sum(1 for a, b, c in zip(valid, valid[1:], valid[2:])
               if tri[a + b] and tri[a + b].most_common(1)[0][0] == c)
    return 1.0 - hits / (len(valid) - 2)


def flash_counts():
    from veles_tpu_torch.ops import flash_attention as fa
    from veles_tpu_torch.telemetry import counters
    return {"fwd": counters.get(fa.FWD_LAUNCHES),
            "dkv": counters.get(fa.DKV_LAUNCHES),
            "dq": counters.get(fa.DQ_LAUNCHES)}


def text_steps(wf):
    """(train steps, evaluation steps) the loader's plans imply for the
    epochs the decision recorded."""
    ld = wf.loader
    epochs = wf.decision.epoch_number
    return (epochs * ld.plan_rows_for(2),
            epochs * (ld.plan_rows_for(0) + ld.plan_rows_for(1)))


def text_run(path, tensormon_on, **kw):
    """One seeded text char-LM run on the card: (workflow, flash launches
    in the run, synchronising calls in the run, wall ms)."""
    import warnings
    import torch
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.models import char_lm
    from veles_tpu_torch.telemetry import counters
    root.common.engine.flash_attention = True
    root.common.telemetry.tensormon.enabled = bool(tensormon_on)
    prng.seed_all(kw.pop("seed"))
    wf = char_lm.build_workflow(text_file=path, **kw)
    wf.initialize()
    torch.cuda.synchronize()
    counters.counters.reset()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            wf.run()
            torch.cuda.synchronize()
        finally:
            ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum(1 for w in caught if "synchroniz" in str(w.message))
    return wf, flash_counts(), syncs, ms


def phase_train_text(card):
    """(a) the reference's real-text anchor on the card: the pydoc char
    transformer reaches the reference's thresholds through the flash
    kernels at head dim 12, each kernel launched 2 blocks × the steps the
    epochs imply; (b) the same corpus uncut at the bench LM's width (4
    heads of 128) for one epoch, tensormon off and then on from one seed:
    equal parameters and optimiser state, equal flash launches, equal
    synchronising calls, the model-health gauges and one
    ``tensormon.sample`` span per drained sample. Returns the flash
    launches by kernel."""
    import shutil
    import tempfile
    import torch
    from veles_tpu_torch.config import root
    from veles_tpu_torch.telemetry import counters, spans, tensormon
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="veles_text_")
    try:
        path, text = pydoc_corpus(tmp, TEXT_CHARS)
        tri = trigram_error(text)
        wf, launches, _, ms = text_run(
            path, False, seed=TEXT_SEED, epochs=TEXT_EPOCHS,
            minibatch_size=64, n_blocks=2, dim=48)
        res = wf.gather_results()
        train_steps, eval_steps = text_steps(wf)
        want = {"fwd": 2 * (train_steps + eval_steps),
                "dkv": 2 * train_steps, "dq": 2 * train_steps}
        anchor = dict(chars=len(text), windows=wf.loader.class_lengths,
                      vocab=wf.loader.vocab_size, head_dim=48 // 4,
                      epochs=wf.decision.epoch_number,
                      best_err=res["best_err"], trigram_err=tri,
                      best_epoch=res["best_epoch"], launches=launches,
                      expected_launches=want, run_ms=ms,
                      ms_per_epoch=ms / wf.decision.epoch_number)
        del wf
        full, text_full = pydoc_corpus(tmp)
        runs = {}
        for on in (False, True):
            tensormon.monitor.reset()
            spans.recorder.clear()
            wf, lch, syncs, ms = text_run(
                full, on, seed=TEXT_BENCH_SEED, epochs=1, dim=512,
                n_blocks=6, seq_len=512, minibatch_size=16)
            steps = text_steps(wf)
            runs[on] = dict(wf=wf, launches=lch, syncs=syncs, ms=ms,
                            steps=steps,
                            samples=counters.get(
                                "veles_tensormon_samples_total"),
                            spans=len(spans.recorder.records(
                                "tensormon.sample")),
                            text=counters.metrics_text(
                                tensormon.monitor.gauges()))
        off, on = runs[False], runs[True]
        same = all(
            torch.equal(getattr(off["wf"].train_step, tree)[n][k],
                        getattr(on["wf"].train_step, tree)[n][k])
            for tree in ("params",)
            for n in off["wf"].train_step.params
            for k in off["wf"].train_step.params[n])
        same_opt = all(
            torch.equal(a, b) for a, b in zip(
                flat_tree(off["wf"].train_step.opt_state),
                flat_tree(on["wf"].train_step.opt_state)))
        repeat_equal = None
        if not (same and same_opt):
            # tell a tensormon effect from a run that does not repeat:
            # the off run once more
            again = text_run(full, False, seed=TEXT_BENCH_SEED, epochs=1,
                             dim=512, n_blocks=6, seq_len=512,
                             minibatch_size=16)[0]
            repeat_equal = all(torch.equal(a, b) for a, b in zip(
                flat_tree(off["wf"].train_step.params),
                flat_tree(again.train_step.params)))
            del again
        gauges = [ln.split()[0] for ln in on["text"].splitlines()
                  if ln.startswith("veles_model_")]
        bench_train, bench_eval = off["steps"]
        bench_want = {"fwd": 6 * (bench_train + bench_eval),
                      "dkv": 6 * bench_train, "dq": 6 * bench_train}
        bench = dict(chars=len(text_full),
                     windows=off["wf"].loader.class_lengths,
                     head_dim=512 // 4, train_steps=bench_train,
                     eval_steps=bench_eval,
                     epoch_ms={"off": off["ms"], "on": on["ms"]},
                     launches={"off": off["launches"],
                               "on": on["launches"]},
                     expected_launches=bench_want,
                     launches_per_step={
                         k: off["launches"][k] / bench_train
                         for k in off["launches"]},
                     syncs={"off": off["syncs"], "on": on["syncs"]},
                     params_equal=same, opt_state_equal=same_opt,
                     off_repeat_equal=repeat_equal,
                     samples={"off": off["samples"], "on": on["samples"]},
                     sample_spans={"off": off["spans"], "on": on["spans"]},
                     gauges=gauges,
                     nll_per_token=off["wf"].decision.epoch_losses[1])
        del runs, off, on
    finally:
        root.common.telemetry.tensormon.enabled = False
        shutil.rmtree(tmp, ignore_errors=True)
    emit("train_text", card=card, anchor=anchor, bench_width=bench,
         phase_s=time.perf_counter() - t_phase)
    if not (anchor["best_err"] <= TEXT_MAX_ERR
            and anchor["best_err"] < tri - TEXT_MARGIN):
        raise AssertionError("the real-text anchor missed the reference's "
                             "thresholds: %s vs trigram %s"
                             % (anchor["best_err"], tri))
    for name, got, expect in (("anchor", anchor["launches"], want),
                              ("bench width off", bench["launches"]["off"],
                               bench_want),
                              ("bench width on", bench["launches"]["on"],
                               bench_want)):
        if got != expect or not all(got.values()):
            raise AssertionError("flash launches in the %s run: %s, the "
                                 "epochs imply %s" % (name, got, expect))
    if not (bench["params_equal"] and bench["opt_state_equal"]):
        raise AssertionError("tensormon changed the bench-width epoch's "
                             "parameters or optimiser state")
    if bench["syncs"]["off"] != bench["syncs"]["on"]:
        raise AssertionError("tensormon added synchronising calls: %s"
                             % bench["syncs"])
    if bench["samples"] != {"off": 0, "on": 1} or \
            bench["sample_spans"]["on"] != bench["samples"]["on"]:
        raise AssertionError("tensormon samples/spans: %s / %s"
                             % (bench["samples"], bench["sample_spans"]))
    need = ("veles_model_grad_norm", "veles_model_weight_norm_",
            "veles_model_update_ratio_")
    if not all(any(g.startswith(n) for g in gauges) for n in need):
        raise AssertionError("model-health gauges missing on /metrics: %s"
                             % gauges)
    return {k: anchor["launches"][k] + bench["launches"]["off"][k]
            + bench["launches"]["on"][k] for k in anchor["launches"]}


def flat_tree(tree):
    """The leaves of a nested dict of tensors, in sorted key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flat_tree(tree[k])]
    return [tree]


def blobs_workflow(poison, policy, snapshot_dir=None):
    """The reference's tests/test_tensormon.py load on the card: 120
    seeded blob rows, 40 validation, mb 40, a 10-8-2 tanh/softmax chain,
    3 epochs with tensormon on under ``policy``; ``poison`` fills the
    dataset with NaN before the first step."""
    import numpy
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.loader import FullBatchLoader
    from veles_tpu_torch.nn.standard_workflow import StandardWorkflow
    from veles_tpu_torch.snapshotter import Snapshotter

    def load_data(self):
        rng = numpy.random.RandomState(7)
        data = rng.randn(120, 10).astype(numpy.float32)
        self.create_originals(data, (data.sum(axis=1) > 0).astype(
            numpy.int32))
        self.class_lengths = [0, 40, 80]
    root.common.telemetry.tensormon.enabled = True
    root.common.telemetry.tensormon.nan_policy = policy
    prng.seed_all(1234)
    blobs = type("Blobs", (FullBatchLoader,), {"hide_from_registry": True,
                                               "load_data": load_data})
    snap = (Snapshotter(None, prefix="mon", directory=snapshot_dir,
                        interval=1) if snapshot_dir else None)
    wf = StandardWorkflow(
        name="mon-wf",
        layers=[{"type": "all2all_tanh", "output_sample_shape": 8},
                {"type": "softmax", "output_sample_shape": 2}],
        loader_unit=blobs(None, minibatch_size=40, name="mon-blobs"),
        loss_function="softmax",
        decision_config=dict(max_epochs=3, fail_iterations=100),
        snapshotter_unit=snap)
    wf.initialize()
    if poison:
        wf.loader.original_data.mem[:, :] = numpy.nan
    return wf


def library_sentinel(tmp):
    """(c) the three NaN policies on the poisoned blobs, the snapshot
    directory (where a halt's black box lands) under ``tmp``."""
    from veles_tpu_torch.config import root
    from veles_tpu_torch.resilience import health
    snap_dir = os.path.join(tmp, "sentinel")
    os.makedirs(snap_dir)
    prev = root.common.dirs.snapshots
    # the halting policies' black boxes land beside the snapshots
    root.common.dirs.snapshots = snap_dir
    try:
        return sentinel_policies(snap_dir)
    finally:
        root.common.dirs.snapshots = prev
        root.common.telemetry.tensormon.enabled = False
        root.common.telemetry.tensormon.nan_policy = "warn"
        health.forget("model_health")


def sentinel_policies(snap_dir):
    """warn, halt, then snapshot_and_halt, each on the poisoned blobs."""
    import glob
    from veles_tpu_torch.resilience import checkpoint_chain, health
    from veles_tpu_torch.telemetry import counters, tensormon
    from veles_tpu_torch.telemetry.recorder import flight, read_blackbox
    out = {}
    before = counters.snapshot()
    wf = blobs_workflow(True, "warn")
    wf.run()
    delta = counters.counters.delta(before)
    out["warn"] = dict(nan_total=delta.get("veles_model_nan_total", 0),
                       epochs=wf.decision.epoch_number)
    try:
        blobs_workflow(True, "halt").run()
        raised = False
    except tensormon.ModelHealthError:
        raised = True
    code, payload = health.readyz()
    out["halt"] = dict(raised=raised, readyz=code,
                       model_health=payload["components"].get(
                           "model_health"))
    health.forget("model_health")
    for path in glob.glob(os.path.join(snap_dir, "blackbox-*.jsonl")):
        os.remove(path)             # the halt policy's box
    flight.clear()
    try:
        blobs_workflow(True, "snapshot_and_halt", snap_dir).run()
        raised = False
    except tensormon.ModelHealthError:
        raised = True
    snaps = checkpoint_chain.chain(snap_dir, "mon")
    dumps = glob.glob(os.path.join(snap_dir, "blackbox-*.jsonl"))
    header, events = (read_blackbox(dumps[0]) if len(dumps) == 1
                      else ({}, []))
    out["snapshot_and_halt"] = dict(
        raised=raised, snapshots=len(snaps),
        verified=bool(snaps) and checkpoint_chain.verify(snaps[0]) is True,
        blackboxes=len(dumps), reason=header.get("reason"),
        nan_events=sum(1 for e in events
                       if e.get("kind") == "tensormon.nan"))
    return out


class _Reasons:
    """Collects the train step's fused-FC rejection reasons."""

    def __init__(self):
        import logging
        self.messages = []
        outer = self

        class Handler(logging.Handler):
            def emit(self, record):
                msg = record.getMessage()
                if "fused_fc_scan requested but ineligible" in msg:
                    outer.messages.append(msg)
        self.handler = Handler(logging.INFO)

    def __enter__(self):
        import logging
        logging.getLogger().addHandler(self.handler)
        self.level = logging.getLogger().level
        logging.getLogger().setLevel(logging.INFO)
        return self

    def __exit__(self, *exc):
        import logging
        logging.getLogger().removeHandler(self.handler)
        logging.getLogger().setLevel(self.level)


def mnist_library_workflow(device=None, epochs=2, per_dispatch=2,
                           loader=None, evaluator_config=None,
                           lora_rank=0, fused=True, seed=SEED,
                           snapshot_dir=None, layers=None):
    """models/mnist.py's BASELINE #1 graph with the library's knobs: a
    LoRA rank on both All2All layers, an evaluator config, another loader
    (the file loaders' replay of the same rows, named as MNIST's) or
    other layers; initialised on ``device`` (default the card)."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.models import mnist
    from veles_tpu_torch.nn.lr_adjust import exp_decay
    from veles_tpu_torch.nn.standard_workflow import StandardWorkflow
    from veles_tpu_torch.snapshotter import Snapshotter
    root.common.engine.fused_fc_scan = bool(fused)
    prng.seed_all(seed)
    extra = dict(lora_rank=lora_rank) if lora_rank else {}
    if layers is None:
        layers = [{"type": "all2all_tanh", "output_sample_shape": 100,
                   "learning_rate": 0.03, **extra},
                  {"type": "softmax", "output_sample_shape": 10,
                   "learning_rate": 0.03, **extra}]
    wf = StandardWorkflow(
        name="mnist-784", layers=layers,
        loader_unit=loader or mnist.MnistLoader(None, minibatch_size=100,
                                                name="mnist"),
        loss_function="softmax",
        decision_config=dict(max_epochs=epochs, fail_iterations=50),
        lr_schedule=exp_decay(0.98), epochs_per_dispatch=per_dispatch,
        evaluator_config=evaluator_config,
        snapshotter_unit=(Snapshotter(None, prefix="mnist",
                                      directory=snapshot_dir)
                          if snapshot_dir else None))
    wf.initialize(device=device)
    return wf


def fused_launches():
    from veles_tpu_torch.telemetry import counters
    return counters.get("veles_fused_fc_launches_total")


def tree_max_rel(got, want):
    """max |got - want| / max(1e-30, max |want|) over paired leaves."""
    return max(float((g.cpu() - w.cpu()).abs().max())
               / max(1e-30, float(w.abs().max()))
               for g, w in zip(flat_tree(got), flat_tree(want)))


def library_tensormon_mnist():
    """(d) MNIST's train load with tensormon on: the fused-FC kernel is
    refused with the reference's reason, the general path's epochs are
    finite."""
    import math as _math
    from veles_tpu_torch.config import root
    root.common.telemetry.tensormon.enabled = True
    try:
        with _Reasons() as reasons:
            wf = mnist_library_workflow()
        before = fused_launches()
        wf.run()
        launched = fused_launches() - before
    finally:
        root.common.telemetry.tensormon.enabled = False
    errs = wf.decision.epoch_metrics
    return dict(fused_launches=launched, reasons=reasons.messages,
                valid_err=errs[1], train_err=errs[2],
                finite=all(_math.isfinite(v) for s in (1, 2)
                           for v in errs[s]) and len(errs[1]) == 2)


def library_lora(tmp):
    """(e) the MNIST base 2 epochs through the fused-FC kernel and a
    snapshot; resumed into LoRA rank 8 on both All2All layers for 2 more
    epochs on the general path."""
    import torch
    from veles_tpu_torch.snapshotter import resume
    snap_dir = os.path.join(tmp, "lora")
    base = mnist_library_workflow(snapshot_dir=snap_dir)
    before = fused_launches()
    base.run()
    base_launches = fused_launches() - before
    path = base.snapshotter.destination
    base_params = {n: {k: t.clone() for k, t in p.items()}
                   for n, p in base.train_step.params.items()}
    x = base.loader.original_data.device_view(base.train_step.device)[:256]
    base_out = base.train_step._forward(base.train_step.params, x)
    out = {"base_fused_launches": base_launches}
    runs = {}
    for dev in ("cuda", "cpu"):
        with _Reasons() as reasons:
            wf = mnist_library_workflow(device=dev, epochs=4,
                                        lora_rank=LORA_RANK)
        resume(wf, path)
        wf.decision.complete <<= False
        runs[dev] = (wf, reasons.messages)
    wf = runs["cuda"][0]
    out["reasons"] = runs["cuda"][1]
    out["step0_output_equal"] = bool(torch.equal(
        wf.train_step._forward(wf.train_step.params, x), base_out))
    # the first two steps from the resumed state, card against CPU
    card_steps = list(train_steps(wf, 2))
    cpu_steps = list(train_steps(runs["cpu"][0], 2))
    out["first_steps_loss"] = [float(c[0]) for c in card_steps]
    out["first_steps_loss_cpu"] = [float(c[0]) for c in cpu_steps]
    out["first_steps_rel"] = max(
        max(abs(float(c[0]) - float(h[0])) / abs(float(h[0])),
            tree_max_rel(c[1], h[1]))
        for c, h in zip(card_steps, cpu_steps))
    del runs
    before = fused_launches()
    wf.run()
    out["lora_fused_launches"] = fused_launches() - before
    params = wf.train_step.params
    out["base_equal"] = all(
        torch.equal(params[n][k], base_params[n][k])
        for n in base_params for k in ("weights", "bias"))
    out["adapters_moved"] = all(
        float(params[n]["weights_lora_b"].abs().max()) > 0
        for n in base_params)
    out["epochs"] = wf.decision.epoch_number
    out["valid_err"] = wf.decision.epoch_metrics[1]
    return out


def library_smoothing():
    """(f) label smoothing 0.1 with the confusion matrix on MNIST's
    general path: the first two SGD steps card vs CPU, then 2 epochs on
    the card, each set's matrix against n_samples and n_err."""
    cfg = dict(label_smoothing=0.1, compute_confusion=True)
    card = mnist_library_workflow(evaluator_config=cfg)
    cpu = mnist_library_workflow(device="cpu", evaluator_config=cfg)
    c_losses, c_deltas = first_train_steps(card, 2)
    h_losses, h_deltas = first_train_steps(cpu, 2)
    rel = max(abs(a - b) / abs(b) for a, b in zip(c_losses, h_losses))
    del cpu
    card.run()
    dec = card.decision
    exact = {}
    for s in (1, 2):
        exact[s] = [
            dict(sum=float(cm.sum()), n_samples=n,
                 off_diagonal=float(cm.sum() - cm.trace()), n_err=e)
            for cm, (n, e) in zip(dec.epoch_confusion[s],
                                  dec.epoch_counts[s])]
    return dict(first_steps_loss=c_losses, first_steps_loss_cpu=h_losses,
                first_steps_rel=rel,
                first_steps_delta_rel=max(
                    tree_max_rel(c, h) for c, h in zip(c_deltas,
                                                       h_deltas)),
                confusion=exact, valid_err=dec.epoch_metrics[1])


def library_epilogue():
    """(g) ``engine.fused_epilogue`` on against off on a chain with
    standalone activation layers: weights and metrics bit for bit."""
    import torch
    from veles_tpu_torch.config import root
    layers = [{"type": "all2all", "output_sample_shape": 100,
               "learning_rate": 0.03},
              {"type": "activation_mul", "factor": 0.6666},
              {"type": "activation_tanh"},
              {"type": "activation_mul", "factor": 1.7159},
              {"type": "softmax", "output_sample_shape": 10,
               "learning_rate": 0.03}]
    runs = {}
    for on in (False, True):
        root.common.engine.fused_epilogue = on
        try:
            wf = mnist_library_workflow(layers=layers, fused=False,
                                        per_dispatch=1)
            plan = [(p.name, [t.name for t in ts])
                    for p, ts in wf.train_step._epilogue or ()]
            wf.run()
        finally:
            root.common.engine.fused_epilogue = False
        runs[on] = (wf, plan)
    off, on = runs[False][0], runs[True][0]
    return dict(plan=runs[True][1],
                params_equal=all(torch.equal(a, b) for a, b in zip(
                    flat_tree(off.train_step.params),
                    flat_tree(on.train_step.params))),
                metrics_equal=(off.decision.epoch_metrics
                               == on.decision.epoch_metrics),
                valid_err=on.decision.epoch_metrics[1])


def library_files(tmp):
    """(h) MNIST's rows written through MinibatchesSaver (served in
    order, no shuffle), replayed through MinibatchesLoader and through
    PicklesLoader; each trained 2 epochs through the fused-FC kernel
    against the in-memory run from the same seed."""
    import pickle
    import numpy
    import torch
    from veles_tpu_torch import prng
    from veles_tpu_torch.loader import (MinibatchesLoader, MinibatchesSaver,
                                        PicklesLoader)
    from veles_tpu_torch.models import mnist
    prng.seed_all(SEED)
    src = mnist.MnistLoader(None, minibatch_size=100, shuffle_limit=-1,
                            name="mnist-src")
    src.initialize()
    mb_file = os.path.join(tmp, "mnist.vtmb")
    saver = MinibatchesSaver(None, file_name=mb_file)
    saver.loader = src
    saver.initialize()
    t0 = time.perf_counter()
    while True:
        src.run()
        saver.run()
        if bool(src.epoch_ended):
            break
    saver.stop()
    save_s = time.perf_counter() - t0
    files = [None]
    ends = src.class_end_offsets
    for cls in (1, 2):
        rows = slice(ends[cls - 1], ends[cls])
        path = os.path.join(tmp, "mnist_%d.pickle" % cls)
        with open(path, "wb") as fout:
            pickle.dump((numpy.array(src.original_data.mem[rows]),
                         numpy.array(src.original_labels.mem[rows])), fout,
                        protocol=pickle.HIGHEST_PROTOCOL)
        files.append(path)
    ref = mnist_library_workflow()
    before = fused_launches()
    ref.run()
    out = {"in_memory": fused_launches() - before, "save_s": save_s,
           "file_bytes": os.path.getsize(mb_file)}
    for name, ld in (("minibatches", MinibatchesLoader(
            None, file_name=mb_file, minibatch_size=100, name="mnist")),
                     ("pickles", PicklesLoader(
                         None, files=files, minibatch_size=100,
                         name="mnist"))):
        wf = mnist_library_workflow(loader=ld)
        before = fused_launches()
        wf.run()
        out[name] = dict(
            launches=fused_launches() - before,
            class_lengths=ld.class_lengths,
            weights_equal=all(torch.equal(a, b) for a, b in zip(
                flat_tree(wf.train_step.params),
                flat_tree(ref.train_step.params))),
            valid_err=wf.decision.epoch_metrics[1])
    return out


def phase_train_library(card):
    """(c) the NaN sentinel's three policies; (d) MNIST with tensormon on
    (the fused-FC kernel refused with the reference's reason); (e) LoRA
    resumed from a fused-FC MNIST base; (f) label smoothing with the
    confusion matrix; (g) the fused epilogue on against off; (h) MNIST
    from the minibatch and pickle files. Returns the fused-FC launches
    on this phase's path."""
    import shutil
    import tempfile
    from veles_tpu_torch import datasets
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="veles_library_")
    undo = cached_loads(datasets, "load_mnist")
    try:
        sentinel = library_sentinel(tmp)
        mon = library_tensormon_mnist()
        lora = library_lora(tmp)
        smoothing = library_smoothing()
        epilogue = library_epilogue()
        from_files = library_files(tmp)
    finally:
        undo()
        shutil.rmtree(tmp, ignore_errors=True)
    emit("train_library", card=card, sentinel=sentinel,
         tensormon_mnist=mon, lora=lora, smoothing_confusion=smoothing,
         epilogue=epilogue, from_files=from_files,
         phase_s=time.perf_counter() - t_phase)
    fails = []
    if not (sentinel["warn"]["nan_total"] > 0
            and sentinel["warn"]["epochs"] == 3):
        fails.append("warn policy %s" % sentinel["warn"])
    if sentinel["halt"] != dict(raised=True, readyz=503,
                                model_health=False):
        fails.append("halt policy %s" % sentinel["halt"])
    sh = sentinel["snapshot_and_halt"]
    if not (sh["raised"] and sh["snapshots"] == 1 and sh["verified"]
            and sh["blackboxes"] == 1
            and str(sh["reason"]).startswith("nan sentinel")
            and sh["nan_events"] >= 1):
        fails.append("snapshot_and_halt %s" % sh)
    if mon["fused_launches"] or not mon["finite"] or not any(
            "tensormon taps are not computed by the fused kernel" in r
            for r in mon["reasons"]):
        fails.append("MNIST with tensormon %s" % mon)
    if not (lora["base_fused_launches"] == 2
            and lora["lora_fused_launches"] == 0
            and lora["step0_output_equal"] and lora["base_equal"]
            and lora["adapters_moved"]
            and lora["first_steps_rel"] <= TOL_LIBRARY_STEP_REL
            and any("LoRA" in r for r in lora["reasons"])):
        fails.append("LoRA %s" % lora)
    if not smoothing["first_steps_rel"] <= TOL_LIBRARY_STEP_REL or any(
            e["sum"] != e["n_samples"] or e["off_diagonal"] != e["n_err"]
            for s in smoothing["confusion"].values() for e in s) or \
            len(smoothing["confusion"][1]) != 2:
        fails.append("smoothing/confusion %s" % smoothing)
    if not (epilogue["params_equal"] and epilogue["metrics_equal"]
            and epilogue["plan"]):
        fails.append("epilogue %s" % epilogue)
    for name in ("minibatches", "pickles"):
        rec = from_files[name]
        if not (rec["launches"] == 2 and rec["weights_equal"]):
            fails.append("%s %s" % (name, rec))
    if from_files["in_memory"] != 2:
        fails.append("in-memory MNIST launches %s" % from_files["in_memory"])
    if fails:
        raise AssertionError("train_library: " + "; ".join(fails))
    return (lora["base_fused_launches"] + from_files["in_memory"]
            + from_files["minibatches"]["launches"]
            + from_files["pickles"]["launches"])


#: phase lm_family (34): tiny_transformer's CI anchor (tests/test_models_
#: ci.py:120-131), the MHA unit and the MoE layer at the bench LM's
#: width, RProp and resize, the lane's state cache, AMP recurrent units
TT_SEED = 1234
TT_MAX_ERR = 0.35
TT_PROFILED_STEPS = 4
TOL_TT_STEP_REL = 1e-4
#: card against the port on the CPU, forward and gradients
TOL_LM_FAMILY = 1e-4
LM_FAMILY_CASES = [(kv, causal) for kv in (8, 2) for causal in (False, True)]
#: the bench LM's width: (B, T, d), its heads; MoE's experts and FFN
LM_FAMILY_SHAPE = (16, 512, 512)
LM_FAMILY_HEADS = 8
MOE_EXPERTS, MOE_HIDDEN = 4, 2048
MOE_SEED = 9
STATE_CACHE_PROMPT = 512
STATE_CACHE_N_NEW = 16
#: AMP: a bf16-derived value within 2^-7 of max(1, max|cpu|) (PERF.md §2)
TOL_AMP_OUT = 2.0 ** -7
AMP_GENRE_EPOCHS = 3


def lm_family_loader(kind):
    """The reference's toy loaders of its MoE and RProp workflows:
    "toy" (tests/test_pipeline_moe.py:97-107), "blobs3" (:191-201),
    "xorish" (tests/test_variants.py:43-52)."""
    import numpy
    from veles_tpu_torch.loader import FullBatchLoader

    class Toy(FullBatchLoader):
        hide_from_registry = True

        def load_data(self):
            if kind == "blobs3":
                rng = numpy.random.RandomState(5)
                centers = rng.randn(3, 8) * 3
                y = rng.randint(0, 3, 240).astype(numpy.int32)
                x = (centers[y] + rng.randn(240, 8)).astype(numpy.float32)
                self.create_originals(x, y)
                self.class_lengths = [0, 48, 192]
                return
            rng = numpy.random.RandomState(0)
            x = rng.rand(256, 8).astype(numpy.float32)
            col = 4 if kind == "toy" else 1
            y = (x[:, 0] > x[:, col]).astype(numpy.int32)
            self.create_originals(x, y)
            self.class_lengths = [0, 64, 192]
    return Toy(None, minibatch_size=24 if kind == "blobs3" else 32,
               name=kind)


def lm_family_workflow(kind, layers, epochs, **decision):
    from veles_tpu_torch import prng
    from veles_tpu_torch.nn.standard_workflow import StandardWorkflow
    prng.seed_all(SEED)
    wf = StandardWorkflow(name=kind, layers=layers,
                          loader_unit=lm_family_loader(kind),
                          loss_function="softmax",
                          decision_config=dict(max_epochs=epochs,
                                               **decision))
    wf.initialize()
    return wf


def lm_family_tiny_transformer():
    """(a) the reference's CI anchor through the flash kernels at H 4 D 8
    non-causal: the first two adam steps against the CPU, 15 epochs,
    launches as the steps imply, a profiled window of train steps."""
    import torch
    from veles_tpu_torch import prng
    from veles_tpu_torch.models import tiny_transformer as tt
    kw = dict(epochs=15, minibatch_size=64, n_blocks=2, n_train=2048,
              n_valid=512)

    def build(device):
        prng.seed_all(TT_SEED)
        wf = tt.build_workflow(**kw)
        wf.initialize(device=device)
        return wf
    host = adam_first_steps(build("cpu"))
    wf = build(None)
    mine = adam_first_steps(wf, starts=[h[2] for h in host])
    loss_rel = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(mine, host))
    rel = {}
    for (_, got, _), (_, want, _) in zip(mine, host):
        for key, w in want.items():
            d = float((got[key] - w).abs().max()) / max(
                float(w.abs().max()), 1e-30)
            rel[key[1]] = max(rel.get(key[1], 0.0), d)
    stamps = stamp_epochs(wf)
    torch.cuda.synchronize()
    before = flash_counts()
    t0 = time.perf_counter()
    wf.run()
    epoch_s = [b - a for a, b in zip([t0] + stamps, stamps)]
    launches = {k: v - before[k] for k, v in flash_counts().items()}
    train_steps_n, eval_steps_n = text_steps(wf)
    blocks = kw["n_blocks"]
    want = {"fwd": blocks * (train_steps_n + eval_steps_n),
            "dkv": blocks * train_steps_n, "dq": blocks * train_steps_n}

    def window():
        for _ in train_steps(wf, TT_PROFILED_STEPS):
            pass
    prof = profiled(window, match=("flash",))
    res = wf.gather_results()
    lengths = wf.loader.class_lengths
    return dict(
        heads=4, head_dim=8, causal=False, blocks=blocks,
        rows={"train": lengths[2], "validation": lengths[1]},
        step_loss_rel_diff=loss_rel, step_m_rel_diff=rel["m"],
        step_v_rel_diff=rel["v"], step_update_rel_diff=rel["update"],
        best_err=res["best_err"], best_epoch=res["best_epoch"],
        valid_err=wf.decision.epoch_metrics[1],
        epochs=wf.decision.epoch_number,
        epoch_ms=[t * 1e3 for t in epoch_s],
        epoch_ms_median=sorted(epoch_s)[len(epoch_s) // 2] * 1e3,
        train_samples_per_s=lengths[2] / sorted(epoch_s)[
            len(epoch_s) // 2],
        launches=launches, expected_launches=want,
        train_steps=train_steps_n, eval_steps=eval_steps_n,
        launches_per_train_step=(None if prof["kernel_launches"] is None
                                 else prof["kernel_launches"]
                                 / TT_PROFILED_STEPS),
        profiled=prof)


def card_vs_cpu(unit, x, seed):
    """The unit's forward and the gradients of sum(y · E) on the card and
    on the CPU from the same host parameters: per output, max |card -
    cpu| / max(1, max |cpu|); the card's flash launches."""
    import torch
    host = {k: torch.from_numpy(numpy_copy(v.map_read()))
            for k, v in unit.param_arrays().items()}
    e = torch.from_numpy(numpy_rand(seed, x.shape))
    out = {}
    before = flash_counts()
    for dev in ("cuda", "cpu"):
        p = {k: v.to(dev).requires_grad_(True) for k, v in host.items()}
        xx = torch.from_numpy(x).to(dev).requires_grad_(True)
        y = unit.apply(p, xx)
        (y * e.to(dev)).sum().backward()
        out[dev] = dict({"y": y.detach().cpu(), "dx": xx.grad.cpu()},
                        **{"d" + k: t.grad.cpu() for k, t in p.items()})
        if dev == "cuda":
            torch.cuda.synchronize()
            launched = {k: v - before[k] for k, v in flash_counts().items()}
    errs = {k: float((out["cuda"][k] - w).abs().max())
            / max(1.0, float(w.abs().max())) for k, w in out["cpu"].items()}
    return errs, launched


def numpy_copy(a):
    import numpy
    return numpy.array(a, dtype=numpy.float32)


def numpy_rand(seed, shape):
    import numpy
    return numpy.random.RandomState(seed).randn(*shape).astype("float32")


def lm_family_mha():
    """(b) the MHA unit at the bench LM's width: B16 T512 d512, 8 heads
    over 8 or 2 kv heads, causal and not, card against CPU."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.memory import Array
    from veles_tpu_torch.nn.attention import MultiHeadAttention
    x = numpy_rand(71, LM_FAMILY_SHAPE)
    out = []
    for i, (kv, causal) in enumerate(LM_FAMILY_CASES):
        prng.seed_all(SEED + i)
        u = MultiHeadAttention(None, n_heads=LM_FAMILY_HEADS,
                               n_kv_heads=kv, causal=causal, name="mha")
        u.input = Array(x)
        u.initialize(device="cuda")
        errs, launched = card_vs_cpu(u, x, 72 + i)
        out.append(dict(n_kv_heads=kv, causal=causal, errors=errs,
                        max_err=max(errs.values()), launches=launched))
    return out


def route_margins(gates, m_card, m_cpu, k):
    """Per token whose routing masks differ: the gap between its k-th and
    (k+1)-th largest gate (on the CPU)."""
    import torch
    rows = torch.nonzero((m_card != m_cpu).any(dim=-1)).flatten()
    s = torch.sort(gates[rows], dim=-1, descending=True).values
    return [dict(token=int(r), margin=float(s[j, k - 1] - s[j, k]))
            for j, r in enumerate(rows.tolist())]


def lm_family_moe():
    """(c) MoE at d 512, E 4, F 2,048 over 16 × 512 tokens, dense and
    top-2 (capacity factor 1.25), card against CPU: forward, gradients
    and the routing masks."""
    import torch
    from veles_tpu_torch import prng
    from veles_tpu_torch.memory import Array
    from veles_tpu_torch.nn.moe import MoEFFN
    x = numpy_rand(MOE_SEED, LM_FAMILY_SHAPE)
    d = LM_FAMILY_SHAPE[-1]
    out = []
    for top_k in (0, 2):
        prng.seed_all(SEED + 10 + top_k)
        u = MoEFFN(None, n_experts=MOE_EXPERTS, hidden=MOE_HIDDEN,
                   top_k=top_k, capacity_factor=1.25, name="moe")
        u.input = Array(x)
        u.initialize(device="cuda")
        errs, _ = card_vs_cpu(u, x, 90 + top_k)
        rec = dict(top_k=top_k, errors=errs, max_err=max(errs.values()))
        if top_k:
            host = {k: torch.from_numpy(numpy_copy(v.map_read()))
                    for k, v in u.param_arrays().items()}
            flat = torch.from_numpy(x.reshape(-1, d))
            with torch.no_grad():
                gates, m_cpu = u.route(host, flat)
                _, m_card = u.route({k: v.cuda() for k, v in host.items()},
                                    flat.cuda())
            m_card = m_card.cpu()
            rec.update(capacity=u.capacity(flat.shape[0]),
                       routing_equal=bool(torch.equal(m_card, m_cpu)),
                       expert_load=[int(v) for v in m_cpu.sum(0)],
                       margins=route_margins(gates, m_card, m_cpu, top_k))
        out.append(rec)
    return out


def lm_family_trained():
    """(c, d) the reference's MoE and RProp workflows on one card, and
    ``resize`` of a trained resizable layer."""
    import numpy
    runs = {}
    for name, kind, layers, epochs, decision in (
            ("moe_dense", "toy",
             [{"type": "moe_ffn", "n_experts": 4, "hidden": 16,
               "learning_rate": 0.1},
              {"type": "softmax", "output_sample_shape": 2,
               "learning_rate": 0.1}], 12, {}),
            ("moe_top2", "blobs3",
             [{"type": "moe_ffn", "n_experts": 4, "hidden": 16, "top_k": 2,
               "learning_rate": 0.05},
              {"type": "softmax", "output_sample_shape": 3}], 8,
             {"fail_iterations": 100}),
            ("rprop", "xorish",
             [{"type": "rprop_all2all", "output_sample_shape": 16},
              {"type": "softmax", "output_sample_shape": 2}], 15, {})):
        t0 = time.perf_counter()
        wf = lm_family_workflow(kind, layers, epochs, **decision)
        wf.run()
        runs[name] = dict(best_err=wf.decision.best_metric,
                          valid_err=wf.decision.epoch_metrics[1],
                          gds=sorted({type(g).__name__
                                      for g in wf.train_step.gds}),
                          run_ms=(time.perf_counter() - t0) * 1e3)
    wf = lm_family_workflow("xorish", [
        {"type": "resizable_all2all", "output_sample_shape": 16},
        {"type": "softmax", "output_sample_shape": 2}], 3)
    wf.run()
    wf.train_step.sync_params_to_arrays()
    unit = wf.forwards[0]
    w0 = numpy.array(unit.weights.map_read())
    b0 = numpy.array(unit.bias.map_read())
    kept = []
    import torch
    x = torch.from_numpy(wf.loader.original_data.mem[:32]).cuda()
    for n in (24, 8):
        unit.resize(n)
        keep = min(16, n)
        params = {k: v.device_view("cuda")
                  for k, v in unit.param_arrays().items()}
        y = unit.apply(params, x)
        kept.append(dict(
            neurons=n,
            weights_equal=bool(numpy.array_equal(
                numpy.asarray(unit.weights.map_read())[:, :keep],
                w0[:, :keep])),
            bias_equal=bool(numpy.array_equal(
                numpy.asarray(unit.bias.map_read())[:keep], b0[:keep])),
            output_shape=list(y.shape), finite=bool(torch.isfinite(y).all())))
    runs["resize"] = kept
    return runs


def lm_family_state_cache():
    """(e) the state cache on serve_recurrent's LSTM char LM (512 × 6,
    chunks of 16): a 512-token prompt cold then warm, greedy and sampled,
    against ``generate_recurrent``; the three fault points."""
    import os
    import warnings
    import numpy
    import torch
    from veles_tpu_torch.serving import (RecurrentEngine,
                                         generate_recurrent, make_request)
    from veles_tpu_torch.telemetry import counters
    model = recurrent_lm("lstm")
    vocab = model.layers["embedding0"].vocab_size
    prompt = [int(t) for t in numpy.random.RandomState(12).randint(
        0, vocab, STATE_CACHE_PROMPT)]
    n = STATE_CACHE_N_NEW
    sample = dict(temperature=0.8, seed=7, mode="sample")
    solo = generate_recurrent(model, prompt, n)
    solo_s = generate_recurrent(model, prompt, n, **sample)
    chunk = RECURRENT_ENGINE["page_size"]

    def engine():
        return RecurrentEngine(model, state_cache=True, name="sc",
                               **RECURRENT_ENGINE).start()

    def serve(eng, **kw):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                tokens = eng.serve([make_request(prompt, n, **kw)])[0]
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = sum(1 for w in caught if "synchroniz" in str(w.message))
        return dict(tokens=tokens, ttft_ms=eng.ttft_ms[-1], syncs=syncs,
                    snapshot_copies=eng.last_snapshot_copies)

    c0 = {k: counters.get(k) for k in (
        "veles_o1_state_restores_total",
        "veles_o1_state_restored_tokens_total",
        "veles_o1_state_rescans_total")}
    eng = engine()
    try:
        cold = serve(eng)
        warm = serve(eng)
        warm_s = serve(eng, **sample)
        st = eng.stats()
        faults = {}
        for name, spec in (("restore_raise",
                            "serve.state_restore:raise:times=1"),
                           ("restore_corrupt",
                            "serve.state_restore:corrupt:times=1")):
            os.environ["VELES_FAULTS"] = spec
            try:
                faults[name] = serve(eng)["tokens"] == solo
            finally:
                del os.environ["VELES_FAULTS"]
        st_after = eng.stats()
    finally:
        eng.stop()
    moved = {k: counters.get(k) - v for k, v in c0.items()}
    eng = engine()
    try:
        os.environ["VELES_FAULTS"] = "serve.state_checkpoint:raise:times=1"
        try:
            faults["checkpoint_raise"] = serve(eng)["tokens"] == solo
        finally:
            del os.environ["VELES_FAULTS"]
        faults["checkpoint_raise_blocks"] = eng.stats()["state_cache_blocks"]
    finally:
        eng.stop()
    matched_blocks = (STATE_CACHE_PROMPT - 1) // chunk
    return dict(
        prompt=STATE_CACHE_PROMPT, n_new=n, chunk=chunk,
        cold_equal=cold["tokens"] == solo, warm_equal=warm["tokens"] == solo,
        warm_sampled_equal=warm_s["tokens"] == solo_s,
        ttft_ms={"cold": cold["ttft_ms"], "warm": warm["ttft_ms"],
                 "warm_sampled": warm_s["ttft_ms"]},
        # every synchronising call of a request: the chunks' uploads, the
        # snapshot copies, the first token's read, one copy a decode tick
        syncs_per_request={"cold": cold["syncs"], "warm": warm["syncs"]},
        # of which the state tensors copied to the host in the prefill
        snapshot_copies_per_prefill={"cold": cold["snapshot_copies"],
                                     "warm": warm["snapshot_copies"]},
        blocks=st["state_cache_blocks"],
        snapshot_bytes_per_block=st["state_cache_bytes"]
        / max(1, st["state_cache_blocks"]),
        restores=st["state_restores"], matched_blocks=matched_blocks,
        counters=moved, rescans=st_after["state_rescans"], faults=faults)


def lm_family_amp_genre():
    """(f) BASELINE #5 under ``engine.mixed_precision``: the first two
    SGD steps against the CPU, then AMP_GENRE_EPOCHS epochs."""
    from veles_tpu_torch.config import root
    root.common.engine.mixed_precision = True
    try:
        host = genre_workflow("cpu")
        cpu_loss, cpu_d = first_train_steps(host)
        del host
        wf = genre_workflow()
        card_loss, card_d = first_train_steps(wf)
        wf.decision.max_epochs = AMP_GENRE_EPOCHS
        stamps = stamp_epochs(wf)
        t0 = time.perf_counter()
        wf.run()
        epoch_s = [b - a for a, b in zip([t0] + stamps, stamps)]
        dtypes = sorted({str(t.dtype) for p in wf.train_step.params.values()
                         for t in p.values()})
    finally:
        root.common.engine.mixed_precision = False
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card_loss, cpu_loss))
    delta = max(float((c[u][k] - h[u][k]).abs().max())
                / max(1.0, float(h[u][k].abs().max()))
                for c, h in zip(card_d, cpu_d) for u in h for k in h[u])
    return dict(step_loss_card=card_loss, step_loss_cpu=cpu_loss,
                step_loss_rel_diff=loss_rel, step_delta_err=delta,
                valid_err=wf.decision.epoch_metrics[1],
                epochs=wf.decision.epoch_number,
                epoch_ms=[t * 1e3 for t in epoch_s], master_dtypes=dtypes)


def phase_lm_family(card):
    """Phase 34: the rest of the LM family on the card — (a) the
    tiny_transformer anchor through the flash kernels at H 4 D 8 non-
    causal, (b) the MHA unit and (c) the MoE layer at the bench LM's
    width against the CPU, the reference's MoE and RProp workflows and
    ``resize`` (c, d), (e) the O(1)-state lane's state cache and (f) the
    recurrent units under AMP. Every part fails the run on a miss.
    Returns the flash launches by kernel in (a) and (b)."""
    t_phase = time.perf_counter()
    times = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        times[name] = time.perf_counter() - t0
        return out
    tt = timed("tiny_transformer", lm_family_tiny_transformer)
    mha = timed("mha", lm_family_mha)
    moe = timed("moe", lm_family_moe)
    trained = timed("trained", lm_family_trained)
    cache = timed("state_cache", lm_family_state_cache)
    amp = timed("amp_genre", lm_family_amp_genre)
    emit("lm_family", card=card, tiny_transformer=tt, mha=mha, moe=moe,
         trained=trained, state_cache=cache, amp_genre=amp,
         part_s=times, phase_s=time.perf_counter() - t_phase)
    bad = []
    if not tt["best_err"] < TT_MAX_ERR:
        bad.append("tiny_transformer best_err %s" % tt["best_err"])
    if tt["launches"] != tt["expected_launches"] or not all(
            tt["launches"].values()):
        bad.append("tiny_transformer flash launches %s, the steps imply %s"
                   % (tt["launches"], tt["expected_launches"]))
    if not max(tt["step_loss_rel_diff"], tt["step_m_rel_diff"],
               tt["step_v_rel_diff"]) <= TOL_TT_STEP_REL:
        bad.append("tiny_transformer's first adam steps vs the CPU: %s"
                   % {k: tt[k] for k in ("step_loss_rel_diff",
                                         "step_m_rel_diff",
                                         "step_v_rel_diff")})
    for rec in mha:
        if rec["max_err"] > TOL_LM_FAMILY or \
                rec["launches"] != {"fwd": 1, "dkv": 1, "dq": 1}:
            bad.append("mha %s" % rec)
    for rec in moe:
        if rec["max_err"] > TOL_LM_FAMILY or (
                rec["top_k"] and not rec["routing_equal"]):
            bad.append("moe %s" % rec)
    for name, limit in (("moe_dense", 0.4), ("moe_top2", 0.15),
                        ("rprop", 0.35)):
        if not trained[name]["best_err"] < limit:
            bad.append("%s best_err %s" % (name, trained[name]))
    if not all(r["weights_equal"] and r["bias_equal"] and r["finite"]
               for r in trained["resize"]):
        bad.append("resize %s" % trained["resize"])
    per_restore = cache["matched_blocks"] * cache["chunk"]
    if not (cache["cold_equal"] and cache["warm_equal"]
            and cache["warm_sampled_equal"] and cache["restores"] >= 1
            and cache["counters"]["veles_o1_state_restored_tokens_total"]
            == per_restore * cache["counters"][
                "veles_o1_state_restores_total"]
            and cache["counters"]["veles_o1_state_rescans_total"] == 1
            and cache["faults"]["restore_raise"]
            and cache["faults"]["restore_corrupt"]
            and cache["faults"]["checkpoint_raise"]
            and cache["faults"]["checkpoint_raise_blocks"] == 0):
        bad.append("state cache %s" % cache)
    valid = amp["valid_err"]
    if not (amp["step_loss_rel_diff"] <= TOL_AMP_OUT
            and amp["step_delta_err"] <= TOL_AMP_OUT
            and amp["epochs"] == AMP_GENRE_EPOCHS
            and all(math.isfinite(v) for v in valid) and valid[-1] < valid[0]
            and amp["master_dtypes"] == ["torch.float32"]):
        bad.append("AMP genre %s" % amp)
    if bad:
        raise AssertionError("lm_family: " + "; ".join(bad))
    return {k: tt["launches"][k] + sum(r["launches"][k] for r in mha)
            for k in tt["launches"]}


#: phase 35 rest_serving: BASELINE #1 served through RESTfulAPI with
#: dynamic batching, and BASELINE #4 trained from an image tree
REST_MB = 8
REST_REQUESTS = 256
REST_CLIENTS = 32
#: an answered row against the forward of that row alone on the card
#: (cuBLAS sums a product row in another order at 1–8 rows)
TOL_REST = 1e-5
IMG_FILES_PER_CLASS = 500
IMG_VALID_RATIO = 0.1
IMG_CROP = (28, 28)
IMG_MB = 100
IMG_REST_MB = 16
IMG_REQUESTS = 64
IMG_CLIENTS = 16
#: the mirrored share of a device-augmented draw: 0.5 ± this
TOL_MIRROR_SHARE = 0.1
MIRROR_SHARE_ROWS = 4000


def http_status(url, payload=None, timeout=30.0):
    """(status, headers, body text) of a GET (``payload`` None) or a
    JSON POST, error statuses included."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode(errors="replace")


def rest_workflow(layers, tree, loader_cls, device=None, **loader_kw):
    """``docs/examples.md`` §5's serving workflow on the port, as a user
    wires it: Repeater → ``loader_cls`` (of ``loader/stream.py``) → the
    forward units of the ``layers`` config → ``RESTfulAPI``, initialised
    on ``device`` (default: the card), the forwards given the trained
    parameter tree ``tree`` through ``convert.params_from_jax``. Returns
    (workflow, loader, forwards, api)."""
    from veles_tpu_torch import RESTfulAPI
    from veles_tpu_torch.convert import params_from_jax
    from veles_tpu_torch.loader import stream
    from veles_tpu_torch.nn.standard_workflow import _unit_class
    from veles_tpu_torch.plumbing import Repeater
    from veles_tpu_torch.workflow import Workflow
    wf = Workflow(name="serve")
    rep = Repeater(wf)
    loader = getattr(stream, loader_cls)(wf, name="rest_loader",
                                         **loader_kw)
    rep.link_from(wf.start_point)
    loader.link_from(rep)
    prev, attr, fwds = loader, "minibatch_data", []
    for i, cfg in enumerate(layers):
        cfg = dict(cfg)
        kind = cfg.pop("type")
        unit = _unit_class(kind)(wf, name=cfg.pop("name", "%s%d" % (kind, i)),
                                 **cfg)
        unit.link_from(prev)
        unit.link_attrs(prev, ("input", attr))
        prev, attr = unit, "output"
        fwds.append(unit)
    api = RESTfulAPI(wf, loader=loader, port=0)
    api.link_from(prev)
    api.link_attrs(prev, ("input", "output"))
    rep.link_from(api)
    wf.initialize(device=device)
    params_from_jax(wf, tree)
    return wf, loader, fwds, api


def trained_tree(wf):
    """A trained workflow's parameters as numpy, in the reference's
    layout."""
    return {n: {k: v.detach().cpu().numpy() for k, v in p.items()}
            for n, p in wf.train_step.params.items()}


def forward_alone(wf, rows):
    """The trained workflow's forward units over each row alone on the
    card (evaluation mode; the softmax head's probabilities, as the
    served forward's)."""
    import numpy
    import torch
    step = wf.train_step
    out = []
    with torch.no_grad():
        for row in rows:
            x = torch.from_numpy(numpy_copy(row)[None]).to(step.device)
            for f in wf.forwards:
                x = f.apply(step.params.get(f.name, {}), x)
            out.append(x[0].cpu().numpy())
    return numpy.stack(out)


def record_dispatches(loader):
    """Wrap the stream loader's run: the list it returns fills with the
    rows of each dispatch that served requests."""
    sizes = []
    run = loader.run

    def recording():
        run()
        if loader.current_tickets:
            sizes.append(loader.minibatch_size)
    loader.run = recording
    return sizes


def rest_load(url, payloads, clients):
    """POST every payload over HTTP from ``clients`` threads (client c
    posts payloads c, c + clients, ...): (answers as (code, body, ms),
    wall s)."""
    answers = [None] * len(payloads)

    def client(c):
        for i in range(c, len(payloads), clients):
            answers[i] = post(url, payloads[i], timeout=120.0)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    return answers, time.perf_counter() - t0


def rest_load_apart(url, payloads, clients):
    """:func:`rest_load` in a process of its own (spawned; it imports
    this file and no torch), so the clients' JSON encoding and sockets
    do not share the server's interpreter lock, as a real client's do
    not. The process ends with the call."""
    import multiprocessing
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        return pool.apply(rest_load, (url, payloads, clients))


def served_vs_alone(answers, alone, what):
    """Each 200 answer's row against the forward alone: the largest
    error, and the rows whose argmax differs with both top values and
    their margin (allowed only on a near-tie: the margin within
    TOL_REST)."""
    import numpy
    bad = [i for i, a in enumerate(answers) if a is None or a[0] != 200]
    if bad:
        raise AssertionError("%s: %d answers not 200, e.g. %s"
                             % (what, len(bad), answers[bad[0]]))
    served = numpy.asarray([a[1]["result"] for a in answers],
                           dtype=numpy.float64)
    err = float(numpy.abs(served - alone).max())
    flips = []
    for i in numpy.flatnonzero(served.argmax(1) != alone.argmax(1)):
        top = numpy.sort(alone[i])[-2:]
        flips.append({"row": int(i), "served": int(served[i].argmax()),
                      "alone": int(alone[i].argmax()),
                      "top_two": top.tolist(),
                      "margin": float(top[1] - top[0])})
    return served, err, flips


def rest_stats(answers, wall, dispatches):
    """The load's numbers: requests/s, per-request wall percentiles, the
    dispatches that served it and their rows."""
    ms = [a[2] for a in answers]
    return dict(requests=len(answers), requests_per_s=len(answers) / wall,
                wall_ms_p50=pct(ms, 50), wall_ms_p99=pct(ms, 99),
                dispatches=len(dispatches), rows_dispatched=sum(dispatches),
                rows_per_dispatch=(sum(dispatches) / len(dispatches)
                                   if dispatches else 0.0),
                max_rows_per_dispatch=max(dispatches, default=0))


def rest_mnist():
    """(a) BASELINE #1 trained 2 epochs through the fused-FC kernel, then
    served: 256 validation rows POSTed from 32 threads through
    ``RestfulLoader(minibatch_size=8)``, each answer against the trained
    forward of that row alone on the card, the error count against the
    workflow's own evaluation of the same rows; the error paths (a bad
    shape, an unknown path, the pending bound, the loader's close, the
    stop sweep)."""
    import numpy
    import torch
    from veles_tpu_torch import RESTfulAPI
    from veles_tpu_torch.loader import stream
    from veles_tpu_torch.serving.scheduler import Ticket
    from veles_tpu_torch.workflow import Workflow
    from veles_tpu_torch.config import root
    before = fused_launches()
    try:
        wf = mnist_library_workflow(epochs=2, per_dispatch=2)
        wf.run()
    finally:
        root.common.engine.fused_fc_scan = False
    launches = fused_launches() - before
    step = wf.train_step
    dataset, labels = step._dataset()
    idx = torch.arange(REST_REQUESTS, device=step.device)
    rows = dataset[idx].cpu().numpy()
    want_labels = labels[idx].cpu().numpy()
    with torch.no_grad():
        batch_logits = step._forward(step.params, dataset[idx])
        own = step._eval_step(step.params, step._zero_accum(), dataset,
                              labels, idx.int(),
                              torch.ones(REST_REQUESTS, device=step.device))
    own_err = int(round(float(own["n_err"])))
    batch_pred = batch_logits.argmax(1).cpu().numpy()
    alone = forward_alone(wf, rows)
    serve_wf, loader, fwds, api = rest_workflow(
        wf.layers_config, trained_tree(wf), "RestfulLoader",
        sample_shape=(784,), minibatch_size=REST_MB, timeout=120.0)
    dispatches = record_dispatches(loader)
    thread = threading.Thread(target=serve_wf.run, daemon=True)
    thread.start()
    url = "http://127.0.0.1:%d" % api.port
    answers, wall = rest_load_apart(url + "/api", [{"input": r.tolist()}
                                                   for r in rows],
                                    REST_CLIENTS)
    stats = rest_stats(answers, wall, list(dispatches))
    metrics = http_status(url + "/metrics")[2]
    served_total = api.requests_served
    served, err, flips = served_vs_alone(answers, alone, "mnist")
    served_pred = served.argmax(1)
    served_err = int((served_pred != want_labels).sum())
    # a served row may differ from the 256-row evaluation only on a
    # near-tie of its logits
    logits = batch_logits.cpu().numpy()
    batch_flips = []
    for i in numpy.flatnonzero(served_pred != batch_pred):
        top = numpy.sort(logits[i])[-2:]
        batch_flips.append({"row": int(i), "top_two": top.tolist(),
                            "margin": float(top[1] - top[0])})
    bad_shape = http_status(url + "/api", {"input": [0.0] * 10})[0]
    after_bad = post(url + "/api", {"input": rows[0].tolist()})[0]
    unknown = http_status(url + "/nope", {"input": []})[0]
    health = [http_status(url + p)[0] for p in ("/healthz", "/readyz")]
    loader.close()
    thread.join(timeout=30)
    closed = not thread.is_alive()
    after_close = http_status(url + "/api", {"input": rows[0].tolist()})[0]
    straggler = Ticket()
    api._outstanding.add(straggler)
    api.stop()
    swept = (straggler.event.is_set() and straggler.code == 503
             and straggler.retry_after == 5.0
             and not straggler.fail("second sweep", code=503))
    shed_wf = Workflow(None, name="shed")
    shed_loader = stream.RestfulLoader(shed_wf, sample_shape=(784,),
                                       name="shed_loader")
    shed_api = RESTfulAPI(shed_wf, loader=shed_loader, port=0,
                          max_pending=0, name="shed_api")
    shed_api.initialize()
    try:
        shed = http_status("http://127.0.0.1:%d/api" % shed_api.port,
                           {"input": rows[0].tolist()})
    finally:
        shed_api.stop()
    return dict(
        fused_launches=launches, valid_err=wf.decision.epoch_metrics[1],
        max_err=err, argmax_flips=flips, batch_argmax_flips=batch_flips,
        served_err_count=served_err, workflow_err_count=own_err,
        requests_served=served_total,
        metrics_served_line="veles_rest_requests_served %d"
        % REST_REQUESTS in metrics.splitlines(),
        bad_shape=bad_shape, after_bad_shape=after_bad, unknown=unknown,
        health=health, after_close=after_close, workflow_ended=closed,
        stop_sweep_once=swept, shed=shed[0],
        shed_retry_after=shed[1].get("Retry-After"), **stats)


def image_tree(directory):
    """The CIFAR-10 surrogate's rows as a class tree of uint8 ``.npy``
    files (``c0/0000.npy`` ...), 500 a class: the reference's codec path
    for arrays (the card's machine has no Pillow)."""
    import numpy
    from veles_tpu_torch import datasets
    tx, ty, _, _ = datasets.load_cifar10(n_train=6000, n_test=10)
    for c in range(10):
        pick = numpy.flatnonzero(ty == c)[:IMG_FILES_PER_CLASS]
        if len(pick) < IMG_FILES_PER_CLASS:
            raise AssertionError("class %d has %d surrogate rows"
                                 % (c, len(pick)))
        d = os.path.join(directory, "c%d" % c)
        os.makedirs(d)
        for j, i in enumerate(pick):
            numpy.save(os.path.join(d, "%04d.npy" % j),
                       numpy.round(tx[i] * 255).astype(numpy.uint8))


def image_split_lengths(directory, multiplicity):
    """[test, valid, train] rows ``ClassImageLoader`` must give: each
    class's deterministic split, the train files times the host
    augmentation's multiplicity."""
    from veles_tpu_torch.loader import deterministic_split
    lengths = [0, 0, 0]
    for cls in sorted(os.listdir(directory)):
        files = [os.path.join(directory, cls, f)
                 for f in os.listdir(os.path.join(directory, cls))]
        tr, va, te = deterministic_split(files, IMG_VALID_RATIO, 0.0,
                                         key=cls)
        lengths[0] += len(te)
        lengths[1] += len(va)
        lengths[2] += len(tr) * multiplicity
    return lengths


def image_workflow(directory, layers, **loader_kw):
    from veles_tpu_torch import prng
    from veles_tpu_torch.loader import ClassImageLoader
    from veles_tpu_torch.nn.standard_workflow import StandardWorkflow
    prng.seed_all(SEED)
    loader = ClassImageLoader(None, root_dir=directory,
                              valid_ratio=IMG_VALID_RATIO,
                              minibatch_size=IMG_MB, name="images",
                              **loader_kw)
    wf = StandardWorkflow(
        name="cifar-images", layers=layers, loader_unit=loader,
        loss_function="softmax",
        decision_config=dict(max_epochs=1, fail_iterations=100))
    wf.initialize()
    return wf


def window_hits(src, out, crop):
    """(B, 2) bools on the device: whether each row of ``out`` is a
    ``crop`` window of its source row, unmirrored and mirrored."""
    import torch
    ch, cw = crop
    hits = []
    for flip in (False, True):
        s = src.flip(2) if flip else src
        wins = s.unfold(1, ch, 1).unfold(2, cw, 1).permute(0, 1, 2, 4, 5, 3)
        hits.append((wins == out[:, None, None]).flatten(3).all(-1)
                    .flatten(1).any(-1))
    return torch.stack(hits, 1)


def device_augment_checks(wf):
    """Device augmentation on the card by its semantics, for the first
    train step's key: one step's batch (mb rows), each row a window of
    its source or of its mirror; a 4,000-row draw's mirrored share;
    the same key the same draw, another key another; the evaluation
    crop exact."""
    import torch
    step, loader = wf.train_step, wf.loader
    dataset, _ = step._dataset()
    n = min(MIRROR_SHARE_ROWS, dataset.shape[0])
    big = dataset[:n]
    drawn = step._augmented(big, 0)
    src = big[:IMG_MB]
    out = step._augmented(src, 0)
    hits = torch.cat([window_hits(big[i:i + 500], drawn[i:i + 500],
                                  IMG_CROP) for i in range(0, n, 500)])
    mirrored = int((hits[:, 1] & ~hits[:, 0]).sum())
    ch, cw = IMG_CROP
    h, w = src.shape[1:3]
    y, x = (h - ch) // 2, (w - cw) // 2
    return dict(
        batch_rows=int(src.shape[0]),
        batch_all_windows=bool(window_hits(src, out, IMG_CROP).any(1).all()),
        draw_rows=n, draw_all_windows=bool(hits.any(1).all()),
        mirrored_share=mirrored / n,
        ambiguous_rows=int((hits[:, 0] & hits[:, 1]).sum()),
        same_key_same_draw=bool(torch.equal(out, step._augmented(src, 0))),
        other_key_other_draw=not torch.equal(out, step._augmented(src, 1)),
        eval_crop_exact=bool(torch.equal(loader.device_eval_fn(src),
                                         src[:, y:y + ch, x:x + cw, :])),
        out_shape=list(out.shape), on_card=out.device.type == "cuda")


def rest_images(directory):
    """(b) BASELINE #4's caffe-quick stack trained one epoch from a class
    tree of 5,000 ``.npy`` files with host augmentation, one epoch with
    device augmentation; the host-augmented model served through
    ``RestfulImageLoader``."""
    import numpy
    import torch
    from veles_tpu_torch.config import root
    from veles_tpu_torch.loader import decode_image
    from veles_tpu_torch.models import cifar
    t0 = time.perf_counter()
    image_tree(directory)
    write_s = time.perf_counter() - t0
    files = sorted(os.path.join(dp, f) for dp, _, fs in os.walk(directory)
                   for f in fs)
    t0 = time.perf_counter()
    for f in files:
        decode_image(f)
    decode_s = time.perf_counter() - t0
    layers = cifar.caffe_quick_layers(0.001)

    # host augmentation: every train file and its mirror
    wf = image_workflow(directory, layers, mirror=True)
    host_lengths = list(wf.loader.class_lengths)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wf.run()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3

    # device augmentation: one stored copy a file, mirror + crop on the
    # card in the train step; the fused gate stays off
    dev = image_workflow(directory, layers, mirror=True, crop=IMG_CROP,
                         device_augmentation=True)
    calls = []
    real_aug = dev.loader.device_augment_fn

    def counting(batch, generator):
        calls.append(generator is not None
                     and generator.device.type == "cuda")
        return real_aug(batch, generator)
    dev.loader.device_augment_fn = counting
    before = fused_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev.run()
    torch.cuda.synchronize()
    dev_ms = (time.perf_counter() - t0) * 1e3
    dev.loader.device_augment_fn = real_aug
    semantics = device_augment_checks(dev)
    dev_launches = fused_launches() - before
    root.common.engine.fused_fc_scan = True
    try:
        with _Reasons() as reasons:
            fc = image_workflow(directory, [
                {"type": "all2all_tanh", "output_sample_shape": 100},
                {"type": "softmax", "output_sample_shape": 10}],
                mirror=True, crop=IMG_CROP, device_augmentation=True)
        before = fused_launches()
        fc.run()
        fc_launches = fused_launches() - before
    finally:
        root.common.engine.fused_fc_scan = False

    # serving the host-augmented model: validation rows as ``input``
    n_valid = host_lengths[1]
    rows = wf.loader.original_data.mem[:min(IMG_REQUESTS, n_valid)]
    alone = forward_alone(wf, rows)
    serve_wf, loader, fwds, api = rest_workflow(
        wf.layers_config, trained_tree(wf), "RestfulImageLoader",
        sample_shape=(32, 32, 3), minibatch_size=IMG_REST_MB,
        timeout=120.0)
    dispatches = record_dispatches(loader)
    thread = threading.Thread(target=serve_wf.run, daemon=True)
    thread.start()
    url = "http://127.0.0.1:%d/api" % api.port
    answers, wall = rest_load_apart(url, [{"input": r.tolist()}
                                          for r in rows], IMG_CLIENTS)
    stats = rest_stats(answers, wall, list(dispatches))
    served, err, flips = served_vs_alone(answers, alone, "images")
    png = {"png_payloads": "skipped: no Pillow on this machine"}
    try:
        import PIL  # noqa: F401
    except ImportError:
        pass
    else:
        import base64
        import io
        from PIL import Image
        payloads = []
        for r in rows:
            buf = io.BytesIO()
            Image.fromarray(numpy.round(r * 255).astype(numpy.uint8)).save(
                buf, format="PNG")
            payloads.append({"image": base64.b64encode(
                buf.getvalue()).decode()})
        png_answers, _ = rest_load_apart(url, payloads, IMG_CLIENTS)
        png_served, png_err, _ = served_vs_alone(png_answers, alone, "png")
        png = {"png_payloads": len(png_answers),
               "png_vs_input_max_err": float(numpy.abs(
                   png_served - served).max()), "png_max_err": png_err}
    loader.close()
    thread.join(timeout=30)
    api.stop()
    return dict(
        files=len(files), write_s=write_s, decode_s=decode_s,
        host_class_lengths=host_lengths,
        expected_host_lengths=image_split_lengths(directory, 2),
        host_epoch_ms=host_ms, host_loss=wf.decision.epoch_losses[2],
        host_valid_err=wf.decision.epoch_metrics[1],
        device_class_lengths=list(dev.loader.class_lengths),
        expected_device_lengths=image_split_lengths(directory, 1),
        device_epoch_ms=dev_ms, device_loss=dev.decision.epoch_losses[2],
        device_valid_err=dev.decision.epoch_metrics[1],
        device_minibatch_shape=list(dev.loader.minibatch_data.shape[1:]),
        device_stored_shape=list(dev.loader.original_data.shape[1:]),
        augment_calls=len(calls), augment_calls_on_card=all(calls),
        train_steps=-(-dev.loader.class_lengths[2] // IMG_MB),
        device_semantics=semantics,
        device_fused_engaged=dev.train_step._fused_fc is not None,
        device_fused_launches=dev_launches,
        fc_chain_reasons=reasons.messages, fc_chain_launches=fc_launches,
        fc_chain_engaged=fc.train_step._fused_fc is not None,
        max_err=err, argmax_flips=flips, requests_served=api.requests_served,
        **png, **stats)


def phase_rest_serving(card):
    """Phase 35: classic REST serving of a trained classifier and the
    image loaders with on-device augmentation. Every part fails the run
    on a miss. Returns the fused-FC launches of (a)'s training."""
    import tempfile
    t_phase = time.perf_counter()
    mnist = rest_mnist()
    t_mnist = time.perf_counter() - t_phase
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        images = rest_images(tmp)
    print(json.dumps({"png_payloads": images["png_payloads"]}), flush=True)
    emit("rest_serving", card=card, mnist=mnist, images=images,
         mnist_s=t_mnist, phase_s=time.perf_counter() - t_phase)
    bad = []
    if mnist["fused_launches"] != 2:
        bad.append("fused-FC launches %s, want 2" % mnist["fused_launches"])
    if mnist["max_err"] > TOL_REST or any(
            f["margin"] > TOL_REST for f in mnist["argmax_flips"]):
        bad.append("mnist answers vs alone: %s, flips %s"
                   % (mnist["max_err"], mnist["argmax_flips"]))
    if mnist["served_err_count"] != mnist["workflow_err_count"] and (
            abs(mnist["served_err_count"] - mnist["workflow_err_count"])
            > len(mnist["batch_argmax_flips"]) or any(
                f["margin"] > TOL_REST
                for f in mnist["batch_argmax_flips"])):
        bad.append("served errors %d, the workflow's %d (flips %s)"
                   % (mnist["served_err_count"],
                      mnist["workflow_err_count"],
                      mnist["batch_argmax_flips"]))
    if not (mnist["dispatches"] < REST_REQUESTS
            and mnist["max_rows_per_dispatch"] <= REST_MB
            and mnist["rows_dispatched"] == REST_REQUESTS):
        bad.append("dynamic batching: %d dispatches, at most %d rows"
                   % (mnist["dispatches"], mnist["max_rows_per_dispatch"]))
    if mnist["requests_served"] != REST_REQUESTS \
            or not mnist["metrics_served_line"]:
        bad.append("requests_served %d (want %d), /metrics line %s"
                   % (mnist["requests_served"], REST_REQUESTS,
                      mnist["metrics_served_line"]))
    if (mnist["bad_shape"], mnist["after_bad_shape"], mnist["unknown"],
            mnist["health"], mnist["after_close"]) != (
                400, 200, 404, [200, 200], 503):
        bad.append("error paths %s" % {k: mnist[k] for k in (
            "bad_shape", "after_bad_shape", "unknown", "health",
            "after_close")})
    if mnist["shed"] != 503 or not mnist["shed_retry_after"]:
        bad.append("pending bound: %s, Retry-After %s"
                   % (mnist["shed"], mnist["shed_retry_after"]))
    if not (mnist["workflow_ended"] and mnist["stop_sweep_once"]):
        bad.append("close ended the workflow %s, stop sweep once %s"
                   % (mnist["workflow_ended"], mnist["stop_sweep_once"]))
    if images["host_class_lengths"] != images["expected_host_lengths"] \
            or images["device_class_lengths"] != \
            images["expected_device_lengths"]:
        bad.append("class lengths %s / %s, the split gives %s / %s" % (
            images["host_class_lengths"], images["device_class_lengths"],
            images["expected_host_lengths"],
            images["expected_device_lengths"]))
    if not all(math.isfinite(v) for v in images["host_loss"]
               + images["device_loss"]):
        bad.append("losses %s / %s" % (images["host_loss"],
                                      images["device_loss"]))
    sem = images["device_semantics"]
    if not (sem["batch_all_windows"] and sem["draw_all_windows"]
            and abs(sem["mirrored_share"] - 0.5) <= TOL_MIRROR_SHARE
            and sem["same_key_same_draw"] and sem["other_key_other_draw"]
            and sem["eval_crop_exact"] and sem["on_card"]
            and sem["out_shape"][1:] == list(IMG_CROP) + [3]):
        bad.append("device augmentation %s" % sem)
    if images["device_minibatch_shape"] != list(IMG_CROP) + [3] \
            or images["device_stored_shape"] != [32, 32, 3]:
        bad.append("minibatch %s, stored %s"
                   % (images["device_minibatch_shape"],
                      images["device_stored_shape"]))
    if images["augment_calls"] < images["train_steps"] \
            or not images["augment_calls_on_card"]:
        bad.append("augmentation drawn %d times for %d train steps (on the "
                   "card: %s)" % (images["augment_calls"],
                                  images["train_steps"],
                                  images["augment_calls_on_card"]))
    if images["device_fused_engaged"] or images["device_fused_launches"] \
            or images["fc_chain_engaged"] or images["fc_chain_launches"] \
            or not any(m.endswith("device-side augmentation not fused")
                       for m in images["fc_chain_reasons"]):
        bad.append("fused gate under device augmentation: %s" % {
            k: images[k] for k in ("device_fused_engaged",
                                   "device_fused_launches",
                                   "fc_chain_engaged", "fc_chain_launches",
                                   "fc_chain_reasons")})
    if images["max_err"] > TOL_REST or any(
            f["margin"] > TOL_REST for f in images["argmax_flips"]) \
            or images["requests_served"] < IMG_REQUESTS:
        bad.append("image answers vs alone: %s, flips %s, served %d"
                   % (images["max_err"], images["argmax_flips"],
                      images["requests_served"]))
    if images["dispatches"] >= IMG_REQUESTS \
            or images["max_rows_per_dispatch"] > IMG_REST_MB:
        bad.append("image dynamic batching: %d dispatches, at most %d rows"
                   % (images["dispatches"],
                      images["max_rows_per_dispatch"]))
    if images.get("png_vs_input_max_err", 0.0) > TOL_REST:
        bad.append("png answers vs input answers %s"
                   % images["png_vs_input_max_err"])
    if bad:
        raise AssertionError("rest_serving: " + "; ".join(bad))
    return mnist["fused_launches"]


#: quant_serving: the four engines of (a) (serve_continuous's knobs), the
#: requests of (a) served alone on each int8 engine (every third: each
#: prompt length, greedy and sampled), the profiled decode ticks an
#: engine with 8 rows live, and the reference's drill (``bench.py:
#: 3021-3070``: seed 515, char LM 1 block d 32, 2 epochs, 12 greedy
#: requests of 8 tokens) with its logit bar
QUANT_ENGINES = (("float", {}), ("weights", {"quant_weights": True}),
                 ("kv", {"quant_kv": True}),
                 ("both", {"quant_weights": True, "quant_kv": True}))
QUANT_SOLO = tuple(range(0, 24, 3))
QUANT_TICKS = 10
QUANT_DRILL = dict(max_slots=8, buckets=(8, 16), max_context=32,
                   decode_block=8)
QUANT_DRILL_LENGTHS = (5, 9, 14, 7, 12, 16, 6, 11, 13, 8, 15, 10)
TOL_QUANT_LOGIT = 0.25
#: requests of (a) the int8 snapshot's server answers in another process
QUANT_SERVED = (0, 2, 5, 7, 12, 14, 19, 21)


def quant_requests(requests):
    from veles_tpu_torch.serving import make_request
    return [make_request(r["prompt"], r["n_new"],
                         temperature=r.get("temperature", 0.0),
                         seed=r["seed"], mode=r.get("mode", "greedy"))
            for r in requests]


def quant_engine_run(model, requests, name, solo=(), **knobs):
    """``requests`` posted at once on a fresh engine with serve_continuous's
    knobs and ``knobs``, then those of ``solo`` alone: the answers, the
    counters, the pool and the peak memory of the concurrent run."""
    import torch
    from veles_tpu_torch.serving import ContinuousEngine
    from veles_tpu_torch.telemetry import counters
    reqs = quant_requests(requests)
    # the engines before this one hold their pools until a collection
    # (a stopped engine's callbacks form a cycle)
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    engine = ContinuousEngine(model, name=name, **CONT_ENGINE,
                              **knobs).start()
    try:
        torch.cuda.synchronize()
        counters.counters.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = engine.serve(reqs, timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rec = dict(tokens=out, wall_s=wall, snap=counters.counters.snapshot(),
                   peak_memory_bytes=int(torch.cuda.max_memory_allocated()),
                   resident_bytes=int(resident),
                   stats=engine.stats(),
                   by_bucket=dict(engine.prefills_by_bucket),
                   ledger=engine.page_pool.ledger(),
                   decode_tick_ms_p50=pct(engine.decode_ms, 50),
                   rows=engine.page_pool.device_rows * engine.page_size)
        rec["solo"] = {i: engine.serve([reqs[i]], timeout=600)[0]
                       for i in solo}
    finally:
        engine.stop()
    rec["tokens_per_s"] = sum(len(t) for t in out) / wall
    return rec


def quant_tick_profile(model, requests, knobs):
    """QUANT_TICKS decode ticks of an engine with all 8 rows live under
    torch.profiler: ms and launches a tick, the device's idle share."""
    import torch
    from veles_tpu_torch.serving import ContinuousEngine
    from veles_tpu_torch.serving.scheduler import Ticket
    engine = ContinuousEngine(model, name="quant_ticks", **CONT_ENGINE,
                              **knobs)
    try:
        for req in quant_requests(requests[:CONT_ENGINE["max_slots"]]):
            req["n_new"] = QUANT_TICKS + 8
            engine.submit(req, Ticket())
        with torch.inference_mode():
            engine._tick()
            live = engine.scheduler.busy_count()

            def ticks():
                for _ in range(QUANT_TICKS):
                    engine._tick()

            rec = profiled(ticks)
    finally:
        engine.stop()
    return dict(live_rows=live, tick_ms=rec["profiled_wall_ms"] / QUANT_TICKS,
                launches_per_tick=(rec["kernel_launches"] or 0) / QUANT_TICKS,
                device_idle_share=rec["device_idle_share"],
                top_kernels=rec["top_kernels"][:6])


def quant_first_flip(model, req, want, got):
    """Where an int8 engine's greedy tokens first leave the float
    engine's: the position, and the float model's two logits there with
    their margin (None when equal)."""
    from veles_tpu_torch.nn import sampling
    for j, (a, b) in enumerate(zip(want, got)):
        if a != b:
            logits = sampling.prompt_logits(model, req["prompt"] + want[:j])
            return {"position": j, "float_token": int(a),
                    "int8_token": int(b),
                    "float_logit": float(logits[a]),
                    "int8_logit": float(logits[b]),
                    "margin": float(logits[a] - logits[b])}
    return None


def quant_bench_load(card):
    """(a): the bench LM (seed 0) under serve_continuous's 24 requests on
    the float engine, the int8 engines and the float engine serving the
    dequantized twin; the quantizer's bits on the card against the CPU;
    the pool's bytes; the calibrate fault. Returns (record, problems,
    the engines' answers, the model)."""
    import numpy
    import torch
    from veles_tpu_torch import quant
    from veles_tpu_torch.convert import params_from_jax
    from veles_tpu_torch.nn import sampling
    from veles_tpu_torch.nn.standard_workflow import build_forwards
    from veles_tpu_torch.ops import flash_attention as fa
    from veles_tpu_torch.resilience import faults
    from veles_tpu_torch.serving import ContinuousEngine
    from veles_tpu_torch.telemetry import counters
    bad = []
    model = bench_lm()
    requests = continuous_load()
    n, n_blocks = len(requests), len(BENCH_LAYERS) - 2
    blocks = [layer for layer in model if hasattr(layer, "n_kv_heads")]
    kv_dh = blocks[0].n_kv_heads * blocks[0].head_dim

    # the quantizer's bits: every eligible weight on the card vs the CPU
    params = sampling.params_of(model)
    q_card, report = quant.quantize_params(params)
    q_cpu, report_cpu = quant.quantize_params(
        {u: {k: v.cpu() for k, v in t.items()} for u, t in params.items()})
    records = [(u, k) for u, t in q_card.items() for k, v in t.items()
               if isinstance(v, dict)]
    weights_bits = report == report_cpu and all(
        torch.equal(q_card[u][k]["q"].cpu(), q_cpu[u][k]["q"])
        and q_card[u][k]["scale"].cpu().numpy().tobytes()
        == q_cpu[u][k]["scale"].numpy().tobytes() for u, k in records)
    requant = quant.quantize_params(quant.dequantize_params(q_card))[0]
    requant_same = all(torch.equal(requant[u][k]["q"], q_card[u][k]["q"])
                       and torch.equal(requant[u][k]["scale"],
                                       q_card[u][k]["scale"])
                       for u, k in records)
    # ... and the K/V rows of the longest prompt's prefill, every block
    with torch.inference_mode():
        stack = sampling.split_stack(model)
        ids = torch.as_tensor([requests[-1]["prompt"]],
                              device=stack["stem"].table.device)
        x = sampling._embed_prompt(stack["stem"], stack["pos_emb"], ids)
        _, caches = sampling._prefill_blocks(stack["blocks"], x,
                                             ids.shape[1])
        kv_bits = True
        for pair in caches:
            for rows in pair:
                qc, sc = quant.quantize_rows_int8(rows[0])
                qh, sh = quant.quantize_rows_int8(rows[0].cpu())
                kv_bits &= bool(torch.equal(qc.cpu(), qh)) and \
                    sc.cpu().numpy().tobytes() == sh.numpy().tobytes()
    del caches, x
    if not weights_bits or not kv_bits:
        bad.append("quantizer bits card vs CPU: weights %s, K/V rows %s"
                   % (weights_bits, kv_bits))
    want_saved = report["bytes_before"] - report["bytes_after"]

    # the float engine serving the dequantized twin
    twin = build_forwards(BENCH_LAYERS)
    params_from_jax(twin, {u: {k: v.cpu().numpy() for k, v in t.items()}
                           for u, t in quant.dequantize_params(
                               q_card).items()})
    # warm-up outside the measured runs
    for name, knobs in (QUANT_ENGINES[0], QUANT_ENGINES[-1]):
        warm = ContinuousEngine(model, name="quant_warm", **CONT_ENGINE,
                                **knobs).start()
        try:
            warm.serve(quant_requests([requests[0], requests[-1]]))
        finally:
            warm.stop()
    runs = {}
    for name, knobs in QUANT_ENGINES:
        runs[name] = quant_engine_run(model, requests, "quant_" + name,
                                      QUANT_SOLO if knobs else (), **knobs)
    runs["twin"] = quant_engine_run(twin, requests, "quant_twin")
    want_buckets = {}
    for req in requests:
        b = CONT_ENGINE["buckets"][next(
            i for i, b in enumerate(CONT_ENGINE["buckets"])
            if b >= len(req["prompt"]))]
        want_buckets[b] = want_buckets.get(b, 0) + 1
    for name, run in runs.items():
        snap, st = run["snap"], run["stats"]
        prefills = snap.get("veles_serving_prefill_dispatches_total", 0)
        launches = snap.get(fa.FWD_LAUNCHES, 0)
        run["prefills"], run["flash_launches"] = prefills, launches
        if prefills != n or launches != n_blocks * prefills \
                or run["by_bucket"] != want_buckets:
            bad.append("%s: flash launches %d, prefills %d, buckets %r"
                       % (name, launches, prefills, run["by_bucket"]))
        if not st["admitted"] == st["retired"] == n or run["ledger"] \
                or st["pages_in_use"]:
            bad.append("%s: admitted %d retired %d, pages %r"
                       % (name, st["admitted"], st["retired"],
                          run["ledger"]))
        deltas = {k: snap.get(k, 0) for k in quant.QUANT_COUNTERS}
        run["quant_counters"] = deltas
        qw = name in ("weights", "both")
        want = {k: 0 for k in quant.QUANT_COUNTERS}
        if qw:
            want.update(veles_quant_calibrations_total=1,
                        veles_quant_params_total=len(records),
                        veles_quant_bytes_saved_total=want_saved)
        if deltas != want:
            bad.append("%s: quant counters %r, want %r"
                       % (name, deltas, want))
        for i, toks in run["solo"].items():
            if toks != run["tokens"][i]:
                bad.append("%s: request %d alone %r != concurrent %r"
                           % (name, i, toks, run["tokens"][i]))
        want_pool = len(blocks) * 2 * run["rows"] * (
            kv_dh + 4 if name in ("kv", "both") else kv_dh * 4)
        run["pool_bytes_from_shapes"] = want_pool
        if st["kv_pool_bytes"] != want_pool:
            bad.append("%s: pool %d bytes, the shapes give %d"
                       % (name, st["kv_pool_bytes"], want_pool))
    pool_ratio = (runs["kv"]["stats"]["kv_pool_bytes"],
                  runs["float"]["stats"]["kv_pool_bytes"])
    if pool_ratio[0] * 4096 != pool_ratio[1] * 1032:
        bad.append("int8 / float pool %d / %d, not 1032 / 4096"
                   % pool_ratio)
    if runs["weights"]["tokens"] != runs["twin"]["tokens"]:
        diff = [i for i, (a, b) in enumerate(zip(runs["weights"]["tokens"],
                                                 runs["twin"]["tokens"]))
                if a != b]
        bad.append("int8 weights != the dequantized twin on requests %s"
                   % diff)
    greedy = [i for i, r in enumerate(requests) if not r.get("temperature")]
    agreement, flips = {}, {}
    for name in ("weights", "kv", "both"):
        same = [runs[name]["tokens"][i] == runs["float"]["tokens"][i]
                for i in greedy]
        agreement[name] = sum(same) / len(greedy)
        first = next((i for i, s in zip(greedy, same) if not s), None)
        flips[name] = None if first is None else dict(
            request=first, **(quant_first_flip(
                model, requests[first], runs["float"]["tokens"][first],
                runs[name]["tokens"][first]) or {}))
    dq = quant.dequantize_params(q_card)
    logit_delta = max(float(numpy.abs(
        sampling.prompt_logits(model, r["prompt"])
        - sampling.prompt_logits(model, r["prompt"], params=dq)).max())
        for r in requests)
    ticks = {name: quant_tick_profile(model, requests, knobs)
             for name, knobs in QUANT_ENGINES}

    # the calibrate fault: one failed tick, then the queued request
    prev = os.environ.get("VELES_FAULTS")
    os.environ["VELES_FAULTS"] = "quant.calibrate:raise:times=1"
    faults.plane.configure()
    injected = counters.get("veles_faults_injected_total")
    try:
        engine = ContinuousEngine(model, quant_weights=True,
                                  name="quant_fault", **CONT_ENGINE).start()
        try:
            fault_answer = engine.serve(quant_requests(requests[:1]),
                                        timeout=120)[0]
        finally:
            engine.stop()
    finally:
        if prev is None:
            os.environ.pop("VELES_FAULTS", None)
        else:
            os.environ["VELES_FAULTS"] = prev
        faults.plane.configure()
    injected = counters.get("veles_faults_injected_total") - injected
    if injected < 1 or fault_answer != runs["weights"]["tokens"][0]:
        bad.append("calibrate fault: %d injected, answer %r, want %r"
                   % (injected, fault_answer, runs["weights"]["tokens"][0]))
    rec = dict(
        requests=n, engine=CONT_ENGINE, eligible_weights=len(records),
        quantizer_bits_equal_cpu={"weights": weights_bits,
                                  "kv_rows": kv_bits},
        requant_idempotent=requant_same,
        weights_equal_twin=runs["weights"]["tokens"]
        == runs["twin"]["tokens"],
        bytes_before=report["bytes_before"],
        bytes_after=report["bytes_after"],
        pool_ratio=[pool_ratio[0], pool_ratio[1],
                    pool_ratio[0] / pool_ratio[1]],
        greedy_agreement=agreement, first_flip=flips,
        max_logit_delta=logit_delta, fault_injected=injected,
        engines={name: {k: run[k] for k in (
            "wall_s", "tokens_per_s", "peak_memory_bytes",
            "resident_bytes", "prefills",
            "flash_launches", "by_bucket", "quant_counters",
            "decode_tick_ms_p50", "pool_bytes_from_shapes")}
            | {"kv_pool_bytes": run["stats"]["kv_pool_bytes"],
               "solo_equal": all(run["tokens"][i] == t
                                 for i, t in run["solo"].items()),
               "ticks": ticks.get(name)}
            for name, run in runs.items()})
    launches = sum(run["flash_launches"] for run in runs.values())
    return rec, bad, runs, launches


def quant_drill():
    """(b): the reference's quant proof at its own size, trained on the
    card: float and int8 (weights + KV) engines with its knobs on its 12
    greedy requests; the int8 answers token-exact, the max logit delta of
    the dequantized twin under TOL_QUANT_LOGIT."""
    import numpy
    from veles_tpu_torch import prng, quant
    from veles_tpu_torch.models import char_lm
    from veles_tpu_torch.nn import sampling
    from veles_tpu_torch.nn.standard_workflow import forwards_of
    from veles_tpu_torch.ops import flash_attention as fa
    from veles_tpu_torch.serving import ContinuousEngine, make_request
    from veles_tpu_torch.telemetry import counters
    prng.seed_all(515)
    wf = char_lm.build_workflow(epochs=2, minibatch_size=32, n_blocks=1,
                                dim=32, n_train=256, n_valid=32)
    wf.initialize()
    counters.counters.reset()
    wf.run()
    train_launches = {k: counters.get(k) for k in (
        fa.FWD_LAUNCHES, fa.DKV_LAUNCHES, fa.DQ_LAUNCHES)}
    model = forwards_of(wf)
    rng = numpy.random.RandomState(23)
    reqs = [make_request([int(t) for t in rng.randint(0, char_lm.VOCAB,
                                                      t_p)], 8)
            for t_p in QUANT_DRILL_LENGTHS]
    out = {}
    for name, knobs in (("float", {}), ("int8", {"quant_weights": True,
                                                 "quant_kv": True})):
        engine = ContinuousEngine(model, name="drill_" + name,
                                  **QUANT_DRILL, **knobs).start()
        try:
            engine.serve(list(reqs))
            t0 = time.perf_counter()
            out[name] = engine.serve(list(reqs))
            out[name + "_tokens_per_s"] = sum(r["n_new"] for r in reqs) / (
                time.perf_counter() - t0)
        finally:
            engine.stop()
    match = sum(a == b for a, b in zip(out["float"], out["int8"])) / len(
        reqs)
    qparams, _ = quant.quantize_params(sampling.params_of(model))
    dq = quant.dequantize_params(qparams)
    delta = max(float(numpy.abs(
        sampling.prompt_logits(model, r["prompt"])
        - sampling.prompt_logits(model, r["prompt"], params=dq)).max())
        for r in reqs)
    rec = dict(
        train_flash_launches=train_launches, greedy_token_match=match,
        max_logit_delta=delta,
        float_tokens_per_s=out["float_tokens_per_s"],
        int8_tokens_per_s=out["int8_tokens_per_s"])
    bad = []
    if match < 1.0:
        bad.append("drill: int8 greedy not token-exact (match %.2f)"
                   % match)
    if not delta < TOL_QUANT_LOGIT:
        bad.append("drill: max logit delta %.4f" % delta)
    if not train_launches[fa.FWD_LAUNCHES] > 0:
        bad.append("drill: the flash kernels did not train the model")
    return rec, bad, train_launches[fa.FWD_LAUNCHES]


def quant_snapshot_check(src, out, label):
    """An int8 snapshot ``out`` written by the subcommand from ``src``:
    its manifest verifies, its records are the eligible tensors' with the
    bytes the shapes give, and ``load_snapshot`` returns the in-process
    quantizer's ``q · s`` bit for bit."""
    import numpy
    from veles_tpu_torch import quant
    from veles_tpu_torch.quant.weights import _eligible
    from veles_tpu_torch.resilience.checkpoint_chain import verify
    from veles_tpu_torch.snapshotter import _read_state, load_snapshot
    src_state = load_snapshot(src)
    eligible = {(u, k): a for u, sd in src_state["__units__"].items()
                if isinstance(sd, dict) for k, a in sd.items()
                if isinstance(a, numpy.ndarray) and _eligible(k, a)}
    raw = _read_state(out)              # the records, not expanded
    recs = {(u, k): v for u, sd in raw["__units__"].items()
            if isinstance(sd, dict) for k, v in sd.items()
            if isinstance(v, dict) and "__quant__" in v}
    payload_ok = set(recs) == set(eligible) and all(
        recs[key]["q"].nbytes == eligible[key].size
        and recs[key]["scale"].nbytes == 4 * eligible[key].shape[1]
        for key in recs)
    saved = sum(a.nbytes - a.size - 4 * a.shape[1]
                for a in eligible.values())
    want = quant.dequantize_state(quant.quantize_state(src_state)[0])
    got = load_snapshot(out)
    bits = all(got["__units__"][u][k].tobytes()
               == want["__units__"][u][k].tobytes() for u, k in eligible)
    bad = []
    if verify(out) is not True or not payload_ok or not bits:
        bad.append("%s int8 snapshot: manifest %s, payload %s, q·s bits %s"
                   % (label, verify(out), payload_ok, bits))
    return dict(records=len(recs), bytes_saved_by_shapes=saved,
                src_bytes=os.path.getsize(src), out_bytes=os.path.getsize(out),
                manifest=verify(out), payload_as_shapes=payload_ok,
                q_times_s_bits=bits), bad, got


def quant_snapshots(card, tmp, runs):
    """(c): MNIST (2 fused-FC epochs) and the bench LM (seed 0 weights)
    exported by the Snapshotter, quantized by ``python -m veles_tpu_torch
    quantize`` subprocesses; MNIST resumed from its int8 snapshot
    evaluates to the dequantized weights' error count; the LM's int8
    snapshot served by ``--serve-generate --quant-weights --quant-kv`` in
    another process answers (a)'s int8 engine's tokens."""
    import signal
    import torch
    from veles_tpu_torch.config import root
    from veles_tpu_torch.convert import params_from_jax, random_params
    from veles_tpu_torch.models import char_lm
    from veles_tpu_torch.nn.standard_workflow import forwards_of
    from veles_tpu_torch.snapshotter import Snapshotter, resume
    from veles_tpu_torch.telemetry import counters
    bad = []
    # MNIST, 2 fused-FC epochs, its _current snapshot
    mnist_dir = os.path.join(tmp, "mnist")
    wf = mnist_workflow(True, epochs=2, per_dispatch=2,
                        snapshot_dir=mnist_dir)
    counters.counters.reset()
    wf.run()
    ffc = counters.get("veles_fused_fc_launches_total")
    mnist_src = os.path.join(mnist_dir, "mnist_current.pickle.gz")
    # the bench LM's workflow holding (a)'s weights, exported uncompressed
    lm = char_lm.build_bench_workflow()
    lm.decision.max_epochs = 1
    lm.initialize()
    bench = bench_lm()
    tree = random_params(bench, seed=0)
    params_from_jax(lm, {unit.name: tree[layer.name] for unit, layer in
                         zip(forwards_of(lm), bench)})
    del bench
    lm_src = Snapshotter(lm, prefix="benchlm", directory=os.path.join(
        tmp, "lm"), compression="").export()
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        cli_command("quantize", src), cwd=REPO, env=cli_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, src in (("mnist", mnist_src), ("lm", lm_src))}
    said = {name: p.communicate(timeout=600) for name, p in procs.items()}
    quantize_s = time.perf_counter() - t0
    for name, p in procs.items():
        if p.returncode != 0:
            raise AssertionError("quantize %s exited %d:\n%s"
                                 % (name, p.returncode, said[name][1][-3000:]))
    mnist_out = mnist_src.replace(".pickle", ".int8.pickle")
    lm_out = lm_src.replace(".pickle", ".int8.pickle")
    mnist_rec, b, state = quant_snapshot_check(mnist_src, mnist_out, "mnist")
    bad += b
    lm_rec, b, _ = quant_snapshot_check(lm_src, lm_out, "lm")
    bad += b
    # MNIST resumed from the int8 snapshot vs the dequantized weights
    wf2 = mnist_workflow(True, epochs=2, per_dispatch=2)
    resume(wf2, mnist_out)
    step = wf2.train_step
    dataset, labels = step._dataset()
    lengths = wf2.loader.class_lengths
    idx = torch.arange(lengths[0], lengths[0] + lengths[1],
                       device=step.device)
    twin = {u: {k: torch.from_numpy(state["__units__"][u][k]).to(
        step.device) for k in p} for u, p in step.params.items()}
    with torch.no_grad():
        own = step._eval_step(step.params, step._zero_accum(), dataset,
                              labels, idx.int(),
                              torch.ones(len(idx), device=step.device))
        twin_out = step._forward(twin, dataset[idx])
        twin_err = int((twin_out.argmax(1) != labels[idx].long()).sum())
        same_out = torch.equal(step._forward(step.params, dataset[idx]),
                               twin_out)
    resumed_err = int(round(float(own["n_err"])))
    if resumed_err != twin_err or not same_out:
        bad.append("mnist from its int8 snapshot: %d errors, the "
                   "dequantized weights %d, outputs equal %s"
                   % (resumed_err, twin_err, same_out))
    del wf, wf2, lm
    root.common.engine.fused_fc_scan = False
    # the LM's int8 snapshot served in another process
    model_py = os.path.join(tmp, "lm_model.py")
    with open(model_py, "w") as fout:
        fout.write(CLI_LM_MODEL)
    t0 = time.perf_counter()
    server = subprocess.Popen(
        cli_command(model_py, "--snapshot", lm_out, "--serve-generate", "0",
                    "--quant-weights", "--quant-kv", *CLI_SERVE_FLAGS),
        cwd=REPO, env=cli_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    head, port = [], None
    try:
        while port is None:
            line = server.stdout.readline()
            if not line:
                raise AssertionError("quant: the server exited %s before "
                                     "serving:\n%s" % (server.poll(),
                                                       "".join(head[-40:])))
            if line.startswith("SERVING port="):
                port = int(line.split("=", 1)[1])
            else:
                head.append(line)
        startup_s = time.perf_counter() - t0
        reader = threading.Thread(target=lambda: head.extend(
            iter(server.stdout.readline, "")), daemon=True)
        reader.start()
        base = "http://127.0.0.1:%d" % port
        requests = continuous_load()
        sent = [requests[i] for i in QUANT_SERVED]
        results, wall = post_all(base + "/generate", sent)
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            page = r.read().decode()
        server.send_signal(signal.SIGTERM)
        server.wait(timeout=CLI_DRAIN_GRACE + 60)
        reader.join(timeout=60)
    finally:
        if server.poll() is None:
            server.kill()
            server.communicate()
    served = [None if r is None or r[0] != 200 else r[1]["tokens"]
              for r in results]
    want = [runs["both"]["tokens"][i] for i in QUANT_SERVED]
    modes = {m: metric_value(page, m) for m in (
        "veles_quant_weights_mode", "veles_quant_kv_mode")}
    if served != want or modes != {"veles_quant_weights_mode": 1,
                                   "veles_quant_kv_mode": 1}:
        bad.append("int8 snapshot served in another process: equal %s, "
                   "modes %r" % ([a == b for a, b in zip(served, want)],
                                 modes))
    rec = dict(mnist=dict(mnist_rec, fused_fc_launches=ffc,
                          resumed_err=resumed_err, twin_err=twin_err,
                          outputs_equal_twin=same_out),
               lm=dict(lm_rec), quantize_s=quantize_s,
               served=dict(requests=len(sent), equal_to_a=served == want,
                           metrics_modes=modes, startup_s=startup_s,
                           wall_s=wall, exit_code=server.returncode))
    if ffc != 2:
        bad.append("mnist: %d fused-FC launches, want 2" % ffc)
    return rec, bad, ffc


def phase_quant_serving(card):
    """Phase 36: int8 serving. (a) the bench LM's four engines, (b) the
    reference's drill, (c) int8 snapshots through the subcommand and a
    served resume. Every part fails the run on a miss. Returns the
    flash-forward launches of (a) and (b) and the fused-FC launches of
    (c)."""
    import shutil
    import tempfile
    import torch
    t_phase = time.perf_counter()
    bench, bad, runs, launches = quant_bench_load(card)
    t_a = time.perf_counter() - t_phase
    drill, drill_bad, drill_launches = quant_drill()
    bad += drill_bad
    t_b = time.perf_counter() - t_phase - t_a
    tmp = tempfile.mkdtemp(dir=os.environ.get("TMPDIR"))
    try:
        snaps, snap_bad, ffc = quant_snapshots(card, tmp, runs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bad += snap_bad
    del runs
    torch.cuda.empty_cache()
    emit("quant_serving", card=card, bench=bench, drill=drill,
         snapshots=snaps, a_s=t_a, b_s=t_b,
         phase_s=time.perf_counter() - t_phase)
    if bad:
        raise AssertionError("quant_serving: " + "; ".join(bad))
    return launches + drill_launches, ffc


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
    launches_spec = phase_serve_spec_beam(card)
    launches_qos = phase_serve_qos_handoff(card)
    launches_ffc = phase_train(card)
    phase_train_breakdown(card)
    worst_bwd = phase_kernels_bwd(fa)
    timing_bwd = phase_timing_bwd(fa, card)
    lm_wf, launches_lm, lm_f32 = phase_train_lm(card)
    lm_losses = {cls: list(lm_wf.decision.epoch_losses[cls])
                 for cls in (1, 2)}
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
    launches_tel, launches_tel_ffc = phase_telemetry(card)
    del lm_wf
    launches_cli = phase_cli(card, lm_losses)
    phase_znicz_units(card)
    phase_train_alexnet(card)
    phase_train_unsupervised(card)
    launches_text = phase_train_text(card)
    launches_library = phase_train_library(card)
    launches_family = phase_lm_family(card)
    launches_rest = phase_rest_serving(card)
    launches_quant, launches_quant_ffc = phase_quant_serving(card)

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
                                         ("f32_f32", name)],
                                     "cli": launches_cli[name],
                                     "train_text": launches_text[name],
                                     "lm_family": launches_family[name]},
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
                             "serve_spec_beam": launches_spec,
                             "serve_qos_handoff": launches_qos,
                             "train_lm": launches_lm["fwd"],
                             "train_lm_amp": launches_amp[("f32_f32",
                                                           "fwd")],
                             "telemetry": launches_tel,
                             "cli": launches_cli["fwd"],
                             "train_text": launches_text["fwd"],
                             "lm_family": launches_family["fwd"],
                             "quant_serving": launches_quant},
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
                             "snapshot": launches_snap,
                             "telemetry": launches_tel_ffc,
                             "cli": launches_cli["fused_fc"],
                             "train_library": launches_library,
                             "rest_serving": launches_rest,
                             "quant_serving": launches_quant_ffc},
        "ok": True},
        bwd_entry("dkv", 248), bwd_entry("dq", 309)] + [
        amp_entry(inst, kern) for inst in AMP_INSTANCES
        for kern in ("fwd", "dkv", "dq")]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

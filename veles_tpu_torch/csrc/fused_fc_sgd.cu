// Whole-epoch fused FC SGD for Hopper (sm_90a): one launch runs every
// minibatch step of one epoch of an L-layer chain
//     h_{l+1} = A * tanh(B * (h_l @ W_l + b_l))   (l < L-1)
//     logits  = h_{L-1} @ W_{L-1} + b_{L-1},  softmax cross-entropy
// with the Znicz SGD update
//     delta = lr * (g + wd * p) + momentum * delta_prev;  p -= delta
// (bias: lr * lr_bias_ratio and wd_bias), weights and both delta
// recurrences resident on chip for all K steps: read once at the start,
// written once at the end.
//
// Replaces the TPU kernel veles_tpu/ops/fused_fc.py::_kernel
// (pl.pallas_call in fused_fc_sgd_epoch); fused_fc_oracle there states
// the function. Differences from the TPU kernel, by design:
// - exact widths: no 128-lane / 8-sublane padding, no NEG lane bias;
// - the kernel gathers each minibatch's rows from the device dataset by
//   plan index (no host-side pre-gather of the epoch);
// - its size limit is this card's shared memory, not VMEM.
//
// One thread-block cluster runs the whole epoch, in one of two
// decompositions the wrapper chooses (ops/fused_fc.choose_geometry):
//
// Rows (namespace rows; 16 CTAs). Layer 0 carries nearly all the work
// (784 x 100 of MNIST's 79,400 multiply-adds a row), so it is split over
// its INPUT rows: the d_0 inputs fall into 8-row chunks (one mma k step)
// and CTA r owns chunks [r n / 16, (r + 1) n / 16) of the n (48 or 56 of
// MNIST's 784 rows): those rows of W_0 and of its delta recurrence, and
// the minibatch's columns of x for them. Later layers are small and
// replicated: every CTA keeps all of them and computes them identically.
// Per step:
//   prefetch  the next step's x columns are copied (cp.async, 16 bytes
//             where the rows allow) into the second of two buffers while
//             this step computes;
//   forward   layer 0: each CTA's partial x_r W_0r on the tensor cores;
//             cluster barrier; CTA r sums its stripe of the mb x d_1
//             pre-activation over the 16 partials in rank order, read
//             over distributed shared memory (DSMEM), adds the bias,
//             applies tanh; cluster barrier; every CTA copies all
//             stripes into its own H_1. Later layers, the softmax and
//             D_{L-1} = (p - y) / mb run in every CTA.
//   backward  layers L-1 .. 1 in every CTA (dW_l into the other of two
//             W_l buffers, since d_h still reads the pre-update W_l, then
//             D_{l-1} = (D_l W_l^T) * (A*B - (B/A) H^2) in place over H);
//             then dW_0 = x_r^T D_0 for the CTA's own rows, from the same
//             resident x tile the forward read, and their update.
// Two cluster barriers a step; the input is read once a step over the
// whole cluster.
//
// Columns (namespace columns; the first design, C = 8 or 16): CTA r owns
// output columns of every layer and streams each layer's input through
// 32-column tiles; each output's sums run over the inputs in order,
// whatever C is. It holds the chains whose replicated layers or whose
// mb x d_1 partial do not fit the row decomposition (e.g. 784-256-64-10
// at mb 100); f32 FMA on the CUDA cores.
//
// Every sum runs in one fixed order (no float atomics), so two launches
// give bit-identical weights; loss per step in f32, over the epoch in
// f64; errors by strict argmax, ties to the lowest class.
//
// Products (rows): 3xTF32 mma.sync (tf32x3.cuh) for layer 0's forward
// and dW and for the replicated layers' products (gemm below), each
// operand split into hi/lo as its fragment is loaded. Shared memory
// starts zeroed and every width and row count is padded with zeros, so
// the k loop reads without bounds checks. NaN is kept: A operands split
// with split(), and every value later read as a B operand (weights,
// D) is clean()ed where it is written. Row strides put the forward's
// fragment loads on 32 banks (ld_a, ld_b below).
//
// Bound: operations. One MNIST epoch (K 600, mb 100) needs 19.37 GFLOP
// (forward, dW, and d_h for layers past the first; the wrapper's
// epoch_work) and 189.9 MB of reads and writes: 0.289 ms at the
// card-wide 67 TFLOP/s f32 rate, 0.117 ms in 3xTF32 at 495/3 TFLOP/s.
// One cluster runs on 16 of the 132 SMs, so its own 3xTF32 ceiling is
// 132/16 of that (0.97 ms). What holds the rows design above it (a
// clock64() split of a step, PERF.md): the mma.sync issue of layer 0's
// products (112 x 104 x 56 and 56 x 104 x 104 a CTA), the replicated
// layer, which every CTA computes whole, and the DSMEM exchange and two
// cluster barriers a step.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace cg = cooperative_groups;

#define MAXL 8      // layers a launch takes
#define NT 256      // threads per CTA
#define NW (NT / 32)

struct FusedFcArgs {
  const float* dataset;        // (N, d_0)
  const int* labels;           // (N,)
  const int* plan;             // (steps, mb)
  const float* w_in[MAXL];     // (d_l, d_{l+1})
  const float* b_in[MAXL];     // (d_{l+1},)
  const float* vw_in[MAXL];
  const float* vb_in[MAXL];
  float* w_out[MAXL];
  float* b_out[MAXL];
  float* vw_out[MAXL];
  float* vb_out[MAXL];
  double* acc;                 // [loss_sum, err_count]
  int dims[MAXL + 1];
  int n_layers, steps, mb;
  float lr, act_a, act_b, lr_bias_ratio, wd, wd_bias, momentum;
};

namespace rows {

#define KC 8        // layer-0 input rows per chunk (one mma k step)
#define NCTA 16     // CTAs of the cluster
#define GATHER 12   // DSMEM loads a thread keeps in flight in the gather

__host__ __device__ inline int pad4(int n) { return (n + 3) / 4 * 4; }

// row stride of a width-w matrix read as an mma B operand (k = t,
// n = g) or as a transposed A operand: 8 or 24 mod 32 puts a fragment
// load on 32 banks
__host__ __device__ inline int ld_b(int w) {
  const int ld = (w + 7) / 8 * 8;
  return ld % 32 == 0 || ld % 32 == 16 ? ld + 8 : ld;
}

// row stride of the x tile, read as an A operand (m = g, k = t): an odd
// multiple of 4
__host__ __device__ inline int ld_a(int w) {
  const int ld = pad4(w);
  return ld % 8 == 0 ? ld + 4 : ld;
}

// first layer-0 input row of CTA r (r = NCTA: one past the last)
__host__ __device__ inline int cta_row(int r, int d0) {
  const int n_ch = (d0 + KC - 1) / KC;
  const int row = KC * (r * n_ch / NCTA);
  return row < d0 ? row : d0;
}

// float offsets into the dynamic shared memory, identical in every CTA
struct Layout {
  int rows, ldx, ld[MAXL + 1];
  int w0, v0, b[MAXL], vb[MAXL], w[MAXL][2], v[MAXL], act[MAXL + 1];
  int x[2], lab[2], stripe, stripe_len, red, total;
};

// the wrapper's ops/fused_fc.smem_bytes(..., "rows") is this, float for
// float: W_0 and V_0 for the CTA's rows (the most any CTA has, in whole
// chunks), every bias, both buffers of each later W and its V (rows to
// a multiple of 8), every activation and two x tiles (rows to a
// multiple of 16), two label rows, the CTA's stripe and the loss
// reduction. Everything starts zeroed, and the zeros past each width
// and row count stay: they are the K padding the products read.
__host__ __device__ inline void make_layout(const int* dims, int L, int mb,
                                            Layout& lo) {
  const int n_ch = (dims[0] + KC - 1) / KC;
  int rows = 0;
  for (int r = 0; r < NCTA; ++r) {
    const int n = KC * ((r + 1) * n_ch / NCTA - r * n_ch / NCTA);
    rows = n > rows ? n : rows;
  }
  lo.rows = rows;
  lo.ldx = ld_a(rows);
  for (int l = 1; l <= L; ++l) lo.ld[l] = ld_b(dims[l]);
  int off = 0;
  lo.w0 = off; off += rows * lo.ld[1];
  lo.v0 = off; off += rows * lo.ld[1];
  for (int l = 0; l < L; ++l) {
    lo.b[l] = off; off += pad4(dims[l + 1]);
    lo.vb[l] = off; off += pad4(dims[l + 1]);
  }
  for (int l = 1; l < L; ++l) {
    const int n = (dims[l] + 7) / 8 * 8 * lo.ld[l + 1];
    lo.w[l][0] = off; off += n;
    lo.w[l][1] = off; off += n;
    lo.v[l] = off; off += n;
  }
  const int mbp = (mb + 15) / 16 * 16;
  for (int l = 1; l <= L; ++l) {
    lo.act[l] = off; off += mbp * lo.ld[l];
  }
  lo.x[0] = off; off += mbp * lo.ldx;
  lo.x[1] = off; off += mbp * lo.ldx;
  lo.lab[0] = off; off += pad4(mb);
  lo.lab[1] = off; off += pad4(mb);
  lo.stripe_len = pad4((mb * lo.ld[1] + NCTA - 1) / NCTA);
  lo.stripe = off; off += lo.stripe_len;
  lo.red = off; off += 2 * NW;
  lo.total = off;
}

// a matrix in shared memory: element (i, j) at p[i * rs + j * cs]
struct Mat {
  const float* p;
  int rs, cs;
};

// out = A (M x K) B (K x N) on the tensor cores in 3xTF32; each result
// v at (m, n) goes to put(m, n, v, got(m, n)): the got() of a tile's
// four results are read before its first put() writes, so the reads
// are not held behind the writes. A warp job is a 16-row tile by NBT 8-column tiles;
// jobs go round robin over the warps. Each k step adds lo_a hi_b, then
// hi_a lo_b, then hi_a hi_b, pass by pass over the job's tiles, so a
// result depends only on its operands' order in k. Nothing is bounds-
// checked inside the loop: K is taken to the next multiple of 8 and
// the operands must hold zeros there; A is read up to the next multiple
// of 16 rows and B up to its last 8-column tile, and what those reach
// lands only in results put never sees. A's split keeps NaN; B's source
// holds no NaN that to_tf32 loses (clean() where it is written).
template <int NBT, typename Got, typename Put>
__device__ void gemm_tiles(Mat a, Mat b, int M, int N, int K, Got got,
                           Put put) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_jobs_n = (N + 8 * NBT - 1) / (8 * NBT);
  const int n_jobs = (M + 15) / 16 * n_jobs_n;
  const int last = (N - 1) / 8 * 8;     // the last tile's first column
  const int a8 = 8 * a.rs, a4 = 4 * a.cs, b4 = 4 * b.rs;
  for (int job = warp; job < n_jobs; job += NW) {
    const int m0 = job / n_jobs_n * 16, n0 = job % n_jobs_n * 8 * NBT;
    const float* pa = a.p + (m0 + g) * a.rs + t * a.cs;
    const float* pb = b.p + t * b.rs + g * b.cs;
    int col[NBT];
    float acc[NBT][4];
#pragma unroll
    for (int j = 0; j < NBT; ++j) {
      // a tile past N reads the last one again; its results are dropped
      col[j] = min(n0 + 8 * j, last) * b.cs;
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    }
#pragma unroll 2
    for (int k0 = 0; k0 < K; k0 += 8) {
      uint32_t ahi[4], alo[4], bhi[NBT][2], blo[NBT][2];
      tf32x3::split(pa[0], ahi[0], alo[0]);
      tf32x3::split(pa[a8], ahi[1], alo[1]);
      tf32x3::split(pa[a4], ahi[2], alo[2]);
      tf32x3::split(pa[a8 + a4], ahi[3], alo[3]);
#pragma unroll
      for (int j = 0; j < NBT; ++j) {
        tf32x3::split_clean(pb[col[j]], bhi[j][0], blo[j][0]);
        tf32x3::split_clean(pb[col[j] + b4], bhi[j][1], blo[j][1]);
      }
#pragma unroll
      for (int j = 0; j < NBT; ++j) tf32x3::mma(acc[j], alo, bhi[j]);
#pragma unroll
      for (int j = 0; j < NBT; ++j) tf32x3::mma(acc[j], ahi, blo[j]);
#pragma unroll
      for (int j = 0; j < NBT; ++j) tf32x3::mma(acc[j], ahi, bhi[j]);
      pa += 8 * a.cs;
      pb += 8 * b.rs;
    }
#pragma unroll
    for (int j = 0; j < NBT; ++j) {
      decltype(got(0, 0)) in[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + g + 8 * (e / 2), n = n0 + 8 * j + 2 * t + e % 2;
        if (m < M && n < N) in[e] = got(m, n);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + g + 8 * (e / 2), n = n0 + 8 * j + 2 * t + e % 2;
        if (m < M && n < N) put(m, n, acc[j][e], in[e]);
      }
    }
  }
}

// gemm_tiles with N's 8-column tiles shared evenly among the fewest jobs
// of at most 8 tiles
template <typename Got, typename Put>
__device__ void gemm(Mat a, Mat b, int M, int N, int K, Got got, Put put) {
  K = (K + 7) / 8 * 8;
  const int tiles = (N + 7) / 8, jobs = (tiles + 7) / 8;
  switch ((tiles + jobs - 1) / jobs) {
    case 1: gemm_tiles<1>(a, b, M, N, K, got, put); break;
    case 2: gemm_tiles<2>(a, b, M, N, K, got, put); break;
    case 3: gemm_tiles<3>(a, b, M, N, K, got, put); break;
    case 4: gemm_tiles<4>(a, b, M, N, K, got, put); break;
    case 5: gemm_tiles<5>(a, b, M, N, K, got, put); break;
    case 6: gemm_tiles<6>(a, b, M, N, K, got, put); break;
    case 7: gemm_tiles<7>(a, b, M, N, K, got, put); break;
    default: gemm_tiles<8>(a, b, M, N, K, got, put); break;
  }
}

// x tile[m][i] = dataset[plan_k[m]][i0 + i], i < n: 16-byte copies when
// the rows allow them (vec), else 4-byte ones; and lab[m] =
// labels[plan_k[m]]. Completes at a cp.async wait
__device__ void fetch_rows(float* xs, int* lab, const FusedFcArgs& a,
                           const int* plan_k, int i0, int n, int ldx,
                           bool vec) {
  const int d0 = a.dims[0];
  for (int m = threadIdx.x; m < a.mb; m += NT)
    tf32x3::copy4(lab + m, a.labels + plan_k[m]);
  if (vec) {
    const int per = n / 4;
    for (int idx = threadIdx.x; idx < a.mb * per; idx += NT) {
      const int m = idx / per, q = idx - m * per;
      tf32x3::copy16(xs + m * ldx + 4 * q,
                     a.dataset + (size_t)plan_k[m] * d0 + i0 + 4 * q);
    }
  } else {
    for (int idx = threadIdx.x; idx < a.mb * n; idx += NT) {
      const int m = idx / n, i = idx - m * n;
      tf32x3::copy4(xs + m * ldx + i,
                    a.dataset + (size_t)plan_k[m] * d0 + i0 + i);
    }
  }
  tf32x3::commit();
}

// the update's scalars, kept in registers
struct Sgd {
  float lr, wd, lr_b, wd_b, mu;
};

// the Znicz update of one weight (wv: its value and delta, read
// before) from its gradient, into w and v
__device__ __forceinline__ void step_weight(float* w, float* v, float2 wv,
                                            float g, Sgd s) {
  const float delta = s.lr * (g + s.wd * wv.x) + s.mu * wv.y;
  float q = wv.x - delta;
  tf32x3::clean(q);       // the next products read it as a B operand
  *w = q;
  *v = delta;
}

// db = sum over the minibatch rows of D, four threads a column: thread
// q of the quad sums the rows m = q mod 4 in order, the quad adds
// (q0 + q1) + (q2 + q3); then the update of the bias and its delta
// recurrence
__device__ void update_bias(float* b, float* vb, const float* D, int ld,
                            int n, int mb, Sgd s) {
  for (int base = 0; base < 4 * n; base += NT) {
    const int j = (base + threadIdx.x) / 4, q = threadIdx.x % 4;
    float g = 0.f;
    if (j < n)
      for (int m = q; m < mb; m += 4) g += D[m * ld + j];
    g += __shfl_xor_sync(0xffffffffu, g, 1);
    g += __shfl_xor_sync(0xffffffffu, g, 2);
    if (j < n && q == 0) {
      const float p = b[j];
      const float delta = s.lr_b * (g + s.wd_b * p) + s.mu * vb[j];
      b[j] = p - delta;
      vb[j] = delta;
    }
  }
}

__device__ __forceinline__ float4 add4(float4 x, float4 y) {
  return make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__global__ void __launch_bounds__(NT, 1) fused_fc_sgd_kernel(FusedFcArgs a) {
  extern __shared__ __align__(16) float sm_rows[];
  float* sm = sm_rows;
  cg::cluster_group cl = cg::this_cluster();
  const int r = (int)cl.block_rank();
  const int t = threadIdx.x, L = a.n_layers, mb = a.mb;
  const int* d = a.dims;
  Layout lo;
  make_layout(d, L, mb, lo);
  const int i0 = cta_row(r, d[0]);
  const int n_rows = cta_row(r + 1, d[0]) - i0;
  const int ld1 = lo.ld[1], n_el = mb * ld1;
  const bool vec = d[0] % 4 == 0
      && (reinterpret_cast<uintptr_t>(a.dataset) & 15) == 0;
  const float A = a.act_a, B = a.act_b;
  const Sgd sgd = {a.lr, a.wd, a.lr * a.lr_bias_ratio, a.wd_bias, a.momentum};
  const int ldx = lo.ldx;

  for (int i = 4 * t; i < lo.total; i += 4 * NT)
    *reinterpret_cast<float4*>(sm + i) = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  // the CTA's rows of W_0 and V_0; every other parameter whole. W is
  // read as a B operand: clean()
  for (int idx = t; idx < n_rows * d[1]; idx += NT) {
    const int i = idx / d[1], j = idx - i * d[1];
    const size_t at = (size_t)(i0 + i) * d[1] + j;
    float w = a.w_in[0][at];
    tf32x3::clean(w);
    sm[lo.w0 + i * ld1 + j] = w;
    sm[lo.v0 + i * ld1 + j] = a.vw_in[0][at];
  }
  for (int l = 0; l < L; ++l) {
    for (int j = t; j < d[l + 1]; j += NT) {
      sm[lo.b[l] + j] = a.b_in[l][j];
      sm[lo.vb[l] + j] = a.vb_in[l][j];
    }
    if (l == 0) continue;
    const int ld = lo.ld[l + 1];
    for (int idx = t; idx < d[l] * d[l + 1]; idx += NT) {
      const int i = idx / d[l + 1], j = idx - i * d[l + 1];
      float w = a.w_in[l][idx];
      tf32x3::clean(w);
      sm[lo.w[l][0] + i * ld + j] = w;
      sm[lo.v[l] + i * ld + j] = a.vw_in[l][idx];
    }
  }
  if (a.steps > 0)
    fetch_rows(sm + lo.x[0], reinterpret_cast<int*>(sm + lo.lab[0]), a,
               a.plan, i0, n_rows, ldx, vec);
  double loss_sum = 0.0;
  long long err_count = 0;

  for (int step = 0; step < a.steps; ++step) {
    const int* plan_k = a.plan + (size_t)step * mb;
    const int cur = step & 1;
    const float* X = sm + lo.x[cur];
    const int* lab = reinterpret_cast<const int*>(sm + lo.lab[cur]);
    if (step + 1 < a.steps) {
      fetch_rows(sm + lo.x[cur ^ 1],
                 reinterpret_cast<int*>(sm + lo.lab[cur ^ 1]), a,
                 plan_k + mb, i0, n_rows, ldx, vec);
      tf32x3::wait_all_but_last();
    } else {
      tf32x3::wait_all();
    }
    __syncthreads();

    // layer 0 forward: the CTA's partial over its rows
    float* P = sm + lo.act[1];
    gemm(Mat{X, ldx, 1}, Mat{sm + lo.w0, ld1, 1}, mb, d[1], n_rows,
         [](int, int) { return 0.f; },
         [=](int m, int n, float v, float) { P[m * ld1 + n] = v; });
    cl.sync();

    // CTA r's stripe of the pre-activation: the 16 partials summed in
    // rank order, then bias and tanh (none for a single-layer chain); pad
    // columns 0
    float* S = sm + lo.stripe;
    const int e0 = r * lo.stripe_len;
    const int e1 = min(e0 + lo.stripe_len, n_el);
    for (int e = e0 + 4 * t; e < e1; e += 4 * NT) {
      float4 s = load4(cl.map_shared_rank(P, 0) + e);
#pragma unroll
      for (int q = 1; q < NCTA; ++q)
        s = add4(s, load4(cl.map_shared_rank(P, q) + e));
      const int j = e % ld1;
      float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pre = v[c] + (j + c < d[1] ? sm[lo.b[0] + j + c] : 0.f);
        v[c] = j + c >= d[1] ? 0.f : L > 1 ? A * tanhf(B * pre) : pre;
      }
      *reinterpret_cast<float4*>(S + e - e0) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    cl.sync();

    // every stripe into this CTA's H_1 (no CTA reads P any more)
    for (int e = 4 * t; e < n_el; e += 4 * GATHER * NT) {
      float4 v[GATHER];
#pragma unroll
      for (int u = 0; u < GATHER; ++u) {
        const int f = e + 4 * NT * u, owner = f / lo.stripe_len;
        if (f < n_el)
          v[u] = load4(cl.map_shared_rank(S, owner) + f
                       - owner * lo.stripe_len);
      }
#pragma unroll
      for (int u = 0; u < GATHER; ++u) {
        const int f = e + 4 * NT * u;
        if (f < n_el) *reinterpret_cast<float4*>(P + f) = v[u];
      }
    }
    __syncthreads();

    // later layers, replicated
    for (int l = 1; l < L; ++l) {
      const float* H = sm + lo.act[l];
      const float* W = sm + lo.w[l][cur];
      const float* bl = sm + lo.b[l];
      float* O = sm + lo.act[l + 1];
      const int ldi = lo.ld[l], ldo = lo.ld[l + 1];
      const bool hidden = l < L - 1;
      gemm(Mat{H, ldi, 1}, Mat{W, ldo, 1}, mb, d[l + 1], d[l],
           [=](int m, int n) { return bl[n]; },
           [=](int m, int n, float v, float bias) {
             v += bias;
             O[m * ldo + n] = hidden ? A * tanhf(B * v) : v;
           });
      __syncthreads();
    }

    // softmax cross-entropy: D_{L-1} = (p - y) / mb in place over the
    // logits; CTA 0 sums the loss and the errors
    {
      float* Z = sm + lo.act[L];
      const int ld = lo.ld[L], nc = d[L];
      float part = 0.f;
      int wrong = 0;
      for (int m = t; m < mb; m += NT) {
        float* z = Z + m * ld;
        float mx = __int_as_float(0xff800000);  // -inf
        int pred = 0;
        for (int c = 0; c < nc; ++c)
          if (z[c] > mx) { mx = z[c]; pred = c; }
        float s = 0.f;
        for (int c = 0; c < nc; ++c) s += expf(z[c] - mx);
        const int label = lab[m];
        part += -(z[label] - mx - logf(s));
        wrong += pred != label;
        const float inv_s = 1.f / s, inv_mb = 1.f / mb;
        for (int c = 0; c < nc; ++c) {
          float dz = (expf(z[c] - mx) * inv_s - (c == label ? 1.f : 0.f))
                     * inv_mb;
          tf32x3::clean(dz);
          z[c] = dz;
        }
      }
      if (r == 0) {
        // a fixed tree: each warp's 32 partials by shuffles, then the
        // warps' sums in order
        for (int o = 16; o > 0; o /= 2) {
          part += __shfl_xor_sync(0xffffffffu, part, o);
          wrong += __shfl_xor_sync(0xffffffffu, wrong, o);
        }
        float* red = sm + lo.red;
        int* redi = reinterpret_cast<int*>(sm + lo.red + NW);
        if (t % 32 == 0) {
          red[t / 32] = part;
          redi[t / 32] = wrong;
        }
        __syncthreads();
        if (t == 0) {
          float total = 0.f;
          int errs = 0;
          for (int i = 0; i < NW; ++i) { total += red[i]; errs += redi[i]; }
          loss_sum += (double)total;
          err_count += errs;
        }
      }
      __syncthreads();
    }

    // later layers' backward, replicated
    for (int l = L - 1; l >= 1; --l) {
      float* H = sm + lo.act[l];
      const float* D = sm + lo.act[l + 1];
      const float* W = sm + lo.w[l][cur];
      float* Wn = sm + lo.w[l][cur ^ 1];
      float* V = sm + lo.v[l];
      const int ldi = lo.ld[l], ldo = lo.ld[l + 1];
      // dW_l = H^T D; the updated W_l goes to the other buffer
      gemm(Mat{H, 1, ldi}, Mat{D, ldo, 1}, d[l], d[l + 1], mb,
           [=](int i, int n) {
             return make_float2(W[i * ldo + n], V[i * ldo + n]);
           },
           [=](int i, int n, float g, float2 wv) {
             step_weight(Wn + i * ldo + n, V + i * ldo + n, wv, g, sgd);
           });
      update_bias(sm + lo.b[l], sm + lo.vb[l], D, ldo, d[l + 1], mb, sgd);
      __syncthreads();
      // D_{l-1} = (D W_l^T) * tanh'(H) from the pre-update W_l, in place
      gemm(Mat{D, ldo, 1}, Mat{W, 1, ldo}, mb, d[l], d[l + 1],
           [=](int m, int j) { return H[m * ldi + j]; },
           [=](int m, int j, float v, float h) {
             float dh = v * (A * B - (B / A) * h * h);
             tf32x3::clean(dh);
             H[m * ldi + j] = dh;
           });
      __syncthreads();
    }

    // layer 0: dW_0 = x_r^T D_0 for the CTA's rows, from the x tile the
    // forward read, and their update
    {
      const float* D = sm + lo.act[1];
      float* W0 = sm + lo.w0;
      float* V0 = sm + lo.v0;
      gemm(Mat{X, 1, ldx}, Mat{D, ld1, 1}, n_rows, d[1], mb,
           [=](int i, int n) {
             return make_float2(W0[i * ld1 + n], V0[i * ld1 + n]);
           },
           [=](int i, int n, float g, float2 wv) {
             step_weight(W0 + i * ld1 + n, V0 + i * ld1 + n, wv, g, sgd);
           });
      update_bias(sm + lo.b[0], sm + lo.vb[0], D, ld1, d[1], mb, sgd);
      __syncthreads();
    }
  }
  // no CTA leaves while another may still read its stripe
  cl.sync();

  for (int idx = t; idx < n_rows * d[1]; idx += NT) {
    const int i = idx / d[1], j = idx - i * d[1];
    const size_t at = (size_t)(i0 + i) * d[1] + j;
    a.w_out[0][at] = sm[lo.w0 + i * ld1 + j];
    a.vw_out[0][at] = sm[lo.v0 + i * ld1 + j];
  }
  if (r != 0) return;
  const int last = a.steps & 1;
  for (int l = 0; l < L; ++l) {
    for (int j = t; j < d[l + 1]; j += NT) {
      a.b_out[l][j] = sm[lo.b[l] + j];
      a.vb_out[l][j] = sm[lo.vb[l] + j];
    }
    if (l == 0) continue;
    const int ld = lo.ld[l + 1];
    for (int idx = t; idx < d[l] * d[l + 1]; idx += NT) {
      const int i = idx / d[l + 1], j = idx - i * d[l + 1];
      a.w_out[l][idx] = sm[lo.w[l][last] + i * ld + j];
      a.vw_out[l][idx] = sm[lo.v[l] + i * ld + j];
    }
  }
  if (t == 0) {
    a.acc[0] = loss_sum;
    a.acc[1] = (double)err_count;
  }
}

}  // namespace rows

// the decomposition by output columns (see the note at the top)
namespace columns {

#define TI 32       // input columns per streamed tile
#define OPT 8       // outputs a thread accumulates in registers
#define LU 16       // tile loads a thread keeps in flight

// float offsets into the dynamic shared memory, identical in every CTA
struct Layout {
  int own[MAXL];
  int w[MAXL], v[MAXL], b[MAXL], vb[MAXL], h[MAXL], d[MAXL];
  int tile_a, tile_b, red, total;
};

__host__ __device__ inline void make_layout(const int* dims, int L, int mb,
                                            int C, Layout& lo) {
  int off = 0, own_hidden = 1;
  for (int l = 0; l < L; ++l) {
    int own = (dims[l + 1] + C - 1) / C;
    lo.own[l] = own;
    if (l < L - 1 && own > own_hidden) own_hidden = own;
    lo.w[l] = off; off += dims[l] * own;
    lo.v[l] = off; off += dims[l] * own;
    lo.b[l] = off; off += own;
    lo.vb[l] = off; off += own;
  }
  for (int l = 0; l < L; ++l) {
    lo.h[l] = off; off += mb * lo.own[l];
    lo.d[l] = off; off += mb * lo.own[l];
  }
  lo.tile_a = off; off += mb * (TI + 1);
  lo.tile_b = off; off += TI * own_hidden;
  lo.red = off; off += 2 * NT;
  lo.total = off;
}

// columns of layer l that CTA r owns
__device__ inline int owned(const Layout& lo, const FusedFcArgs& a, int l,
                            int r) {
  int c = a.dims[l + 1] - r * lo.own[l];
  return c < 0 ? 0 : (c > lo.own[l] ? lo.own[l] : c);
}

// Fill tile[row][col] (row stride ld) for rows < n_rows, cols < TI
// from get(row, col). Each thread issues LU loads before it stores any,
// so LU global / DSMEM loads per thread are in flight at once: the
// tiles are latency-bound, not bandwidth-bound.
template <typename Get>
__device__ inline void fill_tile(float* tile, int n_rows, int ld, Get get) {
  const int n = n_rows * TI;
  for (int base = 0; base < n; base += NT * LU) {
    float v[LU];
#pragma unroll
    for (int u = 0; u < LU; ++u) {
      int idx = base + threadIdx.x + u * NT;
      v[u] = idx < n ? get(idx / TI, idx % TI) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < LU; ++u) {
      int idx = base + threadIdx.x + u * NT;
      if (idx < n) tile[(idx / TI) * ld + idx % TI] = v[u];
    }
  }
}

// tile_a[m][ii] = input column i0+ii of layer l for minibatch row m:
// the gathered dataset for l == 0, else layer l-1's activations read
// from their owners (zero past the input width)
__device__ void load_input_tile(float* sm, const Layout& lo,
                                const FusedFcArgs& a, cg::cluster_group& cl,
                                const int* rows, int l, int i0) {
  const int din = a.dims[l];
  if (l == 0) {
    fill_tile(sm + lo.tile_a, a.mb, TI + 1, [&](int m, int ii) {
      int i = i0 + ii;
      return i < din ? a.dataset[(size_t)rows[m] * din + i] : 0.f;
    });
  } else {
    const int own = lo.own[l - 1];
    float* src = sm + lo.h[l - 1];
    fill_tile(sm + lo.tile_a, a.mb, TI + 1, [&](int m, int ii) {
      int i = i0 + ii, rr = i / own;
      return i < din ? cl.map_shared_rank(src, rr)[m * own + i - rr * own]
                     : 0.f;
    });
  }
}

// tile_a[m][kk] = D_l column k0+kk from its owner (zero past d_{l+1})
__device__ void load_grad_tile(float* sm, const Layout& lo,
                               const FusedFcArgs& a, cg::cluster_group& cl,
                               int l, int k0) {
  const int dout = a.dims[l + 1], own = lo.own[l];
  float* src = sm + lo.d[l];
  fill_tile(sm + lo.tile_a, a.mb, TI + 1, [&](int m, int kk) {
    int k = k0 + kk, rr = k / own;
    return k < dout ? cl.map_shared_rank(src, rr)[m * own + k - rr * own]
                    : 0.f;
  });
}

// tile_b[kk][j] = W_l[r*own_{l-1} + j][k0 + kk] from the owner of the
// column: the rows of W_l this CTA's D_{l-1} columns need. Filled as
// its transpose view: get(j, kk) into tile_b[kk * own_{l-1} + j].
__device__ void load_weight_tile(float* sm, const Layout& lo,
                                 const FusedFcArgs& a, cg::cluster_group& cl,
                                 int l, int r, int cnt_prev, int k0) {
  const int dout = a.dims[l + 1], own = lo.own[l], own_p = lo.own[l - 1];
  float* src = sm + lo.w[l];
  float* tile = sm + lo.tile_b;
  const int n = cnt_prev * TI;
  for (int base = 0; base < n; base += NT * LU) {
    float v[LU];
#pragma unroll
    for (int u = 0; u < LU; ++u) {
      int idx = base + threadIdx.x + u * NT;
      int j = idx / TI, k = k0 + idx % TI, rr = k / own;
      v[u] = idx < n && k < dout
          ? cl.map_shared_rank(src, rr)[(r * own_p + j) * own + k - rr * own]
          : 0.f;
    }
#pragma unroll
    for (int u = 0; u < LU; ++u) {
      int idx = base + threadIdx.x + u * NT;
      if (idx < n) tile[(idx % TI) * own_p + idx / TI] = v[u];
    }
  }
}

// Row-by-column products out[m][j] = sum_k A[m][k] * B[k][j] over the
// CTA's `cnt` columns; A streams through tile_a, B is the CTA's own
// W_l (forward) or the remote-weight tile (gradient). mode 0: hidden
// forward, 1: logits, 2: D_{l-1} = grad * tanh'.
__device__ void products(float* sm, const Layout& lo, const FusedFcArgs& a,
                         cg::cluster_group& cl, const int* rows, int l,
                         int r, int cnt, int mode) {
  const int t = threadIdx.x, mb = a.mb;
  const bool fwd = mode != 2;
  const int depth = fwd ? a.dims[l] : a.dims[l + 1];
  const int ld_out = fwd ? lo.own[l] : lo.own[l - 1];
  const float* tile = sm + lo.tile_a;
  const int n_out = mb * cnt;
  for (int base = 0; base < n_out; base += NT * OPT) {
    const int kc = min(OPT, (n_out - base + NT - 1) / NT);
    float acc[OPT];
    int arow[OPT], col[OPT];
#pragma unroll
    for (int k = 0; k < OPT; ++k) {
      int o = base + t + k * NT;
      bool ok = k < kc && o < n_out;
      arow[k] = ok ? (o / cnt) * (TI + 1) : 0;
      col[k] = ok ? o % cnt : 0;
      acc[k] = 0.f;
    }
    for (int i0 = 0; i0 < depth; i0 += TI) {
      __syncthreads();
      if (fwd) {
        load_input_tile(sm, lo, a, cl, rows, l, i0);
      } else {
        load_grad_tile(sm, lo, a, cl, l, i0);
        load_weight_tile(sm, lo, a, cl, l, r, cnt, i0);
      }
      __syncthreads();
      const float* bm = fwd ? sm + lo.w[l] + i0 * lo.own[l] : sm + lo.tile_b;
      const int ldb = fwd ? lo.own[l] : lo.own[l - 1];
      const int kmax = min(TI, depth - i0);
      for (int ii = 0; ii < kmax; ++ii) {
#pragma unroll
        for (int k = 0; k < OPT; ++k)
          if (k < kc)
            acc[k] = fmaf(tile[arow[k] + ii], bm[ii * ldb + col[k]], acc[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < OPT; ++k) {
      int o = base + t + k * NT;
      if (k >= kc || o >= n_out) continue;
      int m = o / cnt, j = col[k];
      if (mode == 0) {
        float pre = acc[k] + sm[lo.b[l] + j];
        sm[lo.h[l] + m * ld_out + j] = a.act_a * tanhf(a.act_b * pre);
      } else if (mode == 1) {
        sm[lo.h[l] + m * ld_out + j] = acc[k] + sm[lo.b[l] + j];
      } else {
        float h = sm[lo.h[l - 1] + m * ld_out + j];
        float deriv = a.act_a * a.act_b - (a.act_b / a.act_a) * h * h;
        sm[lo.d[l - 1] + m * ld_out + j] = acc[k] * deriv;
      }
    }
  }
}

// softmax cross-entropy of the step: D_{L-1} for the CTA's classes;
// CTA 0 returns the step's loss sum and error count through *loss/*err
// (thread 0)
__device__ void softmax_grad(float* sm, const Layout& lo,
                             const FusedFcArgs& a, cg::cluster_group& cl,
                             const int* rows, int r, float* loss, int* err) {
  const int L = a.n_layers, l = L - 1, nc = a.dims[L], own = lo.own[l];
  const int cnt = owned(lo, a, l, r), mb = a.mb;
  if (cnt == 0 && r != 0) return;
  float part = 0.f;
  int wrong = 0;
  for (int m = threadIdx.x; m < mb; m += NT) {
    float mx = __int_as_float(0xff800000);  // -inf
    int pred = 0;
    for (int c = 0; c < nc; ++c) {
      int rr = c / own;
      float v = cl.map_shared_rank(sm + lo.h[l], rr)[m * own + c - rr * own];
      if (v > mx) { mx = v; pred = c; }
    }
    float s = 0.f;
    for (int c = 0; c < nc; ++c) {
      int rr = c / own;
      s += expf(cl.map_shared_rank(sm + lo.h[l], rr)[m * own + c - rr * own]
                - mx);
    }
    const int label = a.labels[rows[m]];
    for (int j = 0; j < cnt; ++j) {
      int c = r * own + j;
      float p = expf(sm[lo.h[l] + m * own + j] - mx) / s;
      sm[lo.d[l] + m * own + j] = (p - (c == label ? 1.f : 0.f)) / mb;
    }
    if (r == 0) {
      int rr = label / own;
      float zl = cl.map_shared_rank(sm + lo.h[l], rr)[m * own + label
                                                      - rr * own];
      part += -(zl - mx - logf(s));
      wrong += pred != label;
    }
  }
  if (r == 0) {
    float* red = sm + lo.red;
    int* redi = reinterpret_cast<int*>(sm + lo.red + NT);
    red[threadIdx.x] = part;
    redi[threadIdx.x] = wrong;
    __syncthreads();
    if (threadIdx.x == 0) {
      float total = 0.f;
      int errs = 0;
      for (int i = 0; i < NT; ++i) { total += red[i]; errs += redi[i]; }
      *loss = total;
      *err = errs;
    }
  }
}

// dW_l = H_{l-1}^T D_l and db_l = sum_m D_l, then the Znicz update of the
// CTA's columns of W_l, b_l and their delta recurrences
__device__ void update(float* sm, const Layout& lo, const FusedFcArgs& a,
                       cg::cluster_group& cl, const int* rows, int l,
                       int cnt) {
  if (cnt == 0) return;
  const int t = threadIdx.x, mb = a.mb, own = lo.own[l], din = a.dims[l];
  const float* dl = sm + lo.d[l];
  const float lr_b = a.lr * a.lr_bias_ratio;
  for (int j = t; j < cnt; j += NT) {
    float g = 0.f;
    for (int m = 0; m < mb; ++m) g += dl[m * own + j];
    float p = sm[lo.b[l] + j];
    float delta = lr_b * (g + a.wd_bias * p) + a.momentum * sm[lo.vb[l] + j];
    sm[lo.b[l] + j] = p - delta;
    sm[lo.vb[l] + j] = delta;
  }
  const float* tile = sm + lo.tile_a;
  for (int i0 = 0; i0 < din; i0 += TI) {
    __syncthreads();
    load_input_tile(sm, lo, a, cl, rows, l, i0);
    __syncthreads();
    const int kmax = min(TI, din - i0);
    for (int o = t; o < kmax * cnt; o += NT) {
      int ii = o / cnt, j = o - ii * cnt, i = i0 + ii;
      float g = 0.f;
      for (int m = 0; m < mb; ++m)
        g = fmaf(tile[m * (TI + 1) + ii], dl[m * own + j], g);
      float* w = sm + lo.w[l] + i * own + j;
      float* v = sm + lo.v[l] + i * own + j;
      float p = *w;
      float delta = a.lr * (g + a.wd * p) + a.momentum * *v;
      *w = p - delta;
      *v = delta;
    }
  }
}

__global__ void __launch_bounds__(NT, 1) fused_fc_sgd_kernel(FusedFcArgs a) {
  extern __shared__ float sm[];
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), r = (int)cl.block_rank();
  const int t = threadIdx.x, L = a.n_layers;
  Layout lo;
  make_layout(a.dims, L, a.mb, C, lo);

  // load the CTA's columns of the state
  for (int l = 0; l < L; ++l) {
    const int own = lo.own[l], cnt = owned(lo, a, l, r), c0 = r * own;
    const int din = a.dims[l], dout = a.dims[l + 1];
    for (int idx = t; idx < din * cnt; idx += NT) {
      int i = idx / cnt, j = idx - i * cnt;
      sm[lo.w[l] + i * own + j] = a.w_in[l][(size_t)i * dout + c0 + j];
      sm[lo.v[l] + i * own + j] = a.vw_in[l][(size_t)i * dout + c0 + j];
    }
    for (int j = t; j < cnt; j += NT) {
      sm[lo.b[l] + j] = a.b_in[l][c0 + j];
      sm[lo.vb[l] + j] = a.vb_in[l][c0 + j];
    }
  }
  double loss_sum = 0.0;
  long long err_count = 0;
  cl.sync();

  for (int step = 0; step < a.steps; ++step) {
    const int* rows = a.plan + (size_t)step * a.mb;
    for (int l = 0; l < L; ++l) {
      products(sm, lo, a, cl, rows, l, r, owned(lo, a, l, r),
               l < L - 1 ? 0 : 1);
      cl.sync();
    }
    float step_loss = 0.f;
    int step_err = 0;
    softmax_grad(sm, lo, a, cl, rows, r, &step_loss, &step_err);
    if (r == 0 && t == 0) {
      loss_sum += (double)step_loss;
      err_count += step_err;
    }
    cl.sync();
    for (int l = L - 1; l >= 0; --l) {
      if (l > 0) {
        // D_{l-1} from the pre-update W_l, before anyone updates it
        products(sm, lo, a, cl, rows, l, r, owned(lo, a, l - 1, r), 2);
        cl.sync();
      }
      update(sm, lo, a, cl, rows, l, owned(lo, a, l, r));
    }
    // the next step's forward overwrites H, which others may still read
    cl.sync();
  }

  for (int l = 0; l < L; ++l) {
    const int own = lo.own[l], cnt = owned(lo, a, l, r), c0 = r * own;
    const int din = a.dims[l], dout = a.dims[l + 1];
    for (int idx = t; idx < din * cnt; idx += NT) {
      int i = idx / cnt, j = idx - i * cnt;
      a.w_out[l][(size_t)i * dout + c0 + j] = sm[lo.w[l] + i * own + j];
      a.vw_out[l][(size_t)i * dout + c0 + j] = sm[lo.v[l] + i * own + j];
    }
    for (int j = t; j < cnt; j += NT) {
      a.b_out[l][c0 + j] = sm[lo.b[l] + j];
      a.vb_out[l][c0 + j] = sm[lo.vb[l] + j];
    }
  }
  if (r == 0 && t == 0) {
    a.acc[0] = loss_sum;
    a.acc[1] = (double)err_count;
  }
}

}  // namespace columns

extern "C" {

// launch one epoch on `stream` in the row (layout 0, cluster 16) or
// column (layout 1, cluster 1..16) decomposition; returns a cudaError_t
// (0 = launched). A cluster the card cannot hold is refused
// (cudaErrorLaunchOutOfResources) before the launch.
int veles_fused_fc_sgd_epoch_f32(const FusedFcArgs* args, int cluster,
                                 int layout, void* stream) {
  const bool by_rows = layout == 0;
  if (args->n_layers < 1 || args->n_layers > MAXL || layout < 0
      || layout > 1 || cluster < 1 || cluster > 16
      || (by_rows && cluster != NCTA))
    return (int)cudaErrorInvalidValue;
  int floats;
  if (by_rows) {
    rows::Layout lo;
    rows::make_layout(args->dims, args->n_layers, args->mb, lo);
    floats = lo.total;
  } else {
    columns::Layout lo;
    columns::make_layout(args->dims, args->n_layers, args->mb, cluster, lo);
    floats = lo.total;
  }
  const int smem = floats * (int)sizeof(float);
  void (*kernel)(FusedFcArgs) = by_rows ? rows::fused_fc_sgd_kernel
                                        : columns::fused_fc_sgd_kernel;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (cluster > 8) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  e = cudaLaunchKernelEx(&cfg, kernel, *args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"

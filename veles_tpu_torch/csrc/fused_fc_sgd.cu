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
// - its size limit is this card's shared memory (below), not VMEM.
//
// Decomposition. One thread-block cluster of C CTAs (C = 8, or 16 with
// the non-portable cluster size) runs the whole epoch; C is chosen by
// the wrapper. CTA r owns, for every layer l, the output columns
// [r*own_l, r*own_l + cnt) with own_l = ceil(d_{l+1} / C): those
// columns of W_l, b_l and of both delta recurrences live in its shared
// memory, as do its columns of every layer's activations H_l and
// output gradient D_l for the current minibatch. Per step:
//   forward   layer l: a (mb x d_l) input streamed in 32-column tiles —
//             the dataset rows (gathered by plan index, global memory /
//             L2) for l = 0, the other CTAs' H_{l-1} columns through
//             distributed shared memory (DSMEM) after — times the CTA's
//             own W_l columns; cluster barrier.
//   softmax   every CTA reads a row's logits from their owners, writes
//             D_{L-1} = (p - y) / mb for its own classes; CTA 0 sums
//             the cross-entropy and the errors (strict argmax, ties to
//             the lowest class). Cluster barrier.
//   backward  layer l = L-1 .. 0: for l > 0, the CTA's columns of
//             D_{l-1} = (D_l · W_l^T) * (A*B - (B/A) * H_{l-1}^2), with
//             D_l and the rows of W_l it needs read from their owners
//             over DSMEM while W_l is still the pre-update W_l; cluster
//             barrier; then dW_l = H_{l-1}^T D_l (the input streamed
//             again) and the update of its own columns.
//   cluster barrier before the next step overwrites H.
// Every sum runs in one fixed order (over the input index, the class,
// the minibatch row; no float atomics), so results do not depend on C
// and two launches give bit-identical weights.
//
// Shared memory per CTA (floats; make_layout below; the wrapper's
// ops/fused_fc.smem_bytes is the same formula): per layer
// 2*d_l*own_l + 2*own_l (W, V, b, vb) + 2*mb*own_l (H, D), plus the
// input tile mb*33, the remote-W tile 32*max hidden own and 2*256 for
// the loss reduction. MNIST 784-100-10, mb 100, C 8: 112,168 bytes of
// the 232,448 a CTA may use; a chain is eligible while the C = 16
// footprint fits.
//
// Bound: operations. One MNIST epoch (K 600, mb 100) needs 19.37 GFLOP
// of f32 FMA (forward, dW, and d_h for layers past the first; the
// wrapper's epoch_work) and 189.9 MB of reads and writes; at the
// card-wide 67 TFLOP/s f32 peak that is 0.289 ms, but one cluster runs
// on C of the 132 SMs, so its own ceiling is C/132 of that rate
// (4.77 ms at C = 8).
// This first version is plain f32 FMA on the CUDA cores, no tensor
// cores, no TMA; the inner products read both operands from shared
// memory, which caps it well below even the cluster's ceiling.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define MAXL 8      // layers a launch takes
#define NT 256      // threads per CTA
#define TI 32       // input columns per streamed tile
#define OPT 8       // outputs a thread accumulates in registers
#define LU 16       // tile loads a thread keeps in flight

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

extern "C" {

// launch one epoch on `stream`; returns a cudaError_t (0 = launched)
int veles_fused_fc_sgd_epoch_f32(const FusedFcArgs* args, int cluster,
                                 void* stream) {
  if (args->n_layers < 1 || args->n_layers > MAXL || cluster < 1
      || cluster > 16)
    return (int)cudaErrorInvalidValue;
  Layout lo;
  make_layout(args->dims, args->n_layers, args->mb, cluster, lo);
  const int smem = lo.total * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      fused_fc_sgd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (cluster > 8) {
    e = cudaFuncSetAttribute(fused_fc_sgd_kernel,
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
  e = cudaLaunchKernelEx(&cfg, fused_fc_sgd_kernel, *args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"

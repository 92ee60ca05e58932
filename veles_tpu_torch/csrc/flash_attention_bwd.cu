// Flash-attention backward for Hopper (sm_90a), float32: dK/dV and dQ.
//
// Replaces the TPU kernel pair of veles_tpu/ops/flash_attention.py:
// _bwd_dkv_kernel and _bwd_dq_kernel (reached through _bwd_pallas_core
// from the custom VJP _flash_bwd and from flash_attention_bwd_lse).
// Given q, k, v, the upstream gradient do, the forward's per-row
// log-sum-exp lse and delta = rowsum(do * o), both kernels recompute the
// probabilities blockwise, p = exp(scale * q k^T - lse), so the (T, T)
// matrices never reach device memory:
//   dv = p^T do,  dp = do v^T,  ds = p * (dp - delta) * scale,
//   dk = ds^T q,  dq = ds k.
//
// What bounds it on this card. At the training slice's shape (B=16,
// T=512, H=8, Dh=64, causal; 131,328 live (q, k) pairs per head) the
// dK/dV kernel needs 8*Dh FLOP per live pair (s, dv, dp, dk), 8.6 GFLOP,
// and the dQ kernel 6*Dh (s, dp, dq), 6.5 GFLOP: 0.128 ms and 0.096 ms at
// the 67 TFLOP/s float32 FMA peak, against about 0.03 ms each to move
// their ~100 MB and ~84 MB at 3.35 TB/s. So both are compute-bound, and
// as in the forward the practical ceiling is the shared-memory operand
// traffic that feeds the FMA units (about one 4-byte load per two FMAs).
// The two-kernel split (the reference's) recomputes s and dp in each
// kernel: 14*Dh FLOP per pair where the function alone needs 10*Dh.
//
// The design, the simple one first:
//   - dK/dV: one CTA of 256 threads per (batch*kv head, K/V tile). The
//     K_j and V_j tiles stay in shared memory, the dK_j and dV_j
//     accumulators in registers. A loop inside the CTA takes the place
//     of the TPU kernel's sequential grid dimension: it walks (query head
//     of the group, q tile) in a fixed order, so a kv head sums its whole
//     group's contributions without atomics and two launches on the
//     same inputs give the same bits;
//   - dQ: one CTA per (batch*head, Q tile), looping over the live K/V
//     tiles; grouped K/V are read by index (query head h reads kv head
//     h / (H / KV), the mapping of _kv_fold_of), never expanded;
//   - the loop bounds come from the forward's liveness predicate
//     (_block_live): a tile pair with no unmasked score is never loaded.
//     Inside a live pair the causal, sliding-window (q - k < window) and
//     ragged-edge (q, k < T) masks apply per element, so any T is taken
//     and Dh is never padded in memory;
//   - register tiles: each thread holds an R x R block of the score tile
//     and an R x (DMAX/16) block of each accumulator; shared-memory rows
//     are padded by one word so the 16 lanes of a row group hit 16 banks;
//   - q, k, v, do and the gradients are read and written through their
//     (B, T, heads, Dh) strides; lse and delta are flat (B*H, T).
// A later design moves the products onto the tensor cores (wgmma on
// TF32 or bf16 operands fed by TMA) and fuses the two kernels into one
// pass, which removes the recomputed s and dp.
//
// C interface: veles_flash_attention_bwd_dkv_f32(...) and
// veles_flash_attention_bwd_dq_f32(...) launch on the given stream and
// return cudaGetLastError() (0 on success). They allocate nothing and do
// not synchronise.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;  // 16 row groups x 16 column groups

template <int DMAX>
struct Cfg {
  static constexpr int TILE = DMAX <= 128 ? 64 : 32;  // q and k/v rows
  static constexpr int R = TILE / 16;   // tile rows (score columns) a thread holds
  static constexpr int DC = DMAX / 16;  // head-dim columns a thread holds
  static constexpr int XS = DMAX + 1;   // q/do/k/v tile row stride
  static constexpr int PS = TILE + 1;   // score tile row stride
  static constexpr size_t dkv_bytes =
      sizeof(float) * (4 * TILE * XS + 2 * TILE * PS + 2 * TILE);
  static constexpr size_t dq_bytes =
      sizeof(float) * (4 * TILE * XS + TILE * PS + 2 * TILE);
};

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;    // (B*H, T)
  const float* delta;  // (B*H, T)
  float* dq;
  float* dk;
  float* dv;
  int T, H, KV, D;
  // element strides (batch, time, head) of q, k, v, do, dq, dk, dv
  long long sq[3], sk[3], sv[3], sdo[3], sdq[3], sdk[3], sdv[3];
  float scale;
  int causal, window;
};

__device__ __forceinline__ bool live(int qi, int kj, int T, int causal,
                                     int window) {
  bool keep = qi < T && kj < T;
  if (causal) keep = keep && kj <= qi;
  if (window > 0) keep = keep && (qi - kj < window);
  return keep;
}

// rows t0 .. t0+TILE-1 of one head into a padded shared tile; rows past
// T and columns past D are zero, not stale (0 * NaN would poison a sum)
template <int DMAX>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long st, int t0, int T,
                                          int D) {
  using C = Cfg<DMAX>;
  for (int idx = threadIdx.x; idx < C::TILE * DMAX; idx += THREADS) {
    const int r = idx / DMAX, d = idx - (idx / DMAX) * DMAX;
    const int t = t0 + r;
    dst[r * C::XS + d] = (t < T && d < D) ? src[t * st + d] : 0.f;
  }
}

template <int DMAX>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int t0, int T) {
  using C = Cfg<DMAX>;
  for (int r = threadIdx.x; r < C::TILE; r += THREADS)
    dst[r] = t0 + r < T ? src[t0 + r] : 0.f;
}

// p and ds of one (q tile, k tile) pair. Thread (ty, tx) computes the
// rows ty + 16*i of the q tile against the rows tx + 16*j of the k tile:
// s = q k^T and dp = do v^T in one pass over the head dim, then the
// masks, p = exp(s * scale - lse) and ds = p * (dp - delta) * scale.
template <int DMAX>
__device__ __forceinline__ void pair_grads(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* lse_s, const float* delta_s, float* ps, float* dss,
    int q0, int k0, const Args& a) {
  using C = Cfg<DMAX>;
  constexpr int R = C::R;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[R][R], dp[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < a.D; ++d) {
    float qv[R], dov[R], kv[R], vv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      qv[i] = qs[(ty + 16 * i) * C::XS + d];
      dov[i] = dos[(ty + 16 * i) * C::XS + d];
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      kv[j] = ks[(tx + 16 * j) * C::XS + d];
      vv[j] = vs[(tx + 16 * j) * C::XS + d];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
    const float l = lse_s[r], dl = delta_s[r];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int c = tx + 16 * j;
      const float p = live(q0 + r, k0 + c, a.T, a.causal, a.window)
                          ? expf(s[i][j] * a.scale - l)
                          : 0.f;
      if (ps != nullptr) ps[r * C::PS + c] = p;
      dss[r * C::PS + c] = p * (dp[i][j] - dl) * a.scale;
    }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const Args a) {
  using C = Cfg<DMAX>;
  constexpr int TILE = C::TILE, R = C::R, DC = C::DC;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + TILE * C::XS;
  float* qs = vs + TILE * C::XS;
  float* dos = qs + TILE * C::XS;
  float* ps = dos + TILE * C::XS;
  float* dss = ps + TILE * C::PS;
  float* lse_s = dss + TILE * C::PS;
  float* delta_s = lse_s + TILE;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * TILE;
  const int bk = blockIdx.y;  // batch * KV + kv head
  const int b = bk / a.KV;
  const int kvh = bk - b * a.KV;
  const int group = a.H / a.KV;
  const int T = a.T;

  load_tile<DMAX>(ks, a.k + b * a.sk[0] + kvh * a.sk[2], a.sk[1], k0, T,
                  a.D);
  load_tile<DMAX>(vs, a.v + b * a.sv[0] + kvh * a.sv[2], a.sv[1], k0, T,
                  a.D);

  float dk[R][DC], dv[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;

  // the q tiles with a live score against this k tile (_block_live)
  const int q_lo = a.causal ? k0 : 0;
  const int q_hi = a.window > 0 ? min(T, k0 + TILE - 1 + a.window) : T;

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const float* qb = a.q + b * a.sq[0] + h * a.sq[2];
    const float* dob = a.dout + b * a.sdo[0] + h * a.sdo[2];
    const long long row = ((long long)b * a.H + h) * T;
    for (int q0 = q_lo; q0 < q_hi; q0 += TILE) {
      __syncthreads();  // the previous pair's tile reads are done
      load_tile<DMAX>(qs, qb, a.sq[1], q0, T, a.D);
      load_tile<DMAX>(dos, dob, a.sdo[1], q0, T, a.D);
      load_rows<DMAX>(lse_s, a.lse + row, q0, T);
      load_rows<DMAX>(delta_s, a.delta + row, q0, T);
      __syncthreads();
      pair_grads<DMAX>(qs, dos, ks, vs, lse_s, delta_s, ps, dss, q0, k0, a);
      __syncthreads();
      // dv += p^T do and dk += ds^T q over the q rows of this tile; this
      // thread's k rows are ty + 16*i, its head-dim columns tx + 16*c
      const int qn = min(TILE, T - q0);
      for (int qq = 0; qq < qn; ++qq) {
        float pv[R], dsv[R], dov[DC], qv[DC];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pv[i] = ps[qq * C::PS + ty + 16 * i];
          dsv[i] = dss[qq * C::PS + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dov[c] = dos[qq * C::XS + tx + 16 * c];
          qv[c] = qs[qq * C::XS + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            dv[i][c] = fmaf(pv[i], dov[c], dv[i][c]);
            dk[i][c] = fmaf(dsv[i], qv[c], dk[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= T) continue;
    float* dkrow = a.dk + b * a.sdk[0] + kj * a.sdk[1] + kvh * a.sdk[2];
    float* dvrow = a.dv + b * a.sdv[0] + kj * a.sdv[1] + kvh * a.sdv[2];
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < a.D) {
        dkrow[d] = dk[i][c];
        dvrow[d] = dv[i][c];
      }
    }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const Args a) {
  using C = Cfg<DMAX>;
  constexpr int TILE = C::TILE, R = C::R, DC = C::DC;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + TILE * C::XS;
  float* ks = dos + TILE * C::XS;
  float* vs = ks + TILE * C::XS;
  float* dss = vs + TILE * C::XS;
  float* lse_s = dss + TILE * C::PS;
  float* delta_s = lse_s + TILE;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * TILE;
  const int bh = blockIdx.y;  // batch * H + head
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int kvh = h / (a.H / a.KV);
  const int T = a.T;
  const long long row = (long long)bh * T;

  load_tile<DMAX>(qs, a.q + b * a.sq[0] + h * a.sq[2], a.sq[1], q0, T, a.D);
  load_tile<DMAX>(dos, a.dout + b * a.sdo[0] + h * a.sdo[2], a.sdo[1], q0,
                  T, a.D);
  load_rows<DMAX>(lse_s, a.lse + row, q0, T);
  load_rows<DMAX>(delta_s, a.delta + row, q0, T);
  const float* kb = a.k + b * a.sk[0] + kvh * a.sk[2];
  const float* vb = a.v + b * a.sv[0] + kvh * a.sv[2];

  float acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  // the K/V range any row of this q tile can see (the forward's bounds)
  const int q_last = min(q0 + TILE, T) - 1;
  const int k_hi = a.causal ? q_last + 1 : T;
  const int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;

  for (int k0 = k_lo; k0 < k_hi; k0 += TILE) {
    __syncthreads();  // the previous step's K and dS reads are done
    load_tile<DMAX>(ks, kb, a.sk[1], k0, T, a.D);
    load_tile<DMAX>(vs, vb, a.sv[1], k0, T, a.D);
    __syncthreads();
    pair_grads<DMAX>(qs, dos, ks, vs, lse_s, delta_s, nullptr, dss, q0, k0,
                     a);
    __syncthreads();
    // dq += ds k: this thread's q rows are ty + 16*i, its head-dim
    // columns tx + 16*c
    const int kn = min(TILE, k_hi - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float dsv[R], kv[DC];
#pragma unroll
      for (int i = 0; i < R; ++i) dsv[i] = dss[(ty + 16 * i) * C::PS + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = ks[kk * C::XS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= T) continue;
    float* dqrow = a.dq + b * a.sdq[0] + qi * a.sdq[1] + h * a.sdq[2];
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < a.D) dqrow[d] = acc[i][c];
    }
  }
}

template <int DMAX>
cudaError_t launch_dkv(const Args& a, int B, cudaStream_t stream) {
  using C = Cfg<DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::dkv_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + C::TILE - 1) / C::TILE, B * a.KV);
  flash_bwd_dkv_kernel<DMAX><<<grid, THREADS, C::dkv_bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_dq(const Args& a, int B, cudaStream_t stream) {
  using C = Cfg<DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::dq_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + C::TILE - 1) / C::TILE, B * a.H);
  flash_bwd_dq_kernel<DMAX><<<grid, THREADS, C::dq_bytes, stream>>>(a);
  return cudaGetLastError();
}

bool valid(int B, int T, int H, int KV, int D) {
  return B >= 1 && T >= 1 && KV >= 1 && H % KV == 0 && D >= 1 && D <= 256 &&
         B * H <= 65535;
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dq, void* dk,
               void* dv, int T, int H, int KV, int D, const long long* st,
               float scale, int causal, int window) {
  Args a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.dout = static_cast<const float*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.T = T;
  a.H = H;
  a.KV = KV;
  a.D = D;
  long long* dst[7] = {a.sq, a.sk, a.sv, a.sdo, a.sdq, a.sdk, a.sdv};
  for (int i = 0; i < 7; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = st[3 * i + j];
  a.scale = scale;
  a.causal = causal;
  a.window = window;
  return a;
}

}  // namespace

// strides: 21 element strides (batch, time, head) of q, k, v, do, dq, dk
// and dv, in that order; the head-dim stride of each must be 1. lse and
// delta are contiguous (B*H, T) float32.
extern "C" int veles_flash_attention_bwd_dkv_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int T,
    int H, int KV, int D, const long long* strides, float scale, int causal,
    int window, void* stream) {
  if (!valid(B, T, H, KV, D)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, dout, lse, delta, nullptr, dk, dv, T, H,
                           KV, D, strides, scale, causal, window);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) return (int)launch_dkv<32>(a, B, s);
  if (D <= 64) return (int)launch_dkv<64>(a, B, s);
  if (D <= 128) return (int)launch_dkv<128>(a, B, s);
  return (int)launch_dkv<256>(a, B, s);
}

extern "C" int veles_flash_attention_bwd_dq_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int T, int H,
    int KV, int D, const long long* strides, float scale, int causal,
    int window, void* stream) {
  if (!valid(B, T, H, KV, D)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, dout, lse, delta, dq, nullptr, nullptr, T,
                           H, KV, D, strides, scale, causal, window);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) return (int)launch_dq<32>(a, B, s);
  if (D <= 64) return (int)launch_dq<64>(a, B, s);
  if (D <= 128) return (int)launch_dq<128>(a, B, s);
  return (int)launch_dq<256>(a, B, s);
}

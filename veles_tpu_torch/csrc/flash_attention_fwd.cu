// Flash-attention forward for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel veles_tpu/ops/flash_attention.py::_kernel
// (reached through _fwd_pallas / flash_attention): online-softmax
// attention o = softmax(scale * q k^T + mask) v, plus the per-row
// log-sum-exp, without materialising the (T, T) score matrix.
//
// What bounds it on this card. At the serving slice's prefill shapes
// (B=4, T=512, H=8, Dh=64, causal) the work is 4*B*H*T*(T/2)*Dh, about
// 1.07 GFLOP: about 16 us at the 67 TFLOP/s float32 FMA peak of the CUDA
// cores, against about 5 us to move q, k, v and o (16.8 MB) at
// 3.35 TB/s. So the kernel is compute-bound, and its design aims at
// feeding the FMA units:
//   - one CTA of 256 threads per (64-row q tile, batch*head); a loop
//     inside the CTA walks the K/V tiles of 64 rows (the TPU kernel's
//     sequential grid dimension);
//   - the loop bounds come from the causal and sliding-window
//     predicates (the counterpart of _block_live), so a K/V tile with no
//     unmasked score is never loaded; inside a live tile the causal,
//     window (q - k < window, the Mistral convention) and ragged-edge
//     (k < T) masks apply per element, so any T is accepted and D is
//     never padded in memory;
//   - register tiles: each thread holds a 4x4 block of the score tile
//     and a 4 x (DMAX/16) block of the output accumulator, so every
//     value read from shared memory feeds 4 FMAs;
//   - GQA: query head h reads kv head h / (H / KV) (the mapping of
//     _kv_fold_of); K/V are never expanded;
//   - q, k, v and o are read and written in their (B, T, H, Dh) layout
//     through strides; lse is written flat as (B*H, T).
// The shared-memory operands still cost about two bytes per FMA, so
// shared-memory bandwidth, not the FMA units, is the practical ceiling.
// A later design changes the bound by moving the two products onto the
// tensor cores (wgmma on bf16 or TF32 operands, TMA tile loads into a
// ring of shared-memory stages, warp-specialised producer and
// consumers), at which point HBM traffic and the softmax's exp become
// the limits.
//
// C interface: veles_flash_attention_fwd_f32(...) launches on the given
// stream and returns cudaGetLastError() (0 on success). It allocates
// nothing and does not synchronise.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // q rows per CTA
constexpr int BK = 64;        // k/v rows per loop step
constexpr int THREADS = 256;  // 16 row groups x 16 column groups
constexpr float NEG_INF = -1e30f;

template <int DMAX>
struct Layout {
  static constexpr int QS = DMAX;      // q tile row stride
  static constexpr int KS = DMAX + 1;  // k tile row stride: the score
                                       // loop walks 16 k rows at once,
                                       // the pad puts them on 16 banks
  static constexpr int VS = DMAX;      // v tile row stride
  static constexpr int PS = BK + 1;    // probability tile row stride
  static constexpr size_t bytes =
      sizeof(float) * (BQ * QS + BK * KS + BK * VS + BQ * PS);
};

__device__ __forceinline__ bool live(int qi, int kj, int T, int causal,
                                     int window) {
  bool keep = kj < T;
  if (causal) keep = keep && kj <= qi;
  if (window > 0) keep = keep && (qi - kj < window);
  return keep;
}

template <int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int T, int H, int KV, int D,
                 long long sqb, long long sqt, long long sqh,
                 long long skb, long long skt, long long skh,
                 long long svb, long long svt, long long svh,
                 long long sob, long long sot, long long soh,
                 float scale, int causal, int window) {
  using L = Layout<DMAX>;
  constexpr int DC = DMAX / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + BQ * L::QS;
  float* vs = ks + BK * L::KS;
  float* ps = vs + BK * L::VS;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // columns tx + 16*j of the score tile
  const int ty = tid >> 4;  // rows ty + 16*i; one row group = 16 lanes
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KV);

  const float* qb = q + b * sqb + h * sqh;
  const float* kb = k + b * skb + kvh * skh;
  const float* vb = v + b * svb + kvh * svh;

  for (int idx = tid; idx < BQ * DMAX; idx += THREADS) {
    const int r = idx / DMAX, d = idx - (idx / DMAX) * DMAX;
    const int t = q0 + r;
    qs[r * L::QS + d] = (t < T && d < D) ? qb[t * sqt + d] : 0.f;
  }

  // dead-tile skip: the K/V range any row of this q tile can see
  const int q_last = min(q0 + BQ, T) - 1;
  const int k_hi = causal ? q_last + 1 : T;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  float m_i[4], l_i[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous step's K/V/P reads are done
    for (int idx = tid; idx < BK * DMAX; idx += THREADS) {
      const int r = idx / DMAX, d = idx - (idx / DMAX) * DMAX;
      const int t = k0 + r;
      const bool in = t < T && d < D;
      // rows past T are zero, not stale: their probability is 0 and
      // 0 * NaN would poison the accumulator
      ks[r * L::KS + d] = in ? kb[t * skt + d] : 0.f;
      vs[r * L::VS + d] = in ? vb[t * svt + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * L::QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * L::KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        s[i][j] = live(qi, kj, T, causal, window) ? s[i][j] * scale
                                                  : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 lanes of a row group hold one row between them
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const float p =
            live(qi, kj, T, causal, window) ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        ps[(ty + 16 * i) * L::PS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();  // a row group's P row is written by its own 16 lanes

    const int kn = min(BK, k_hi - k0);
    for (int c = 0; c < kn; ++c) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * L::PS + c];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) vv[cc] = vs[c * L::VS + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < DC; ++cc)
          acc[i][cc] = fmaf(pv[i], vv[cc], acc[i][cc]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= T) continue;
    const float l = fmaxf(l_i[i], 1e-30f);
    float* orow = o + b * sob + qi * sot + h * soh;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) {
      const int d = tx + 16 * cc;
      if (d < D) orow[d] = acc[i][cc] / l;
    }
    if (tx == 0) lse[(long long)bh * T + qi] = m_i[i] + logf(l);
  }
}

template <int DMAX>
cudaError_t launch(const float* q, const float* k, const float* v,
                   float* o, float* lse, int B, int T, int H, int KV,
                   int D, const long long* st, float scale, int causal,
                   int window, cudaStream_t stream) {
  const size_t smem = Layout<DMAX>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<DMAX><<<grid, THREADS, smem, stream>>>(
      q, k, v, o, lse, T, H, KV, D, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale, causal,
      window);
  return cudaGetLastError();
}

}  // namespace

// strides: 12 element strides (batch, time, head) of q, k, v and o, in
// that order; the head-dim stride of each must be 1.
extern "C" int veles_flash_attention_fwd_f32(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int B, int T, int H, int KV, int D, const long long* strides,
    float scale, int causal, int window, void* stream) {
  if (B < 1 || T < 1 || KV < 1 || H % KV != 0 || D < 1 || D > 256 ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    return (int)launch<32>(qf, kf, vf, of, lf, B, T, H, KV, D, strides,
                           scale, causal, window, s);
  if (D <= 64)
    return (int)launch<64>(qf, kf, vf, of, lf, B, T, H, KV, D, strides,
                           scale, causal, window, s);
  if (D <= 128)
    return (int)launch<128>(qf, kf, vf, of, lf, B, T, H, KV, D, strides,
                            scale, causal, window, s);
  return (int)launch<256>(qf, kf, vf, of, lf, B, T, H, KV, D, strides,
                          scale, causal, window, s);
}

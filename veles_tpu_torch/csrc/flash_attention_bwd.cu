// Flash-attention backward for Hopper (sm_90a): dK/dV and dQ, in float32,
// bf16 and the mixed operands of mixed precision.
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
// What bounds it on this card. Per live (q, k) pair the dK/dV kernel
// needs 8*Dh FLOP (s, dp, dv, dk) and the dQ kernel 6*Dh (s, dp, dq):
// the two-kernel split (the reference's) recomputes s and dp. At the
// training slice's shape (B=16, T=512, H=8, Dh=64, causal; 131,328 live
// pairs per head) that is 8.61 and 6.46 GFLOP against ~101 and ~84 MB of
// HBM traffic (0.030 and 0.025 ms at 3.35 TB/s), so both kernels are
// bound by operations: 0.128 and 0.096 ms at the CUDA cores' 67 TFLOP/s
// of float32 FMA, 0.052 and 0.039 ms on the tensor cores in 3xTF32
// (three TF32 products a product at 495 TFLOP/s). The products run on
// the tensor cores, so the second pair of bounds is the one that holds.
// One TF32 product would be three times cheaper but misses the port's
// 1e-4 float32 tolerance (tests/test_torch_tf32.py), so every product
// is 3xTF32 (tf32x3.cuh): float32-grade.
//
// The design, and what it does about the limits of the CUDA-core kernel
// it replaces (scalar FMAs fed one shared-memory word per two FMAs,
// synchronous tile copies with a barrier on each side, 100-166 KB of
// shared memory a CTA):
//   - all five products (s = q k^T, dp = do v^T, dv += p^T do,
//     dk += ds^T q, dq += ds k) are mma.sync m16n8k8 TF32 triples, issued
//     pass by pass over all of a warp's accumulators so that no mma waits
//     on the one before it; the masks, p = 2^(s scale log2 e - lse log2 e)
//     and p * (dp - delta) * scale stay float32 on the CUDA cores;
//   - one CTA of 4 warps holds a 64-row resident tile (K and V for dK/dV,
//     q and do for dQ), 16 rows a warp, with the accumulators in mma C
//     fragments. dK/dV computes s^T = k q^T and dp^T = v do^T, so p^T and
//     ds^T come out as C fragments of the warp's own k rows and feed dv
//     and dk as A operands in registers (tf32x3.cuh's column order); dQ
//     does the same with s = q k^T. No score tile goes through shared
//     memory;
//   - the streamed tiles (q, do, lse, delta for dK/dV; k, v for dQ) go
//     through a two-stage ring of cp.async copies (16 bytes where the
//     source row allows it, 4 bytes elsewhere): the next tile is in
//     flight while the current one computes. Each thread splits the
//     chunks it copied into hi and lo TF32 planes once they land, so a
//     streamed element is split once a step, not once per warp and
//     product, and one barrier a stage publishes the planes. The resident
//     tile stays float32 (half the shared memory of planes) and is split
//     as its A fragments are loaded, once per 4 n tiles;
//   - rows are Dp + 4 floats (Dp: D rounded up to the variant's 32, 64,
//     128 or 256, zero-filled past D, never padded in device memory), so
//     every fragment load of a warp hits 32 distinct banks. A CTA takes
//     ~55 KB (D <= 32), ~105 KB (D <= 64, 32 streamed rows a step) or
//     ~101 KB (D <= 128, 16 rows), so two or more share an SM; D <= 256
//     takes ~200 KB, streams 8 rows and splits the gradient's columns
//     over two CTAs (blockIdx.z), each recomputing s and dp, so that no
//     variant spills;
//   - the loop bounds come from the forward's liveness predicate
//     (_block_live): a tile pair with no unmasked score is never loaded,
//     a warp whose 16 rows are all masked against the current tile skips
//     its products, and a warp whose rows are all unmasked skips the
//     per-element masks. Elsewhere the causal, sliding-window (q - k <
//     window) and ragged-edge (q, k < T) masks apply per element, so any
//     T is taken;
//   - under causal masking the first k tiles see the most q tiles (and
//     the last q tiles the most k tiles): the flat grid index is
//     tile * pairs + (batch, head) pair, with the tiles longest first,
//     so the short CTAs fill the card's tail;
//   - dK/dV walks (query head of the group, q tile) in a fixed order
//     inside one CTA, the TPU kernel's sequential grid dimension: a kv
//     head sums its whole group without atomics, and two launches on the
//     same inputs give the same bits. dQ reads grouped K/V by index
//     (query head h reads kv head h / (H / KV), _kv_fold_of);
//   - q, k, v, do and the gradients are read and written through their
//     (B, T, heads, Dh) strides; lse and delta are flat (B*H, T).
//
// Operand types. As the forward, the kernels are templated on the type
// of q, k and do (TQ: do has o's type, which is q's) and of v (TV), float32
// or bf16: four instances. Each product takes its operands as the
// reference's kernels give them: p is cast to do's type before dv += p^T
// do, ds to q's type before dk += ds^T q and to k's type before dq += ds
// k, and s = q k^T and dp = do v^T take their inputs as they are. Where
// both operands are bf16 a product is one bf16 mma.sync.m16n8k16 with
// float32 accumulation (bf16_mma.cuh), p and ds rounded to bf16 in
// registers as they are packed; where one is float32 it is 3xTF32, a bf16
// operand widened exactly as it loads and its zero lo part's product
// skipped (dp = do v^T when do and v differ). The masks, p and ds stay
// float32; lse, delta and the gradients are float32 (the wrapper casts
// the gradients to their inputs' types).
//
// C interface: veles_flash_attention_bwd_dkv_<qk>_<v>(...) and
// veles_flash_attention_bwd_dq_<qk>_<v>(...), <qk> and <v> each f32 or
// bf16, launch on the given stream and return cudaGetLastError() (0 on
// success). They allocate nothing and do not synchronise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "flash_tiles.cuh"
#include "tf32x3.cuh"

namespace {

using namespace flash;
using bf16mma::bf16;
using bf16mma::is_bf16;

// DS: head-dim columns the s and dp products run over (D zero-filled up
// to it in shared memory); DA: gradient columns one CTA accumulates;
// RS: rows of the streamed tiles a step. The resident x and w (K and V
// for dK/dV, q and do for dQ; types TX, TW) are row-major tiles kept as
// they land (a float32 one cleaned of NaN and split as each fragment is
// loaded); the streamed y and z (q and do, or K and V; types TY, TZ) are
// a hi and a lo TF32 plane each in float32, split once a step by the
// threads that copied them, or one bf16 plane. Rows are row_stride
// values (flash_tiles.cuh). Sizes in bytes
template <int DS_, int DA_, int RS_, class TX_, class TW_, class TY_,
          class TZ_>
struct Cfg {
  using TX = TX_;
  using TW = TW_;
  using TY = TY_;
  using TZ = TZ_;
  static constexpr int DS = DS_, DA = DA_, RS = RS_;
  static constexpr int LX = row_stride<TX>(DS), LW = row_stride<TW>(DS);
  static constexpr int LY = row_stride<TY>(DS), LZ = row_stride<TZ>(DS);
  static constexpr int NS = RS / 8;  // n tiles of s and dp a warp holds
  static constexpr int NA = DA / 8;  // n tiles of an accumulator
  static constexpr int YP = RS * LY, ZP = RS * LZ;  // planes, in values
  static constexpr int XB = ROWS * LX * (int)sizeof(TX);
  static constexpr int RES = XB + ROWS * LW * (int)sizeof(TW);
  static constexpr int YB = (is_bf16<TY>::value ? 1 : 2) * YP * (int)sizeof(TY);
  static constexpr int ZB = (is_bf16<TZ>::value ? 1 : 2) * ZP * (int)sizeof(TZ);
  // a stage: y, z, then the two row vectors (lse and delta)
  static constexpr int STAGE = YB + ZB + 2 * RS * (int)sizeof(float);
  static constexpr int G = NA < 4 ? NA : 4;  // accumulator tiles a pass
  static constexpr size_t bytes = RES + 2 * STAGE;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
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

// row values t0 .. t0+R-1 of a flat (B*H, T) row, zeros past T
template <int R>
__device__ __forceinline__ void copy_row(float* dst, const float* src,
                                         int t0, int T) {
  for (int r = threadIdx.x; r < R; r += THREADS) {
    if (t0 + r < T)
      tf32x3::copy4(dst + r, src + t0 + r);
    else
      dst[r] = 0.f;
  }
}

// the landed stage's float32 planes split, and the resident float32 tiles
// cleaned with the first stage: each thread passes over its own chunks
template <class C>
__device__ __forceinline__ void prepare_stage(unsigned char* res,
                                              unsigned char* st, bool first) {
  if constexpr (!is_bf16<typename C::TX>::value)
    if (first) clean_tile<ROWS, C::DS, C::LX>(reinterpret_cast<float*>(res));
  if constexpr (!is_bf16<typename C::TW>::value)
    if (first)
      clean_tile<ROWS, C::DS, C::LW>(reinterpret_cast<float*>(res + C::XB));
  if constexpr (!is_bf16<typename C::TY>::value)
    split_tile<C::RS, C::DS, C::LY, C::YP>(reinterpret_cast<float*>(st));
  if constexpr (!is_bf16<typename C::TZ>::value)
    split_tile<C::RS, C::DS, C::LZ, C::ZP>(
        reinterpret_cast<float*>(st + C::YB));
}

// s = x y^T and dp = w z^T of a warp's 16 resident rows (r0, r0 + 8 of
// each lane) against the RS streamed rows, over DS columns (zeros past D)
template <class C>
__device__ __forceinline__ void scores(const unsigned char* res,
                                       const unsigned char* st, int r0,
                                       float (&s)[C::NS][4],
                                       float (&dp)[C::NS][4]) {
#pragma unroll
  for (int j = 0; j < C::NS; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
  using TX = typename C::TX;
  using TW = typename C::TW;
  using TY = typename C::TY;
  using TZ = typename C::TZ;
  rows_product2<C::NS, C::DS, RowsStep<C::NS, TX, C::LX, TY, C::LY, C::YP>,
                RowsStep<C::NS, TW, C::LW, TZ, C::LZ, C::ZP>>(
      s, reinterpret_cast<const TX*>(res), reinterpret_cast<const TY*>(st),
      dp, reinterpret_cast<const TW*>(res + C::XB),
      reinterpret_cast<const TZ*>(st + C::YB), r0);
}

// p and ds of the dK/dV kernel in place of s^T and dp^T: element (j, i)
// is k row kj0 + 8 (i / 2) against streamed q column 8 j + 2 t +
// (i % 2); lse_s holds lse * log2(e), so p = 2^(s scale log2(e) - that);
// MASK applies the per-element masks
template <class C, bool MASK>
__device__ __forceinline__ void probs_dkv(float (&s)[C::NS][4],
                                          float (&dp)[C::NS][4],
                                          const float* lse_s,
                                          const float* delta_s, int q0,
                                          int kj0, const Args& a) {
  const int t = threadIdx.x & 3;
  const float scale_log2 = a.scale * LOG2E;
#pragma unroll
  for (int j = 0; j < C::NS; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qc = 8 * j + 2 * t + (i & 1);
      const bool keep = !MASK || live(q0 + qc, kj0 + 8 * (i >> 1), a);
      const float p = keep ? exp2_approx(s[j][i] * scale_log2 - lse_s[qc])
                           : 0.f;
      s[j][i] = p;
      dp[j][i] = p * (dp[j][i] - delta_s[qc]) * a.scale;
    }
}

// ds of the dQ kernel in place of dp: element (j, i) is q row qi0 +
// 8 (i / 2) against streamed k column kt + 8 j + 2 t + (i % 2); lse
// holds lse * log2(e)
template <class C, bool MASK>
__device__ __forceinline__ void probs_dq(const float (&s)[C::NS][4],
                                         float (&dp)[C::NS][4],
                                         const float (&lse)[2],
                                         const float (&delta)[2], int qi0,
                                         int kt, const Args& a) {
  const int t = threadIdx.x & 3;
  const float scale_log2 = a.scale * LOG2E;
#pragma unroll
  for (int j = 0; j < C::NS; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i >> 1;
      const bool keep =
          !MASK || live(qi0 + 8 * r, kt + 8 * j + 2 * t + (i & 1), a);
      const float p = keep ? exp2_approx(s[j][i] * scale_log2 - lse[r])
                           : 0.f;
      dp[j][i] = p * (dp[j][i] - delta[r]) * a.scale;
    }
}

// C: x = K, w = V, y = q, z = do
template <class C>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const Args a) {
  using TQ = typename C::TY;
  using TV = typename C::TW;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem + C::RES;

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  // all (batch, kv head) pairs of one k tile are launched together, the
  // first tiles first: under causal they see the most q tiles, and the
  // short ones that come last fill the card's tail
  const int pairs = gridDim.x / ((a.T + ROWS - 1) / ROWS);
  const int tile = blockIdx.x / pairs;
  const int bk = blockIdx.x - tile * pairs;  // batch * KV + kv head
  const int k0 = tile * ROWS;
  const int b = bk / a.KV;
  const int kvh = bk - b * a.KV;
  const int c0 = blockIdx.z * C::DA;  // this CTA's gradient columns
  const int group = a.H / a.KV;
  const int T = a.T, D = a.D;
  const int r0 = 16 * warp + g;  // this lane's k rows: r0, r0 + 8

  copy_tile<ROWS, C::DS, C::LX>(
      reinterpret_cast<TQ*>(smem),
      static_cast<const TQ*>(a.k) + b * a.sk[0] + kvh * a.sk[2], a.sk[1], k0,
      T, D);
  copy_tile<ROWS, C::DS, C::LW>(
      reinterpret_cast<TV*>(smem + C::XB),
      static_cast<const TV*>(a.v) + b * a.sv[0] + kvh * a.sv[2], a.sv[1], k0,
      T, D);

  // the q tiles with a live score against this k tile (_block_live),
  // for each query head of the group in turn
  const int q_lo = a.causal ? k0 : 0;
  const int q_hi = a.window > 0 ? min(T, k0 + ROWS - 1 + a.window) : T;
  const int nq = (q_hi - q_lo + C::RS - 1) / C::RS;
  const int steps = group * nq;

  // the streamed q, do, lse and delta of step it, into stage it % 2
  auto issue = [&](int it) {
    const int gi = it / nq;
    const int q0 = q_lo + (it - gi * nq) * C::RS;
    const int h = kvh * group + gi;
    const long long row = ((long long)b * a.H + h) * T;
    unsigned char* st = ring + (it & 1) * C::STAGE;
    copy_tile<C::RS, C::DS, C::LY>(
        reinterpret_cast<TQ*>(st),
        static_cast<const TQ*>(a.q) + b * a.sq[0] + h * a.sq[2], a.sq[1], q0,
        T, D);
    copy_tile<C::RS, C::DS, C::LZ>(
        reinterpret_cast<TQ*>(st + C::YB),
        static_cast<const TQ*>(a.dout) + b * a.sdo[0] + h * a.sdo[2],
        a.sdo[1], q0, T, D);
    float* rows = reinterpret_cast<float*>(st + C::YB + C::ZB);
    copy_row<C::RS>(rows, a.lse + row, q0, T);
    copy_row<C::RS>(rows + C::RS, a.delta + row, q0, T);
    tf32x3::commit();
  };

  float dk[C::NA][4], dv[C::NA][4];
#pragma unroll
  for (int n = 0; n < C::NA; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;

  if (steps > 0) issue(0);
  for (int it = 0; it < steps; ++it) {
    // this thread's copies of step it have landed: it splits its own
    // chunks into the hi/lo planes and scales its own lse values; one
    // barrier then publishes the stage, and every warp is done with step
    // it - 1, whose stage the next copies overwrite
    tf32x3::wait_all();
    unsigned char* st = ring + (it & 1) * C::STAGE;
    prepare_stage<C>(smem, st, it == 0);  // K and V landed with stage 0
    float* lse_s = reinterpret_cast<float*>(st + C::YB + C::ZB);
    for (int r = threadIdx.x; r < C::RS; r += THREADS) lse_s[r] *= LOG2E;
    __syncthreads();
    if (it + 1 < steps) issue(it + 1);

    const int gi = it / nq;
    const int q0 = q_lo + (it - gi * nq) * C::RS;
    const int kw = k0 + 16 * warp;  // this warp's k rows kw .. kw + 15
    if (!block_live(q0, q0 + C::RS - 1, kw, kw + 15, a)) continue;

    // s^T = k q^T and dp^T = v do^T: rows are this warp's k rows,
    // columns the step's q rows; then p^T and ds^T in their place
    float s[C::NS][4], dp[C::NS][4];
    scores<C>(smem, st, r0, s, dp);
    if (block_full(q0, q0 + C::RS - 1, kw, kw + 15, a))
      probs_dkv<C, false>(s, dp, lse_s, lse_s + C::RS, q0, k0 + r0, a);
    else
      probs_dkv<C, true>(s, dp, lse_s, lse_s + C::RS, q0, k0 + r0, a);

    // dv += p^T do (p in do's type), dk += ds^T q (ds in q's type) over
    // the step's q rows
    frag_product<C::NS, C::NA, C::G, TQ, C::LZ, C::ZP>(
        dv, s, reinterpret_cast<const TQ*>(st + C::YB) + c0);
    frag_product<C::NS, C::NA, C::G, TQ, C::LY, C::YP>(
        dk, dp, reinterpret_cast<const TQ*>(st) + c0);
  }

  const int t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + r0 + 8 * (i >> 1);
    if (kj >= T) continue;
    float* dkrow = a.dk + b * a.sdk[0] + kj * a.sdk[1] + kvh * a.sdk[2];
    float* dvrow = a.dv + b * a.sdv[0] + kj * a.sdv[1] + kvh * a.sdv[2];
#pragma unroll
    for (int n = 0; n < C::NA; ++n) {
      const int d = c0 + 8 * n + 2 * t + (i & 1);
      if (d < D) {
        dkrow[d] = dk[n][i];
        dvrow[d] = dv[n][i];
      }
    }
  }
}

// C: x = q, w = do, y = K, z = V
template <class C>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const Args a) {
  using TQ = typename C::TX;
  using TV = typename C::TZ;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem + C::RES;

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  // all (batch, head) pairs of one q tile are launched together, the last
  // tiles first: under causal they see the most K/V tiles
  const int tiles = (a.T + ROWS - 1) / ROWS;
  const int pairs = gridDim.x / tiles;
  const int tile = blockIdx.x / pairs;
  const int bh = blockIdx.x - tile * pairs;  // batch * H + head
  const int q0 = (tiles - 1 - tile) * ROWS;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int kvh = h / (a.H / a.KV);
  const int c0 = blockIdx.z * C::DA;
  const int T = a.T, D = a.D;
  const int r0 = 16 * warp + g;  // this lane's q rows: r0, r0 + 8
  const long long row = (long long)bh * T;

  copy_tile<ROWS, C::DS, C::LX>(
      reinterpret_cast<TQ*>(smem),
      static_cast<const TQ*>(a.q) + b * a.sq[0] + h * a.sq[2], a.sq[1], q0,
      T, D);
  copy_tile<ROWS, C::DS, C::LW>(
      reinterpret_cast<TQ*>(smem + C::XB),
      static_cast<const TQ*>(a.dout) + b * a.sdo[0] + h * a.sdo[2], a.sdo[1],
      q0, T, D);
  float lse[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + 8 * i;
    lse[i] = qi < T ? a.lse[row + qi] * LOG2E : 0.f;
    delta[i] = qi < T ? a.delta[row + qi] : 0.f;
  }
  const TQ* kb = static_cast<const TQ*>(a.k) + b * a.sk[0] + kvh * a.sk[2];
  const TV* vb = static_cast<const TV*>(a.v) + b * a.sv[0] + kvh * a.sv[2];

  // the K/V range any row of this q tile can see (the forward's bounds)
  const int q_last = min(q0 + ROWS, T) - 1;
  const int k_hi = a.causal ? q_last + 1 : T;
  const int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int steps = (k_hi - k_lo + C::RS - 1) / C::RS;

  // the streamed k and v of step it, into stage it % 2
  auto issue = [&](int it) {
    const int kt = k_lo + it * C::RS;
    unsigned char* st = ring + (it & 1) * C::STAGE;
    copy_tile<C::RS, C::DS, C::LY>(reinterpret_cast<TQ*>(st), kb, a.sk[1],
                                   kt, T, D);
    copy_tile<C::RS, C::DS, C::LZ>(reinterpret_cast<TV*>(st + C::YB), vb,
                                   a.sv[1], kt, T, D);
    tf32x3::commit();
  };

  float acc[C::NA][4];
#pragma unroll
  for (int n = 0; n < C::NA; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  if (steps > 0) issue(0);
  for (int it = 0; it < steps; ++it) {
    tf32x3::wait_all();  // as in the dK/dV kernel: one barrier a stage
    unsigned char* st = ring + (it & 1) * C::STAGE;
    prepare_stage<C>(smem, st, it == 0);
    __syncthreads();
    if (it + 1 < steps) issue(it + 1);

    const int kt = k_lo + it * C::RS;
    const int qw = q0 + 16 * warp;  // this warp's q rows qw .. qw + 15
    if (!block_live(qw, qw + 15, kt, kt + C::RS - 1, a)) continue;

    // s = q k^T and dp = do v^T: rows are this warp's q rows; then ds in
    // dp's place
    float s[C::NS][4], dp[C::NS][4];
    scores<C>(smem, st, r0, s, dp);
    if (block_full(qw, qw + 15, kt, kt + C::RS - 1, a))
      probs_dq<C, false>(s, dp, lse, delta, q0 + r0, kt, a);
    else
      probs_dq<C, true>(s, dp, lse, delta, q0 + r0, kt, a);

    // dq += ds k (ds in k's type) over the step's k rows
    frag_product<C::NS, C::NA, C::G, TQ, C::LY, C::YP>(
        acc, dp, reinterpret_cast<const TQ*>(st) + c0);
  }

  const int t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + r0 + 8 * (i >> 1);
    if (qi >= T) continue;
    float* dqrow = a.dq + b * a.sdq[0] + qi * a.sdq[1] + h * a.sdq[2];
#pragma unroll
    for (int n = 0; n < C::NA; ++n) {
      const int d = c0 + 8 * n + 2 * t + (i & 1);
      if (d < D) dqrow[d] = acc[n][i];
    }
  }
}

template <class C>
cudaError_t launch_dkv(const Args& a, int B, cudaStream_t stream) {
  const cudaError_t err = prepare(
      reinterpret_cast<const void*>(flash_bwd_dkv_kernel<C>), C::bytes);
  if (err != cudaSuccess) return err;
  const int tiles = (a.T + ROWS - 1) / ROWS, z = (a.D + C::DA - 1) / C::DA;
  const dim3 grid(tiles * B * a.KV, 1, z);
  flash_bwd_dkv_kernel<C><<<grid, THREADS, C::bytes, stream>>>(a);
  return cudaGetLastError();
}

template <class C>
cudaError_t launch_dq(const Args& a, int B, cudaStream_t stream) {
  const cudaError_t err = prepare(
      reinterpret_cast<const void*>(flash_bwd_dq_kernel<C>), C::bytes);
  if (err != cudaSuccess) return err;
  const int tiles = (a.T + ROWS - 1) / ROWS, z = (a.D + C::DA - 1) / C::DA;
  const dim3 grid(tiles * B * a.H, 1, z);
  flash_bwd_dq_kernel<C><<<grid, THREADS, C::bytes, stream>>>(a);
  return cudaGetLastError();
}

// the variant for head dim D: (DS, DA, RS). In float32 a CTA takes ~55 KB
// (D <= 32), ~105 KB (D <= 64), ~101 KB (D <= 128, 16 streamed rows a
// step) or ~200 KB (D <= 256, 8 streamed rows, and the gradient's columns
// split over two CTAs so that the accumulators fit in registers); a bf16
// tile takes about half of its float32 room. dK/dV: x = K, w = V, y = q,
// z = do; dQ: x = q, w = do, y = K, z = V
template <class TQ, class TV>
cudaError_t dkv_for(const Args& a, int B, cudaStream_t s) {
  if (a.D <= 32) return launch_dkv<Cfg<32, 32, 32, TQ, TV, TQ, TQ>>(a, B, s);
  if (a.D <= 64) return launch_dkv<Cfg<64, 64, 32, TQ, TV, TQ, TQ>>(a, B, s);
  if (a.D <= 128)
    return launch_dkv<Cfg<128, 128, 16, TQ, TV, TQ, TQ>>(a, B, s);
  return launch_dkv<Cfg<256, 128, 8, TQ, TV, TQ, TQ>>(a, B, s);
}

template <class TQ, class TV>
cudaError_t dq_for(const Args& a, int B, cudaStream_t s) {
  if (a.D <= 32) return launch_dq<Cfg<32, 32, 32, TQ, TQ, TQ, TV>>(a, B, s);
  if (a.D <= 64) return launch_dq<Cfg<64, 64, 32, TQ, TQ, TQ, TV>>(a, B, s);
  if (a.D <= 128)
    return launch_dq<Cfg<128, 128, 16, TQ, TQ, TQ, TV>>(a, B, s);
  return launch_dq<Cfg<256, 128, 8, TQ, TQ, TQ, TV>>(a, B, s);
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dq, void* dk,
               void* dv, int T, int H, int KV, int D, const long long* st,
               float scale, int causal, int window) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
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
// and dv, in that order; the head-dim stride of each must be 1. do has
// q's type; lse and delta are contiguous (B*H, T) float32, and the
// gradients are written float32.
#define VELES_BWD(NAME, TQ, TV)                                              \
  extern "C" int veles_flash_attention_bwd_dkv_##NAME(                       \
      const void* q, const void* k, const void* v, const void* dout,         \
      const void* lse, const void* delta, void* dk, void* dv, int B, int T,  \
      int H, int KV, int D, const long long* strides, float scale,           \
      int causal, int window, void* stream) {                                \
    if (!flash::valid(B, T, H, KV, D)) return (int)cudaErrorInvalidValue;    \
    const Args a = make_args(q, k, v, dout, lse, delta, nullptr, dk, dv, T,  \
                             H, KV, D, strides, scale, causal, window);      \
    return (int)dkv_for<TQ, TV>(a, B, static_cast<cudaStream_t>(stream));    \
  }                                                                          \
  extern "C" int veles_flash_attention_bwd_dq_##NAME(                        \
      const void* q, const void* k, const void* v, const void* dout,         \
      const void* lse, const void* delta, void* dq, int B, int T, int H,     \
      int KV, int D, const long long* strides, float scale, int causal,      \
      int window, void* stream) {                                            \
    if (!flash::valid(B, T, H, KV, D)) return (int)cudaErrorInvalidValue;    \
    const Args a = make_args(q, k, v, dout, lse, delta, dq, nullptr,         \
                             nullptr, T, H, KV, D, strides, scale, causal,   \
                             window);                                        \
    return (int)dq_for<TQ, TV>(a, B, static_cast<cudaStream_t>(stream));     \
  }

VELES_BWD(f32_f32, float, float)
VELES_BWD(f32_bf16, float, bf16)
VELES_BWD(bf16_f32, bf16, float)
VELES_BWD(bf16_bf16, bf16, bf16)

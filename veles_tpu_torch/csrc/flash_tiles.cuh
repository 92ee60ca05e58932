// What the flash-attention kernels (flash_attention_fwd.cu and
// flash_attention_bwd.cu) share: the CTA shape, the mask predicates of
// the reference's _block_live, the asynchronous tile copies into shared
// memory (float32 tiles with their once-a-step hi/lo split, bf16 tiles as
// they are), the products of a resident tile with a streamed one and of
// register fragments with a streamed tile in each operand type, and the
// launch checks.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "tf32x3.cuh"

namespace flash {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16 * WARPS;  // rows of a CTA's resident tile
constexpr float LOG2E = 1.4426950408889634f;

// whether query row qi sees key row kj: the ragged edge (both < T), the
// causal mask and the sliding window (q - k < window). A is any argument
// struct with T, causal and window
template <class A>
__device__ __forceinline__ bool live(int qi, int kj, const A& a) {
  bool keep = qi < a.T && kj < a.T;
  if (a.causal) keep = keep && kj <= qi;
  if (a.window > 0) keep = keep && (qi - kj < a.window);
  return keep;
}

// whether any pair of q rows [q_lo, q_hi] and k rows [k_lo, k_hi] is
// unmasked (_block_live)
template <class A>
__device__ __forceinline__ bool block_live(int q_lo, int q_hi, int k_lo,
                                           int k_hi, const A& a) {
  bool keep = q_lo < a.T && k_lo < a.T;
  if (a.causal) keep = keep && k_lo <= q_hi;
  if (a.window > 0) keep = keep && (q_lo - k_hi < a.window);
  return keep;
}

// whether every pair is unmasked: the per-element masks can be skipped
template <class A>
__device__ __forceinline__ bool block_full(int q_lo, int q_hi, int k_lo,
                                           int k_hi, const A& a) {
  bool full = q_hi < a.T && k_hi < a.T;
  if (a.causal) full = full && k_hi <= q_lo;
  if (a.window > 0) full = full && (q_hi - k_lo < a.window);
  return full;
}

// rows t0 .. t0+R-1 of one head (row stride st), W columns from src (W a
// multiple of 4; the first D are real), into a shared tile with rows of
// L floats, asynchronously: 16-byte copies where the source is 16-byte
// aligned, 4-byte copies elsewhere; rows past T and columns past D are
// zeros, not stale (0 * NaN would poison a sum). A thread copies the
// 4-column chunks idx = threadIdx.x + k * THREADS, and split_tile and
// clean_tile pass over the same chunks, so that no other thread's copies
// need to have landed
template <int R, int W, int L>
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          long long st, int t0, int T,
                                          int D) {
  constexpr int CH = W / 4;  // 4-column chunks a row
  for (int idx = threadIdx.x; idx < R * CH; idx += THREADS) {
    const int r = idx / CH, c = (idx - r * CH) * 4;
    float* d = dst + r * L + c;
    const int t = t0 + r;
    if (t >= T || c >= D) {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    const float* s = src + t * st + c;
    if (c + 4 <= D && (reinterpret_cast<uintptr_t>(s) & 15) == 0) {
      tf32x3::copy16(d, s);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (c + e < D)
          tf32x3::copy4(d + e, s + e);
        else
          d[e] = 0.f;
      }
    }
  }
}

// the same for a bf16 tile: W bf16 columns (W a multiple of 8), rows of L
// values, 16-byte copies where the source is 16-byte aligned; elsewhere
// the values are loaded and stored as they are (cp.async copies no less
// than 4 bytes), and so have landed when this thread's copies have
template <int R, int W, int L>
__device__ __forceinline__ void copy_tile(bf16mma::bf16* dst,
                                          const bf16mma::bf16* src,
                                          long long st, int t0, int T,
                                          int D) {
  constexpr int CH = W / 8;  // 8-column chunks a row
  for (int idx = threadIdx.x; idx < R * CH; idx += THREADS) {
    const int r = idx / CH, c = (idx - r * CH) * 8;
    bf16mma::bf16* d = dst + r * L + c;
    const int t = t0 + r;
    if (t >= T || c >= D) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const bf16mma::bf16* s = src + t * st + c;
    if (c + 8 <= D && (reinterpret_cast<uintptr_t>(s) & 15) == 0) {
      tf32x3::copy16(d, s);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = c + e < D ? s[e] : 0;
    }
  }
}

// a float32 result stored as T: float32 as it is, bf16 rounded
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16mma::bf16* p, float x) {
  *p = bf16mma::round(x);
}

// row stride, in values, of a tile with D columns of T: D + 4 floats, or
// D + 8 bf16 values (tf32x3.cuh and bf16_mma.cuh: both keep the fragment
// loads on distinct banks)
template <class T>
constexpr int row_stride(int d) {
  return bf16mma::is_bf16<T>::value ? d + 8 : d + 4;
}

// this thread's chunks of a landed streamed tile split in place: the
// float32 values become the hi plane, the lo plane P floats on
template <int R, int W, int L, int P>
__device__ __forceinline__ void split_tile(float* hi) {
  constexpr int CH = W / 4;
  for (int idx = threadIdx.x; idx < R * CH; idx += THREADS) {
    const int r = idx / CH, c = (idx - r * CH) * 4;
    tf32x3::split4(hi + r * L + c, hi + P + r * L + c);
  }
}

// this thread's chunks of a landed resident tile cleaned of the NaNs that
// to_tf32 would lose, so that its fragment loads split with no NaN check
template <int R, int W, int L>
__device__ __forceinline__ void clean_tile(float* tile) {
  constexpr int CH = W / 4;
  for (int idx = threadIdx.x; idx < R * CH; idx += THREADS) {
    const int r = idx / CH, c = (idx - r * CH) * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) tf32x3::clean(tile[r * L + c + e]);
  }
}

// One k step of a product of a resident tile's rows with a streamed
// tile's rows (s = q k^T, dp = do v^T and their transposes): the A
// fragments of this lane's rows r0 and r0 + 8 of `a` (rows of LA values
// of TA) and the B fragments of rows 8 j + g of `b` (rows of LB values of
// TB). Two bf16 operands: one bf16 product, a k step of 16. Otherwise
// 3xTF32, a k step of 8: a float32 resident tile (cleaned as it landed)
// is split as its fragments load, a float32 streamed tile is a hi and a
// lo plane PB floats apart, and a bf16 operand is widened, exactly, with
// a zero lo part whose product (pass 0 or 1) is skipped
template <int NS, class TA, int LA, class TB, int LB, int PB>
struct RowsStep {
  static constexpr bool BA = bf16mma::is_bf16<TA>::value;
  static constexpr bool BB = bf16mma::is_bf16<TB>::value;
  static constexpr bool BF = BA && BB;
  static constexpr int K = BF ? 16 : 8;  // columns a step
  uint32_t ah[4], al[4], bh[NS][2], bl[NS][2];

  __device__ __forceinline__ void load(const TA* a, int r0, const TB* b,
                                       int kk) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    if constexpr (BF) {
      const int c = 16 * kk + 2 * t;
      bf16mma::load_a(a, LA, r0, c, ah);
#pragma unroll
      for (int j = 0; j < NS; ++j)
        bf16mma::load_b_along(b, LB, 8 * j + g, c, bh[j]);
    } else {
      const int c = 8 * kk + t;
      if constexpr (BA) {
        ah[0] = bf16mma::wide_bits(a[r0 * LA + c]);
        ah[1] = bf16mma::wide_bits(a[(r0 + 8) * LA + c]);
        ah[2] = bf16mma::wide_bits(a[r0 * LA + c + 4]);
        ah[3] = bf16mma::wide_bits(a[(r0 + 8) * LA + c + 4]);
      } else {
        tf32x3::load_a(a, LA, r0, c, ah, al);
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int at = (8 * j + g) * LB + c;
        if constexpr (BB) {
          bh[j][0] = bf16mma::wide_bits(b[at]);
          bh[j][1] = bf16mma::wide_bits(b[at + 4]);
        } else {
          tf32x3::load_b(b, b + PB, at, at + 4, bh[j], bl[j]);
        }
      }
    }
  }

  // pass 0: lo_a hi_b, pass 1: hi_a lo_b, pass 2: hi_a hi_b (the bf16
  // product), over all NS accumulators, so that no mma waits on the one
  // before it
  __device__ __forceinline__ void pass(float (&acc)[NS][4], int p) const {
    if constexpr (BF) {
      if (p == 2) {
#pragma unroll
        for (int j = 0; j < NS; ++j) bf16mma::mma(acc[j], ah, bh[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        if (p == 0 && !BA) tf32x3::mma(acc[j], al, bh[j]);
        if (p == 1 && !BB) tf32x3::mma(acc[j], ah, bl[j]);
        if (p == 2) tf32x3::mma(acc[j], ah, bh[j]);
      }
    }
  }
};

// acc[j] += a b_j^T over DS columns, S a RowsStep type
template <int NS, int DS, class S, class TA, class TB>
__device__ __forceinline__ void rows_product(float (&acc)[NS][4],
                                             const TA* a, int r0,
                                             const TB* b) {
#pragma unroll
  for (int kk = 0; kk < DS / S::K; ++kk) {
    S f;
    f.load(a, r0, b, kk);
#pragma unroll
    for (int p = 0; p < 3; ++p) f.pass(acc, p);
  }
}

// two rows products over the same DS columns (the backward's s and dp),
// S1 and S2 RowsStep types: where their k steps agree, one loop loads
// both steps' fragments and issues their passes in turn
template <int NS, int DS, class S1, class S2, class TA1, class TB1,
          class TA2, class TB2>
__device__ __forceinline__ void rows_product2(
    float (&acc1)[NS][4], const TA1* a1, const TB1* b1, float (&acc2)[NS][4],
    const TA2* a2, const TB2* b2, int r0) {
  if constexpr (S1::K == S2::K) {
#pragma unroll
    for (int kk = 0; kk < DS / S1::K; ++kk) {
      S1 f1;
      S2 f2;
      f1.load(a1, r0, b1, kk);
      f2.load(a2, r0, b2, kk);
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        f1.pass(acc1, p);
        f2.pass(acc2, p);
      }
    }
  } else {
    rows_product<NS, DS, S1>(acc1, a1, r0, b1);
    rows_product<NS, DS, S2>(acc2, a2, r0, b2);
  }
}

// acc[n] += p b_n for the NA accumulator tiles: p is this warp's 16 rows
// over the RS = 8 NS streamed rows, held as NS C fragments (the forward's
// probabilities, the backward's p or ds); b is the streamed tile (rows of
// LB values of TB, offset to this CTA's first column; a float32 tile is a
// hi and a lo plane PB floats apart). The operand type is the streamed
// tile's: the reference casts p or ds to it before the product. bf16: p
// rounded to bf16 as two n tiles are packed into one A operand, one bf16
// product a k step of 16, b's rows read down its columns. float32: p
// split into TF32 hi and lo in tf32x3.cuh's column order, b's rows read in
// the same order, 3xTF32. G accumulator tiles a pass
template <int NS, int NA, int G, class TB, int LB, int PB>
__device__ __forceinline__ void frag_product(float (&acc)[NA][4],
                                             const float (&p)[NS][4],
                                             const TB* b) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  if constexpr (bf16mma::is_bf16<TB>::value) {
#pragma unroll
    for (int kk = 0; kk < (NS + 1) / 2; ++kk) {
      const bool upper = 2 * kk + 1 < NS;
      uint32_t a[4];
      bf16mma::a_from_c(p[2 * kk], p[upper ? 2 * kk + 1 : 2 * kk], upper, a);
      const int k = 16 * kk + 2 * t;
#pragma unroll
      for (int n0 = 0; n0 < NA; n0 += G) {
        uint32_t bf[G][2];
#pragma unroll
        for (int n = 0; n < G; ++n)
          bf16mma::load_b_down(b, LB, k, 8 * (n0 + n) + g, upper, bf[n]);
#pragma unroll
        for (int n = 0; n < G; ++n) bf16mma::mma(acc[n0 + n], a, bf[n]);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      uint32_t ah[4], al[4];
      tf32x3::a_from_c(p[kk], ah, al);
      const int at = (8 * kk + 2 * t) * LB + g;
#pragma unroll
      for (int n0 = 0; n0 < NA; n0 += G) {
        uint32_t bh[G][2], bl[G][2];
#pragma unroll
        for (int n = 0; n < G; ++n) {
          const int e = at + 8 * (n0 + n);
          tf32x3::load_b(b, b + PB, e, e + LB, bh[n], bl[n]);
        }
#pragma unroll
        for (int n = 0; n < G; ++n) tf32x3::mma(acc[n0 + n], al, bh[n]);
#pragma unroll
        for (int n = 0; n < G; ++n) tf32x3::mma(acc[n0 + n], ah, bl[n]);
#pragma unroll
        for (int n = 0; n < G; ++n) tf32x3::mma(acc[n0 + n], ah, bh[n]);
      }
    }
  }
}

// 2^x on the special-function unit (relative error ~2^-22)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a kernel's dynamic shared memory, and as much of the SM's 256 KB for
// shared memory as it takes, so that several CTAs share an SM
inline cudaError_t prepare(const void* kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// shapes the kernels take: D 1..256, grouped heads, and a flat grid index
// (tile, batch, head) that fits the grid's x, which takes 2^31 - 1 blocks
inline bool valid(int B, int T, int H, int KV, int D) {
  return B >= 1 && T >= 1 && KV >= 1 && H >= KV && H % KV == 0 && D >= 1 &&
         D <= 256 &&
         (long long)((T + ROWS - 1) / ROWS) * B * H <= 0x7fffffffLL;
}

}  // namespace flash

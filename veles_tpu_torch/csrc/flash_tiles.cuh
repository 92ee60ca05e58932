// What the flash-attention kernels (flash_attention_fwd.cu and
// flash_attention_bwd.cu) share: the CTA shape, the mask predicates of
// the reference's _block_live, the asynchronous tile copies into shared
// memory with their once-a-step hi/lo split, and the launch checks.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

// Float32 products on Hopper's tensor cores in 3xTF32, and asynchronous
// global -> shared tile copies: the building blocks of the flash forward
// kernel (flash_attention_fwd.cu), the flash backward kernels
// (flash_attention_bwd.cu) and the fused-FC epoch (fused_fc_sgd.cu).
//
// 3xTF32. A TF32 operand keeps 10 of float32's 23 mantissa bits, so one
// TF32 product is good to about 1e-3 relative: too coarse for a port
// that must follow a float32 reference. Each operand x is split once
// into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna's rounding: to
// nearest, ties away from zero; x - hi is exact in float32), and a b is
// taken as lo_a hi_b + hi_a lo_b + hi_a hi_b, three mma.sync products
// into one float32 accumulator, the small terms first. What is dropped,
// lo_a lo_b and the rounding of lo, is below float32's own rounding of a
// sum of products, so the result is float32-grade.
//
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 fragments, with
// lane = 4 g + t (g = lane / 4, t = lane % 4):
//   A 16x8 (row):  a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B 8x8  (col):  b0 (t, g)  b1 (t+4, g)             (k, n)
//   C 16x8:        c0 (g, 2t) c1 (g, 2t+1) c2 (g+8, 2t) c3 (g+8, 2t+1)
// A product over k is the same for any order of k inside a step, so a
// C fragment serves as the A operand of a next product directly, with
// its 8 columns taken in the order 0 2 4 6 1 3 5 7: a = (c0, c2, c1,
// c3), and the B operand's rows read in the same order (b0 from row
// 2t, b1 from row 2t + 1). That keeps p (and the backward's ds) in
// registers.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties
// away from zero), on the integer view: adding half of the dropped 13
// bits' range to the magnitude carries exactly when they are at least
// half of it. The same bits as cvt.rna for every finite x, on the
// integer pipe, at four times the rate of the conversion unit that cvt
// takes. A NaN whose bits 13-21 are all set carries out of the exponent:
// 0x7fffffff, the NaN the card's arithmetic makes, becomes -0. split()
// keeps NaN; split_clean() is for tiles that clean() has made safe
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// the quiet NaN that to_tf32 rounds to itself
constexpr uint32_t QNAN = 0x7fc00000u;

// x = hi + lo, both TF32, for x that is not a NaN to_tf32 loses (a tile
// that clean() has passed over)
__device__ __forceinline__ void split_clean(float x, uint32_t& hi,
                                            uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// x = hi + lo for any x: a NaN gives hi = QNAN, so that the hi hi
// product, and the result, are NaN whatever lo is
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  split_clean(x, hi, lo);
  if (isnan(x)) hi = QNAN;
}

// x made safe for split_clean: a NaN becomes QNAN
__device__ __forceinline__ void clean(float& x) {
  if (isnan(x)) x = __uint_as_float(QNAN);
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the A operand of m16n8k8 from a row-major float32 tile that clean()
// has passed over: rows r and r + 8, columns c and c + 4, split into hi
// and lo as it is loaded
__device__ __forceinline__ void load_a(const float* tile, int ld, int r,
                                       int c, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  split_clean(tile[r * ld + c], hi[0], lo[0]);
  split_clean(tile[(r + 8) * ld + c], hi[1], lo[1]);
  split_clean(tile[r * ld + c + 4], hi[2], lo[2]);
  split_clean(tile[(r + 8) * ld + c + 4], hi[3], lo[3]);
}

// the A operand from a C fragment (columns in the order 0 2 4 6 1 3 5 7)
__device__ __forceinline__ void a_from_c(const float (&c)[4],
                                         uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  split(c[0], hi[0], lo[0]);
  split(c[2], hi[1], lo[1]);
  split(c[1], hi[2], lo[2]);
  split(c[3], hi[3], lo[3]);
}

// the B operand (elements at0, at1) from hi and lo planes
__device__ __forceinline__ void load_b(const float* hi_tile,
                                       const float* lo_tile, int at0,
                                       int at1, uint32_t (&hi)[2],
                                       uint32_t (&lo)[2]) {
  hi[0] = __float_as_uint(hi_tile[at0]);
  hi[1] = __float_as_uint(hi_tile[at1]);
  lo[0] = __float_as_uint(lo_tile[at0]);
  lo[1] = __float_as_uint(lo_tile[at1]);
}

// four floats at x (16-byte aligned) split in place: x keeps hi, lo gets
// lo
__device__ __forceinline__ void split4(float* x, float* lo) {
  float4 v = *reinterpret_cast<float4*>(x);
  uint32_t h[4], l[4];
  split(v.x, h[0], l[0]);
  split(v.y, h[1], l[1]);
  split(v.z, h[2], l[2]);
  split(v.w, h[3], l[3]);
  *reinterpret_cast<float4*>(x) =
      make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                  __uint_as_float(h[2]), __uint_as_float(h[3]));
  *reinterpret_cast<float4*>(lo) =
      make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                  __uint_as_float(l[2]), __uint_as_float(l[3]));
}

// cp.async: 16 bytes (both addresses 16-byte aligned) or 4 bytes from
// global to shared memory, completing at wait_all()
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// all but the most recent committed group have completed
__device__ __forceinline__ void wait_all_but_last() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

}  // namespace tf32x3

// bfloat16 products on Hopper's tensor cores with float32 accumulation,
// for the flash-attention kernels' bf16 instances (flash_attention_fwd.cu,
// flash_attention_bwd.cu). A product whose two operands are bf16 is one
// mma.sync.m16n8k16 bf16 product into a float32 accumulator: the
// reference's dot_general of two bf16 operands with
// preferred_element_type=float32. A bf16 value times a bf16 value is
// exact in float32, so only the order of the float32 sums differs from
// the reference.
//
// bf16 values are kept as their raw 16 bits (uint16_t): the kernels never
// do arithmetic in bf16, they only widen (exact: a bf16 value is a
// float32 with the low 16 bits clear, so also a TF32 value) and round
// (cvt.rn: to nearest, ties to even, as torch and XLA round a float32 to
// bf16).
//
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 fragments, with
// lane = 4 g + t (g = lane / 4, t = lane % 4); each 32-bit register
// holds two bf16 values, the lower column (or k) in the low half:
//   A 16x16 (row): a0 (g, 2t..2t+1)   a1 (g+8, 2t..2t+1)
//                  a2 (g, 2t+8..2t+9) a3 (g+8, 2t+8..2t+9)
//   B 16x8  (col): b0 (2t..2t+1, g)   b1 (2t+8..2t+9, g)      (k, n)
//   C 16x8:        c0 (g, 2t) c1 (g, 2t+1) c2 (g+8, 2t) c3 (g+8, 2t+1)
// The C fragments of two neighbouring 8-column n tiles j and j + 1 are
// the A operand of a next product over those 16 columns, in their own
// order: a = (c_j0 c_j1, c_j2 c_j3, c_j+1,0 c_j+1,1, c_j+1,2 c_j+1,3),
// rounded to bf16 as they are packed. That keeps p (and the backward's
// ds) in registers.
//
// Tiles in shared memory are row-major with rows of D + 8 bf16 values
// (D a multiple of 32, so a row is D / 2 + 4 words): the 32-bit loads of
// the A operand and of a B operand read along a row, (g, 2t) for lane
// (g, t), hit 32 distinct banks, and a B operand read down a column,
// rows 2t and 2t + 1 at column g, hits 16 distinct words, two lanes a
// word.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bf16mma {

typedef uint16_t bf16;

template <class T>
struct is_bf16 {
  static constexpr bool value = false;
};
template <>
struct is_bf16<bf16> {
  static constexpr bool value = true;
};

// the float32 value of a bf16 (exact)
__device__ __forceinline__ float widen(bf16 x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

// x rounded to bf16 (to nearest, ties to even; NaN stays NaN)
__device__ __forceinline__ bf16 round(float x) {
  unsigned short r;
  asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(r) : "f"(x));
  return r;
}

// lo and hi rounded to bf16 and packed, lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the float32 bits of a bf16, as a TF32 operand of tf32x3.cuh (exact)
__device__ __forceinline__ uint32_t wide_bits(bf16 x) {
  return static_cast<uint32_t>(x) << 16;
}

// two neighbouring bf16 values (p 4-byte aligned), the first in the low
// half
__device__ __forceinline__ uint32_t ld2(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// p[0] and p[ld] packed, p[0] in the low half
__device__ __forceinline__ uint32_t ld2_down(const bf16* p, int ld) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[ld]) << 16);
}

// the A operand from a row-major tile with rows of ld values: rows r and
// r + 8, columns c, c + 1 and c + 8, c + 9 (c = 16 k + 2t)
__device__ __forceinline__ void load_a(const bf16* tile, int ld, int r, int c,
                                       uint32_t (&a)[4]) {
  a[0] = ld2(tile + r * ld + c);
  a[1] = ld2(tile + (r + 8) * ld + c);
  a[2] = ld2(tile + r * ld + c + 8);
  a[3] = ld2(tile + (r + 8) * ld + c + 8);
}

// the B operand of a product over a tile's columns, B(k, n) = tile(n, k):
// row n, columns c, c + 1 and c + 8, c + 9 (c = 16 k + 2t)
__device__ __forceinline__ void load_b_along(const bf16* tile, int ld, int n,
                                             int c, uint32_t (&b)[2]) {
  b[0] = ld2(tile + n * ld + c);
  b[1] = ld2(tile + n * ld + c + 8);
}

// the B operand of a product over a tile's rows, B(k, n) = tile(k, n):
// column n, rows k, k + 1 and k + 8, k + 9 (k = 16 k' + 2t); without
// `upper` (a tile that ends 8 rows on) the last two are zeros
__device__ __forceinline__ void load_b_down(const bf16* tile, int ld, int k,
                                            int n, bool upper,
                                            uint32_t (&b)[2]) {
  b[0] = ld2_down(tile + k * ld + n, ld);
  b[1] = upper ? ld2_down(tile + (k + 8) * ld + n, ld) : 0u;
}

// the A operand from the C fragments of n tiles j (lo) and j + 1 (hi),
// rounded to bf16; without an upper tile its columns are zeros
__device__ __forceinline__ void a_from_c(const float (&lo)[4],
                                         const float (&hi)[4], bool upper,
                                         uint32_t (&a)[4]) {
  a[0] = pack(lo[0], lo[1]);
  a[1] = pack(lo[2], lo[3]);
  a[2] = upper ? pack(hi[0], hi[1]) : 0u;
  a[3] = upper ? pack(hi[2], hi[3]) : 0u;
}

}  // namespace bf16mma

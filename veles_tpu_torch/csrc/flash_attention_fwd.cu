// Flash-attention forward for Hopper (sm_90a): float32, bf16, and the
// mixed operands of mixed precision.
//
// Replaces the TPU kernel veles_tpu/ops/flash_attention.py::_kernel
// (reached through _fwd_pallas / flash_attention): online-softmax
// attention o = softmax(scale * q k^T + mask) v, plus the per-row
// log-sum-exp lse that the backward recomputes p from, without
// materialising the (T, T) score matrix.
//
// What bounds it on this card. The work is 4*Dh FLOP per live (q, k)
// pair (s = q k^T and o += p v). At the serving slice's prefill shape
// (B=4, T=512, H=8, Dh=64, causal; 131,328 live pairs a head) that is
// 1.08 GFLOP against 16.8 MB of q, k, v, o and lse (0.005 ms at
// 3.35 TB/s); at the training slice's (B=16) 4.30 GFLOP and 67 MB; at a
// 2048-token prefill (B=2) 8.59 GFLOP and 34 MB. So the kernel is bound
// by operations: 0.016 / 0.064 / 0.128 ms at the CUDA cores' 67 TFLOP/s
// of float32 FMA, 0.0065 / 0.026 / 0.052 ms on the tensor cores in
// 3xTF32 (three TF32 products a product at 495 TFLOP/s). The products
// run on the tensor cores, so the second set of bounds is the one that
// holds. One TF32 product would be three times cheaper but misses the
// port's 1e-4 float32 tolerance (tests/test_torch_tf32.py), so both
// products are 3xTF32 (tf32x3.cuh): float32-grade.
//
// The design, and what it does about the limits of the CUDA-core kernel
// it replaces (scalar FMAs fed one shared-memory word per two FMAs,
// synchronous K/V copies with a barrier on each side, B*H on the grid's
// y, which caps it at 65,535):
//   - both products are mma.sync m16n8k8 TF32 triples, issued pass by
//     pass over all of a warp's accumulators so that no mma waits on the
//     one before it: s = q k^T with q as the A operand and K as B, and
//     o += p v with p taken straight from s's C fragments as the A
//     operand (tf32x3.cuh's column order) and V as B, its rows read in
//     the order 2t, 2t + 1. No score or probability goes through shared
//     memory;
//   - one CTA of 4 warps per (64-row q tile, batch * head), 16 q rows a
//     warp, the o accumulator in C fragments. At D <= 64 a warp's q
//     fragments are split into hi/lo once and stay in registers (q lands
//     in the ring's second stage, which the second K/V tile then
//     overwrites); above that q stays a float32 tile, cleaned of NaN as
//     it lands and split as its fragments load;
//   - online softmax on the C fragments: a row's 8 columns of an n tile
//     sit in the 4 lanes of a quad, so its max takes two shuffles; the
//     running sum stays a per-lane partial until the end. scale * log2 e
//     is folded into the scores and p = 2^(s - m) runs on ex2; lse =
//     m ln 2 + log l;
//   - K/V tiles go through a two-stage ring of cp.async copies (16 bytes
//     where the source row allows it, 4 bytes elsewhere): the next tile
//     is in flight while the current one computes. Each thread splits
//     the chunks it copied into hi and lo TF32 planes once they land, so
//     a streamed element is split once a step, and one barrier a stage
//     publishes the planes;
//   - rows are Dp + 4 floats (Dp: D rounded up to the variant's 32, 64,
//     128 or 256, zero-filled past D, never padded in device memory), so
//     every fragment load of a warp hits 32 distinct banks. A CTA takes
//     ~37 KB (D <= 32), ~70 KB (D <= 64, 32 K/V rows a step), ~101 KB
//     (D <= 128, 16 rows) or ~167 KB (D <= 256, 16 rows, o's columns
//     split over two CTAs on blockIdx.z, each recomputing s, so that the
//     accumulator fits in registers);
//   - the loop bounds come from the causal and sliding-window predicates
//     (_block_live): a K/V tile with no unmasked score is never loaded, a
//     warp whose 16 rows are all masked against the current tile skips
//     it, and a warp whose rows are all unmasked skips the per-element
//     masks. Elsewhere the causal, window (q - k < window) and
//     ragged-edge (q, k < T) masks apply per element, so any T is taken;
//   - under causal masking the last q tiles see the most K/V tiles: the
//     flat grid index is tile * pairs + (batch, head) pair, the longest
//     tiles first, so the short CTAs fill the card's tail and any B * H
//     whose tensors fit the card is taken;
//   - NaN is kept: a NaN in q, k or v reaches o and lse as it does in the
//     plain version (the q tile is cleaned as it lands, the streamed
//     tiles' split keeps NaN, p's split checks its hi only, and the
//     epilogue's floor on l lets a NaN through);
//   - GQA: query head h reads kv head h / (H / KV) (_kv_fold_of); K/V are
//     never expanded. q, k, v and o are read and written through their
//     (B, T, heads, Dh) strides; lse is written flat as (B*H, T).
//
// Operand types. The reference's kernel takes any operand dtype: q k^T
// accumulates in float32, p is cast to v's dtype before p v, and o is
// written in q's dtype. Mixed precision gives it q, k and v in bf16 (an
// all-bf16 model) or q and k in float32 and v in bf16 (RoPE's float32
// tables promote q and k; v stays bf16). So the kernel is templated on
// the type of q and k (TQ, which o takes too) and of v (TV), float32 or
// bf16: four instances. A product with two bf16 operands is one bf16
// mma.sync.m16n8k16 with float32 accumulation (bf16_mma.cuh): q k^T when
// TQ is bf16, p v when TV is bf16, with p rounded to bf16 in registers as
// it is packed, the reference's rounding point. A product with a float32
// operand is the 3xTF32 one above. bf16 tiles are copied as bf16, in rows
// of D + 8 values (bank-conflict-free for the bf16 fragments), and need
// no split. At the training shape the all-bf16 instance's products are
// 4.30 GFLOP at the 989 TFLOP/s of bf16 (0.0043 ms) against 34 MB of
// bf16 q, k, v, o and float32 lse (0.010 ms): bound by bytes; the
// (float32, float32, bf16) instance's s is 3xTF32 and its p v bf16, 0.015
// ms of operations against 59 MB (0.018 ms): bound by bytes too.
//
// C interface: veles_flash_attention_fwd_<qk>_<v>(...), <qk> and <v> each
// f32 or bf16, launches on the given stream and returns
// cudaGetLastError() (0 on success). It allocates nothing and does not
// synchronise.

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

constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_INF = -1e30f;

// DS: head-dim columns of s = q k^T (D zero-filled up to it in shared
// memory); DA: columns of o one CTA accumulates; RS: K/V rows a step; TQ,
// TV: the element types of q/K/o and of V. q and K rows are LD values, V
// rows LDA (flash_tiles.cuh's row_stride). A float32 streamed tile is a hi and a
// lo TF32 plane, split once a step by the threads that copied it; a bf16
// tile is one plane. At DS <= 64 the warps keep q's fragments in
// registers (QREG); above, q stays a tile in front of the ring. Sizes in
// bytes
template <int DS_, int DA_, int RS_, class TQ_, class TV_>
struct Cfg {
  using TQ = TQ_;
  using TV = TV_;
  static constexpr int DS = DS_, DA = DA_, RS = RS_;
  static constexpr bool BQ = is_bf16<TQ>::value, BV = is_bf16<TV>::value;
  static constexpr int LD = row_stride<TQ>(DS);   // q and K rows
  static constexpr int LDA = row_stride<TV>(DA);  // V rows
  static constexpr int NS = RS / 8;    // n tiles of s
  static constexpr int NA = DA / 8;    // n tiles of o
  static constexpr int KP = RS * LD;   // one K plane, in values
  static constexpr int VP = RS * LDA;  // one V plane, in values
  static constexpr int KBYTES = (BQ ? 1 : 2) * KP * (int)sizeof(TQ);
  static constexpr int STAGE = KBYTES + (BV ? 1 : 2) * VP * (int)sizeof(TV);
  static constexpr bool QREG = DS <= 64;
  static constexpr int QBYTES = ROWS * LD * (int)sizeof(TQ);
  static constexpr int RES = QREG ? 0 : QBYTES;
  static constexpr int KQ = BQ ? DS / 16 : DS / 8;  // k steps of s
  static constexpr int G = NA < 4 ? NA : 4;  // o tiles a pass
  static constexpr size_t bytes = RES + 2 * STAGE;
  static_assert(!QREG || QBYTES <= STAGE, "q lands in stage 1's place");
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B*H, T)
  int T, H, KV, D;
  // element strides (batch, time, head) of q, k, v, o
  long long sq[3], sk[3], sv[3], so[3];
  float scale;
  int causal, window;
};

// a warp's q fragments, loaded once (QREG only): TF32 hi and lo a k step
// of 8, or bf16 pairs a k step of 16
template <class C>
struct QFrag {
  static constexpr int N = C::QREG ? C::KQ : 1;
  uint32_t h[N][4], l[C::BQ ? 1 : N][4];
};

template <class C>
__device__ __forceinline__ void load_q(QFrag<C>& qf,
                                       const typename C::TQ* qs, int r0) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < C::KQ; ++kk) {
    if constexpr (C::BQ)
      bf16mma::load_a(qs, C::LD, r0, 16 * kk + 2 * t, qf.h[kk]);
    else
      tf32x3::load_a(qs, C::LD, r0, 8 * kk + t, qf.h[kk], qf.l[kk]);
  }
}

// s = q k^T of a warp's 16 q rows (r0, r0 + 8 of each lane) against the
// step's RS K rows, over DS columns (zeros past D): from q's fragments in
// registers (QREG), or as rows_product of the q tile
template <class C>
__device__ __forceinline__ void scores(const QFrag<C>& qf,
                                       const typename C::TQ* qs,
                                       const typename C::TQ* k, int r0,
                                       float (&s)[C::NS][4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < C::NS; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
  if constexpr (!C::QREG) {
    rows_product<C::NS, C::DS,
                 RowsStep<C::NS, typename C::TQ, C::LD, typename C::TQ, C::LD,
                          C::KP>>(s, qs, r0, k);
  } else if constexpr (C::BQ) {
#pragma unroll
    for (int kk = 0; kk < C::KQ; ++kk) {
      uint32_t b[C::NS][2];
#pragma unroll
      for (int j = 0; j < C::NS; ++j)
        bf16mma::load_b_along(k, C::LD, 8 * j + g, 16 * kk + 2 * t, b[j]);
#pragma unroll
      for (int j = 0; j < C::NS; ++j) bf16mma::mma(s[j], qf.h[kk], b[j]);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < C::KQ; ++kk) {
      uint32_t bh[C::NS][2], bl[C::NS][2];
#pragma unroll
      for (int j = 0; j < C::NS; ++j) {
        const int at = (8 * j + g) * C::LD + 8 * kk + t;
        tf32x3::load_b(k, k + C::KP, at, at + 4, bh[j], bl[j]);
      }
#pragma unroll
      for (int j = 0; j < C::NS; ++j) tf32x3::mma(s[j], qf.l[kk], bh[j]);
#pragma unroll
      for (int j = 0; j < C::NS; ++j) tf32x3::mma(s[j], qf.h[kk], bl[j]);
#pragma unroll
      for (int j = 0; j < C::NS; ++j) tf32x3::mma(s[j], qf.h[kk], bh[j]);
    }
  }
}

// one step of the online softmax, in place of s: element (j, i) is q row
// qi0 + 8 (i / 2) against K row kt + 8 j + 2 t + (i % 2). m (in log2
// units) and this lane's partial row sums l move to the step's maxima, o
// is rescaled by 2^(m_old - m_new), and s becomes p = 2^(s scale log2 e
// - m). MASK applies the per-element masks: a masked score is NEG_INF
// for the max and its p is 0
template <class C, bool MASK>
__device__ __forceinline__ void softmax_step(float (&s)[C::NS][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&acc)[C::NA][4],
                                             int qi0, int kt,
                                             const Args& a) {
  const int t = threadIdx.x & 3;
  const float scale_log2 = a.scale * LOG2E;
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < C::NS; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i >> 1;
      float x = s[j][i] * scale_log2;
      if (MASK && !live(qi0 + 8 * r, kt + 8 * j + 2 * t + (i & 1), a))
        x = NEG_INF;
      s[j][i] = x;
      mx[r] = fmaxf(mx[r], x);
    }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // a row's columns sit in the 4 lanes of a quad
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r]);
    alpha[r] = exp2_approx(m[r] - mn);
    m[r] = mn;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < C::NS; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i >> 1;
      float p = exp2_approx(s[j][i] - m[r]);
      if (MASK && !live(qi0 + 8 * r, kt + 8 * j + 2 * t + (i & 1), a))
        p = 0.f;
      s[j][i] = p;
      l[r] += p;
    }
#pragma unroll
  for (int n = 0; n < C::NA; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] *= alpha[i >> 1];
}

template <class C>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const Args a) {
  using TQ = typename C::TQ;
  using TV = typename C::TV;
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
  const int c0 = blockIdx.z * C::DA;  // this CTA's o columns
  const int T = a.T, D = a.D;
  const int r0 = 16 * warp + g;  // this lane's q rows: r0, r0 + 8

  // q lands in front of the ring, or, when its fragments go to
  // registers, in stage 1's place
  TQ* qs = reinterpret_cast<TQ*>(C::QREG ? ring + C::STAGE : smem);
  copy_tile<ROWS, C::DS, C::LD>(
      qs, static_cast<const TQ*>(a.q) + b * a.sq[0] + h * a.sq[2], a.sq[1],
      q0, T, D);
  const TQ* kb = static_cast<const TQ*>(a.k) + b * a.sk[0] + kvh * a.sk[2];
  const TV* vb =
      static_cast<const TV*>(a.v) + b * a.sv[0] + kvh * a.sv[2] + c0;

  // the K/V range any row of this q tile can see (_block_live), in steps
  // of RS rows from key 0: the blocks a p rounded to bf16 takes its
  // running max over are the reference kernel's and the plain version's
  const int q_last = min(q0 + ROWS, T) - 1;
  const int k_hi = a.causal ? q_last + 1 : T;
  const int k_lo =
      a.window > 0 ? max(0, q0 - a.window + 1) / C::RS * C::RS : 0;
  const int steps = (k_hi - k_lo + C::RS - 1) / C::RS;

  // the K and V rows of step it, into stage it % 2
  auto issue = [&](int it) {
    const int kt = k_lo + it * C::RS;
    unsigned char* st = ring + (it & 1) * C::STAGE;
    copy_tile<C::RS, C::DS, C::LD>(reinterpret_cast<TQ*>(st), kb, a.sk[1],
                                   kt, T, D);
    copy_tile<C::RS, C::DA, C::LDA>(reinterpret_cast<TV*>(st + C::KBYTES),
                                    vb, a.sv[1], kt, T, D - c0);
    tf32x3::commit();
  };

  QFrag<C> qf;
  float acc[C::NA][4];
#pragma unroll
  for (int n = 0; n < C::NA; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  issue(0);  // q's copies ride in the first group
  for (int it = 0; it < steps; ++it) {
    // this thread's copies of step it have landed: it splits its own
    // float32 chunks into the hi/lo planes; one barrier then publishes the
    // stage, and every warp is done with step it - 1, whose stage the
    // next copies overwrite
    tf32x3::wait_all();
    unsigned char* st = ring + (it & 1) * C::STAGE;
    if constexpr (!C::BQ) {
      if (it == 0) clean_tile<ROWS, C::DS, C::LD>(qs);
      split_tile<C::RS, C::DS, C::LD, C::KP>(reinterpret_cast<float*>(st));
    }
    if constexpr (!C::BV)
      split_tile<C::RS, C::DA, C::LDA, C::VP>(
          reinterpret_cast<float*>(st + C::KBYTES));
    __syncthreads();
    if constexpr (C::QREG) {
      if (it == 0) {
        load_q<C>(qf, qs, r0);
        __syncthreads();  // stage 1's copies overwrite q
      }
    }
    if (it + 1 < steps) issue(it + 1);

    const int kt = k_lo + it * C::RS;
    const int qw = q0 + 16 * warp;  // this warp's q rows qw .. qw + 15
    if (!block_live(qw, qw + 15, kt, kt + C::RS - 1, a)) continue;

    float s[C::NS][4];
    scores<C>(qf, qs, reinterpret_cast<const TQ*>(st), r0, s);
    if (block_full(qw, qw + 15, kt, kt + C::RS - 1, a))
      softmax_step<C, false>(s, m, l, acc, q0 + r0, kt, a);
    else
      softmax_step<C, true>(s, m, l, acc, q0 + r0, kt, a);

    // o += p v over the step's K/V rows, p rounded to V's type
    frag_product<C::NS, C::NA, C::G, TV, C::LDA, C::VP>(
        acc, s, reinterpret_cast<const TV*>(st + C::KBYTES));
  }

  const int t = threadIdx.x & 3;
  const long long row = (long long)bh * T;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    // a floor that lets a NaN through (fmaxf would drop it)
    l[r] = l[r] < 1e-30f ? 1e-30f : l[r];
    const int qi = q0 + r0 + 8 * r;
    if (qi >= T) continue;
    TQ* orow = static_cast<TQ*>(a.o) + b * a.so[0] + qi * a.so[1] +
               h * a.so[2];
#pragma unroll
    for (int n = 0; n < C::NA; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = c0 + 8 * n + 2 * t + e;
        if (d < D) store(orow + d, acc[n][2 * r + e] / l[r]);
      }
    if (blockIdx.z == 0 && t == 0) a.lse[row + qi] = m[r] * LN2 + logf(l[r]);
  }
}

template <class C>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const cudaError_t err = prepare(
      reinterpret_cast<const void*>(flash_fwd_kernel<C>), C::bytes);
  if (err != cudaSuccess) return err;
  const int tiles = (a.T + ROWS - 1) / ROWS, z = (a.D + C::DA - 1) / C::DA;
  const dim3 grid(tiles * B * a.H, 1, z);
  flash_fwd_kernel<C><<<grid, THREADS, C::bytes, stream>>>(a);
  return cudaGetLastError();
}

// the variant for head dim D: (DS, DA, RS). In float32 a CTA takes ~37
// KB (D <= 32), ~70 KB (D <= 64, q's fragments in registers), ~101 KB
// (D <= 128, 16 K/V rows a step) or ~167 KB (D <= 256, 16 rows, and o's
// columns split over two CTAs so that the accumulator fits in
// registers); a bf16 tile takes about half of its float32 room
template <class TQ, class TV>
cudaError_t launch_for(const Args& a, int B, cudaStream_t s) {
  if (a.D <= 32) return launch<Cfg<32, 32, 32, TQ, TV>>(a, B, s);
  if (a.D <= 64) return launch<Cfg<64, 64, 32, TQ, TV>>(a, B, s);
  if (a.D <= 128) return launch<Cfg<128, 128, 16, TQ, TV>>(a, B, s);
  return launch<Cfg<256, 128, 16, TQ, TV>>(a, B, s);
}

template <class TQ, class TV>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int B, int T, int H, int KV, int D, const long long* strides,
        float scale, int causal, int window, void* stream) {
  if (!flash::valid(B, T, H, KV, D)) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = static_cast<float*>(lse);
  a.T = T;
  a.H = H;
  a.KV = KV;
  a.D = D;
  long long* dst[4] = {a.sq, a.sk, a.sv, a.so};
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = strides[3 * i + j];
  a.scale = scale;
  a.causal = causal;
  a.window = window;
  return (int)launch_for<TQ, TV>(a, B, static_cast<cudaStream_t>(stream));
}

}  // namespace

// strides: 12 element strides (batch, time, head) of q, k, v and o, in
// that order; the head-dim stride of each must be 1. o has q's type; lse
// is written as contiguous (B*H, T) float32.
#define VELES_FWD(NAME, TQ, TV)                                              \
  extern "C" int veles_flash_attention_fwd_##NAME(                           \
      const void* q, const void* k, const void* v, void* o, void* lse,       \
      int B, int T, int H, int KV, int D, const long long* strides,          \
      float scale, int causal, int window, void* stream) {                   \
    return fwd<TQ, TV>(q, k, v, o, lse, B, T, H, KV, D, strides, scale,      \
                       causal, window, stream);                              \
  }

VELES_FWD(f32_f32, float, float)
VELES_FWD(f32_bf16, float, bf16)
VELES_FWD(bf16_f32, bf16, float)
VELES_FWD(bf16_bf16, bf16, bf16)

// fp32-accurate products on the tensor cores: split-precision TF32 on
// mma.sync m16n8k8, shared by the MSA tile (msa_tile.cuh), the layer's
// GEMM tile (mma_gemm.cuh) and the flash-attention tile
// (head_attention.cuh), with the pieces the first two stage through: a tile
// copier for aligned tiles, a run-time cp.async wait and 16-byte loads
// from a cluster peer's shared memory.
//
// An fp32 value a is split into a_hi = tf32(a) and a_lo = tf32(a - a_hi),
// each rounded to nearest by integer operations on the bits (add half a
// TF32 ulp, clear the 13 low bits: cheaper than cvt.rna); a - a_hi - a_lo
// is within 2^-22 of |a|.  A product of two fp32 operands takes three
// passes, a_hi.b_hi + (a_lo.b_hi + a_hi.b_lo), dropping a_lo.b_lo (2^-22
// of the product); an fp32 operand against a bf16 one takes two, a_hi.b +
// a_lo.b, because a bf16 value is exact in TF32.  Three passes at the TF32
// rate (495 TFLOP/s dense) are 165 TFLOP/s of fp32-accurate products,
// against 67 on the CUDA cores.
//
// Accumulation: the tensor core adds into its accumulator with truncation
// (on an H100, three passes summed into one running accumulator drifted
// with the depth of the sum, past the 1e-5 bound of the bf16-weight mode
// at K = 768).  So each 8-deep step of a_hi.b_hi goes into a fresh zero
// accumulator that is then added to the running sum by an fp32 add,
// rounded to nearest; the small terms, 2^-11 of the product, collect in
// a second accumulator added once at the end (`SplitAcc`).
//
// Fragments read shared memory in pairs.  The k index of a step of 8 is
// permuted (slot t holds k 2t, slot t + 4 holds k 2t + 1), so a lane reads
// A[row][2t], A[row][2t + 1] as one 8-byte load; a B row is read as column
// pairs (2g, 2g + 1) that feed two n-tiles at once: the "even" tile holds
// the even columns of a 16-column block and the "odd" tile the odd ones,
// so a lane's four accumulators of the two tiles are the four consecutive
// columns 4t .. 4t + 3 of its rows.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "common.cuh"

namespace repro_torch {

__device__ __forceinline__ uint32_t tf32_bits(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo (+ 2^-22 |v|), both TF32.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_bits(v);
  lo = tf32_bits(v - __uint_as_float(hi));
}

// d += a . b for a 16x8 TF32 A (row major, 4 registers), an 8x8 TF32 B
// (column major, 2 registers) and a 16x8 fp32 accumulator.
__device__ __forceinline__ void mma_tf32_1688(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment (rows r, r + 8 of a 16-row tile; one 8-deep k step) split
// into its TF32 parts.
struct SplitA {
  uint32_t hi[4], lo[4];
};

// Rows `r` and `r + 8` (r = the lane's group) at k0 of an fp32 tile with
// row stride `ld` floats.
__device__ __forceinline__ SplitA load_split_a(const float* tile, int ld,
                                               int r, int k0) {
  const int t = threadIdx.x % 4;
  const float2 u = *reinterpret_cast<const float2*>(tile + r * ld + k0 + 2 * t);
  const float2 w =
      *reinterpret_cast<const float2*>(tile + (r + 8) * ld + k0 + 2 * t);
  SplitA a;
  split_tf32(u.x, a.hi[0], a.lo[0]);
  split_tf32(w.x, a.hi[1], a.lo[1]);
  split_tf32(u.y, a.hi[2], a.lo[2]);
  split_tf32(w.y, a.hi[3], a.lo[3]);
  return a;
}

// The B fragments of one 16-column block at k0: rows k0 + 2t, k0 + 2t + 1
// (t = lane % 4), columns c0 + 2g, c0 + 2g + 1 (g = lane / 4), for the
// even and the odd n-tile.  T = float is split (three passes); T = bf16 is
// exact in TF32 (two passes; `lo` unused).
struct PairB {
  uint32_t hi[2][2], lo[2][2] = {};  // [even / odd][k slot t / t + 4]
};

__device__ __forceinline__ void load_col_pair(const float* p, float& e,
                                              float& o) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  e = v.x;
  o = v.y;
}
__device__ __forceinline__ void load_col_pair(const __nv_bfloat16* p,
                                              float& e, float& o) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
  e = __uint_as_float(v << 16);
  o = __uint_as_float(v & 0xffff0000u);
}

template <typename T>
__device__ __forceinline__ PairB load_pair_b(const T* tile, int ld, int k0,
                                             int c0) {
  const int t = threadIdx.x % 4, g = (threadIdx.x / 4) % 8;
  PairB b;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    float e, o;
    load_col_pair(tile + (k0 + 2 * t + s) * ld + c0 + 2 * g, e, o);
    if constexpr (sizeof(T) == 4) {
      split_tf32(e, b.hi[0][s], b.lo[0][s]);
      split_tf32(o, b.hi[1][s], b.lo[1][s]);
    } else {
      b.hi[0][s] = __float_as_uint(e);
      b.hi[1][s] = __float_as_uint(o);
    }
  }
  return b;
}

// A 16x8 fp32 result of split products: `v`, the running sum of the
// a_hi.b_hi steps, each added rounded to nearest, and `lo`, the small
// terms; the value is v + lo (`split_value`).
struct SplitAcc {
  float v[4], lo[4];
};

__device__ __forceinline__ void split_zero(SplitAcc& d) {
#pragma unroll
  for (int e = 0; e < 4; ++e) d.v[e] = d.lo[e] = 0.f;
}

__device__ __forceinline__ float split_value(const SplitAcc& d, int e) {
  return d.v[e] + d.lo[e];
}

// d += a . b for one 8-deep step: B's high parts (bh0, bh1) and, unless
// B is exact in TF32, its low parts (bl0, bl1).
template <bool EXACT_B>
__device__ __forceinline__ void mma_split(SplitAcc& d, const SplitA& a,
                                          uint32_t bh0, uint32_t bh1,
                                          uint32_t bl0, uint32_t bl1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32_1688(t, a.hi, bh0, bh1);
  mma_tf32_1688(d.lo, a.lo, bh0, bh1);
  if constexpr (!EXACT_B) mma_tf32_1688(d.lo, a.hi, bl0, bl1);
#pragma unroll
  for (int e = 0; e < 4; ++e) d.v[e] += t[e];
}

// d += a . b for n-tile `half` of a column pair.
template <bool EXACT_B>
__device__ __forceinline__ void mma_split(SplitAcc& d, const SplitA& a,
                                          const PairB& b, int half) {
  mma_split<EXACT_B>(d, a, b.hi[half][0], b.hi[half][1], b.lo[half][0],
                     b.lo[half][1]);
}

// d += a . b for one 8-deep step in one accumulator: the three passes
// into a fresh zero accumulator, the small terms first, then added to d
// by an fp32 add rounded to nearest.  SplitAcc's rounded add without its
// second accumulator, for tiles that hold many (flash attention's O at Dh
// 256 is 128 accumulators a thread): the step's own truncation stays
// within an ulp of the step's sum.
__device__ __forceinline__ void mma_split3(float (&d)[4], const SplitA& a,
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32_1688(t, a.lo, bh0, bh1);
  mma_tf32_1688(t, a.hi, bl0, bl1);
  mma_tf32_1688(t, a.hi, bh0, bh1);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

// Column of accumulator element e (0-3) of n-tile `half` in a paired
// 16-column block at c0: rows r (e < 2) and r + 8 (e >= 2).
__device__ __forceinline__ int pair_col(int c0, int half, int e) {
  return c0 + 4 * (threadIdx.x % 4) + 2 * (e & 1) + half;
}

// cp_async_wait<n>() for a run-time n in [0, 7].
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// The address of `local` (this block's shared memory) in the shared
// memory of cluster block `rank`, and a 16-byte load from such an address.
__device__ __forceinline__ uint32_t cluster_addr(const void* local,
                                                 int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_addr(local)), "r"(rank));
  return r;
}

__device__ __forceinline__ uint4 ld_cluster16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// Tile rows [row0, row0 + TR) x columns [col0, col0 + TC) of a row-major
// (rows x cols, leading dimension ld) matrix into shared memory at `dst`
// (row stride `ds` bytes) by THREADS threads, one 16-byte cp.async a chunk
// and zero-filled chunks past the matrix.  For 16-byte aligned rows with
// cols a multiple of the chunk (each chunk wholly inside or outside) and
// col0 on a chunk boundary; the tile's shape is a template constant, so a
// chunk costs a few integer operations (`load_tile`, async_copy.cuh,
// handles any edge, at many more instructions a chunk).
template <typename T, int THREADS, int TR, int TC>
__device__ __forceinline__ void load_tile_fast(unsigned char* dst, int ds,
                                               const T* __restrict__ src,
                                               long long ld, int row0,
                                               int rows, int col0,
                                               int cols) {
  constexpr int V = 16 / (int)sizeof(T), CPR = TC / V, CHUNKS = TR * CPR;
#pragma unroll
  for (int u = 0; u < (CHUNKS + THREADS - 1) / THREADS; ++u) {
    const int i = threadIdx.x + u * THREADS;
    if (CHUNKS % THREADS == 0 || i < CHUNKS) {
      const int r = i / CPR, c = i % CPR * V, row = row0 + r, col = col0 + c;
      const bool ok = row < rows && col < cols;
      cp_async16(dst + r * ds + c * (int)sizeof(T),
                 ok ? src + row * ld + col : src, ok);
    }
  }
}

}  // namespace repro_torch

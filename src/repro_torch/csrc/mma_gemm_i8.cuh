// One output tile of the int8 x int8 -> int32 GEMM on the int8 tensor
// cores (mma.sync m16n8k32, s8 x s8 + s32), with the requant epilogue of
// gemm_i8.cuh (`i8_epilogue`).  Used by gemm_i8.cu (kernel 4 and the
// products of kernels 2 and 3) and by the int8 layer group's four GEMM
// stages (vita_layer_group.cu, kernel 8), so the group's products equal
// the per-layer chain's bit for bit.
//
// Design: a 64 x 64 output tile (2 x 2 warps of 32 x 32: two 16-row by
// four 8-column mma tiles each; KG warps of each where the k steps are
// split over KG warp groups), A [64 x 128] and B [128 x 64] staged into a
// ring of STAGES stages (4 in kernel 4), one barrier a step.  The threads
// that run a tile are a `WholeBlock`, or one `BlockPart` of a larger block
// that syncs on a named barrier of its own (the layer group runs two KG =
// 1 tiles a block that way, each on a 2-stage ring).  The plan
// (kernels/int8_matmul.py::gemm_i8_plan) picks the k groups and each
// operand's copy width: 16-byte cp.async chunks where a chunk
// stays inside one row (of A) or one head's columns (of a per-head B
// stack) and is aligned, else 8- or 4-byte cp.async, else single bytes
// (plain loads); every edge of M, N and K is zero-filled, so the integer
// sums stay exact.
//   * A is read by ldmatrix (an 8 x 8 b16 matrix is 8 rows of 16 bytes,
//     which is the s8 A fragment); its rows are padded to 144 bytes so
//     the eight 16-byte rows of a matrix hit distinct banks.
//   * B must reach the mma k-contiguous per column, from a row-major
//     (K, N) operand, and ldmatrix .trans moves 16-bit elements only.  A
//     lane loads four 32-bit words of its rows k = 4t .. 4t + 3 at columns
//     4g .. 4g + 3 and transposes the 4 x 4 bytes with eight __byte_perm;
//     the four words out are the B fragments of four n-tiles, so n-tile j
//     of a warp holds the columns 4g + j (g = lane / 4) and the epilogue
//     maps them back.  The stage's 16-byte chunks are permuted within each
//     128-byte line (`mi_b_offset`), so these loads hit 32 distinct banks.
//     The other way, transposing each staged B tile once in shared
//     memory and reading it by ldmatrix, ran slower at every timed shape
//     on an H100 (an extra pass and an extra barrier a stage).
// What sets the pace (measured on an H100 at the DeiT-T and Swin-T
// shapes, 64 x 64 against 128 x 64 and 32 x 32 tiles, 4 to 8 stages, 64
// and 128 deep): not the loads' latency (a deeper ring gained nothing) but
// the work between two barriers; 128-deep stages (half the barriers)
// gained most at K 768 and 3072, and k groups gain where the tiles leave
// SMs idle but lose where they cost a wave (`gemm_i8_plan`).  The layer's
// up product, with its GELU and requant epilogue, is the one shape that
// is slower than a bare torch._int_mm.
// Bound: bytes at the embed shape (DeiT-T, 1568 x 768 . 768 x 192);
// operations at the layer's widest products.
#pragma once

#include "async_copy.cuh"
#include "gemm_i8.cuh"

namespace repro_torch {

constexpr int MI_BK = 128, MI_STAGES = 4, MI_LDA = MI_BK + 16;

// The tile: WM x WN warps of 32 x 32 outputs, each KG times (k groups:
// warp group wk takes the 32-deep steps wk, wk + KG, ... of every stage;
// their int32 partial tiles are added through shared memory), on a ring of
// STAGES stages.
template <int KG, int STAGES = MI_STAGES>
struct MiTile {
  static_assert(MI_BK % (32 * KG) == 0, "a stage splits over the k groups");
  static constexpr int WM = 2, WN = 2;
  static constexpr int BM = 32 * WM, BN = 32 * WN, THREADS = 32 * WM * WN * KG;
  static constexpr int A_BYTES = BM * MI_LDA;      // [BM][64 + 16]
  static constexpr int STAGE = A_BYTES + MI_BK * BN;
  static constexpr int RED = (KG - 1) * WM * WN * 32 * 32 * 4;
  static constexpr int SMEM = STAGES * STAGE > RED ? STAGES * STAGE : RED;
};

// True where W-byte copies stay inside every row (a, b), head (c) and
// column range (d) and p is W-byte aligned.
inline bool width_ok(int w, long long a, long long b, long long c,
                     long long d, const void* p) {
  return (w == 16 || w == 8 || w == 4 || w == 1) && a % w == 0 &&
         b % w == 0 && c % w == 0 && d % w == 0 &&
         reinterpret_cast<uintptr_t>(p) % w == 0;
}

// d += a . b for a 16x32 s8 A (row major, 4 registers), a 32x8 s8 B
// (column major, 2 registers) and a 16x8 s32 accumulator.
__device__ __forceinline__ void mma_s8_16832(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// W bytes from src to dst (16, 8 or 4: one cp.async, zero-filled where
// !valid; 1: a plain load and store).
template <int W>
__device__ __forceinline__ void copy_chunk(unsigned char* dst,
                                           const int8_t* src, bool valid) {
  if constexpr (W == 16) {
    cp_async16(dst, src, valid);
  } else if constexpr (W == 1) {
    *reinterpret_cast<int8_t*>(dst) = valid ? *src : (int8_t)0;
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(W), "r"(valid ? W : 0));
  }
}

// Byte offset of element (k, column byte c) of a staged B tile: rows of
// BN bytes whose 16-byte chunks are permuted within each 128-byte line by
// 2 ((k >> 2) & 3), so that the fragment loads (rows 4t + r, t = 0..3, of
// one 32-byte column span) fall on 32 distinct banks.
template <int BN>
__device__ __forceinline__ int mi_b_offset(int k, int c) {
  return ((k * (BN / 16) + (c >> 4)) ^ (((k >> 2) & 3) << 1)) * 16 + (c & 15);
}

// A rows [m0, m0 + BM) x k [k0, k0 + MI_BK) into As (rows of MI_LDA
// bytes), by THREADS threads of which this is `tid`.
template <int W, int THREADS, int BM>
__device__ __forceinline__ void stage_a(unsigned char* As, const int8_t* A,
                                        long long lda, int m0, int M, int k0,
                                        int K, int tid) {
  constexpr int CPR = MI_BK / W, CHUNKS = BM * CPR;
  for (int i = tid; i < CHUNKS; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * W, m = m0 + r, k = k0 + c;
    const bool ok = m < M && k < K;
    copy_chunk<W>(As + r * MI_LDA + c, ok ? A + (long long)m * lda + k : A,
                  ok);
  }
}

// B k [k0, k0 + MI_BK) x columns [n0, n0 + BN) into Bs (`mi_b_offset`);
// column n of B is column n % grp of group n / grp.
template <int W, int THREADS, int BN>
__device__ __forceinline__ void stage_b(unsigned char* Bs, const int8_t* B,
                                        long long ldb, int grp,
                                        long long grp_stride, int k0, int K,
                                        int n0, int N, int tid) {
  constexpr int CPR = BN / W, CHUNKS = MI_BK * CPR;
  for (int i = tid; i < CHUNKS; i += THREADS) {
    const int kr = i / CPR, c = (i % CPR) * W, k = k0 + kr, n = n0 + c;
    const bool ok = k < K && n < N;
    const int8_t* src = ok ? B + (long long)(n / grp) * grp_stride +
                                 (long long)k * ldb + n % grp
                           : B;
    copy_chunk<W>(Bs + mi_b_offset<BN>(kr, c), src, ok);
  }
}

// The B fragments of four n-tiles from a lane's four words (rows r = 0..3,
// bytes = columns 4g .. 4g + 3): fragment j holds column 4g + j, k bytes
// in row order.
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4],
                                           uint32_t (&b)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t1 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t2 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  b[0] = __byte_perm(t0, t1, 0x5410);
  b[1] = __byte_perm(t0, t1, 0x7632);
  b[2] = __byte_perm(t2, t3, 0x5410);
  b[3] = __byte_perm(t2, t3, 0x7632);
}

// Output tile (mt, nt) of C = epilogue(A (M x K) . B (K x N)); every
// thread of Part (MiTile<KG>::THREADS of them) calls it, with `smem`
// holding MiTile<KG, STAGES>::SMEM bytes of its own.  B element (k, n) is
// B[(n / grp) * grp_stride + k * ldb + n % grp] (a per-head (H, K, Dh)
// stack read in place: grp = ldb = Dh); the epilogue's arguments are
// `i8_epilogue`'s; a_w and b_w are A's and B's copy widths (16, 8, 4 or 1
// bytes).  No pointer carries __restrict__: in the layer group A, C and
// res are workspace that other blocks wrote earlier in the same launch.
template <int KG, int STAGES = MI_STAGES, typename Part = WholeBlock,
          typename BT>
__device__ __forceinline__ void mma_gemm_i8_tile(
    unsigned char* smem, int mt, int nt, const int8_t* A, long long lda,
    const int8_t* B, long long ldb, int grp, long long grp_stride, void* C,
    long long ldc, int out_kind, int M, int N, int K, const float* x_scale,
    const float* w_scale, const BT* bias, const float* res, long long ldr,
    int gelu, const float* out_scale, int a_w, int b_w) {
  using T = MiTile<KG, STAGES>;
  constexpr int WM = T::WM, WN = T::WN, BN = T::BN, CPR = BN / 16;
  const int m0 = mt * T::BM, n0 = nt * BN;
  const int tid = Part::tid(), lane = tid % 32, warp = tid / 32;
  const int wt = warp % (WM * WN), wk = warp / (WM * WN);
  const int g = lane / 4, t = lane % 4, wm = wt % WM, wn = wt / WM;
  const int steps = (K + MI_BK - 1) / MI_BK;
  auto issue = [&](int st) {
    unsigned char* As = smem + (st % STAGES) * T::STAGE;
    unsigned char* Bs = As + T::A_BYTES;
    const int k0 = st * MI_BK;
    constexpr int TH = T::THREADS, BM = T::BM;
    switch (a_w) {
      case 16: stage_a<16, TH, BM>(As, A, lda, m0, M, k0, K, tid); break;
      case 8: stage_a<8, TH, BM>(As, A, lda, m0, M, k0, K, tid); break;
      case 4: stage_a<4, TH, BM>(As, A, lda, m0, M, k0, K, tid); break;
      default: stage_a<1, TH, BM>(As, A, lda, m0, M, k0, K, tid);
    }
    switch (b_w) {
      case 16:
        stage_b<16, TH, BN>(Bs, B, ldb, grp, grp_stride, k0, K, n0, N, tid);
        break;
      case 8:
        stage_b<8, TH, BN>(Bs, B, ldb, grp, grp_stride, k0, K, n0, N, tid);
        break;
      case 4:
        stage_b<4, TH, BN>(Bs, B, ldb, grp, grp_stride, k0, K, n0, N, tid);
        break;
      default:
        stage_b<1, TH, BN>(Bs, B, ldb, grp, grp_stride, k0, K, n0, N, tid);
    }
  };
  // This lane's B words: rows 4t + r of each 16-deep half, bytes 4g ..
  // 4g + 3 of the warp's 32 columns (the permutation is 2t for them all).
  int bo[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    bo[r] = (((4 * t + r) * CPR + 2 * wn + (g >> 2)) ^ (2 * t)) * 16 +
            4 * (g & 3);
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i / 16][(i / 4) % 4][i % 4] = 0;
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < steps) issue(st);
    cp_async_commit();
  }
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<STAGES - 2>();
    Part::sync();                    // stage st is in; st - 1 is read
    if (st + STAGES - 1 < steps) issue(st + STAGES - 1);
    cp_async_commit();
    const unsigned char* As = smem + (st % STAGES) * T::STAGE;
    const unsigned char* Bs = As + T::A_BYTES;
#pragma unroll
    for (int kk = 32 * wk; kk < MI_BK; kk += 32 * KG) {
      uint32_t a[2][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(a[i], As + (32 * wm + 16 * i + lm_row(lane)) * MI_LDA +
                              kk + 16 * (lane / 16));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t w[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          w[r] = *reinterpret_cast<const uint32_t*>(Bs + (kk + 16 * h) * BN +
                                                    bo[r]);
        transpose4(w, b[h]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8_16832(acc[i][j], a[i], b[0][j], b[1][j]);
    }
  }
  cp_async_wait<0>();
  if constexpr (KG > 1) {
    // k groups 1.. hand their partial tiles to k group 0 through the ring
    // (int32 sums: exact in any order).
    int* red = reinterpret_cast<int*>(smem);
    Part::sync();
    if (wk > 0) {
#pragma unroll
      for (int e = 0; e < 32; ++e)
        red[(((wk - 1) * WM * WN + wt) * 32 + e) * 32 + lane] =
            acc[e / 16][(e / 4) % 4][e % 4];
    }
    Part::sync();
    if (wk > 0) return;
#pragma unroll
    for (int w = 1; w < KG; ++w)
#pragma unroll
      for (int e = 0; e < 32; ++e)
        acc[e / 16][(e / 4) % 4][e % 4] +=
            red[(((w - 1) * WM * WN + wt) * 32 + e) * 32 + lane];
  }
  // acc[i][j][e]: row 16 i + g (+ 8 for e >= 2), n-tile j's column 2t
  // (+ 1 for odd e), which is the warp's column 8t + 4 (e & 1) + j: a
  // lane holds 8 contiguous columns of each of its 4 rows.
  const float xs = x_scale ? *x_scale : 1.0f;
  const float qs = out_scale ? *out_scale : 1.0f;
  const int n = n0 + 32 * wn + 8 * t;
  float sc[8], bv[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    sc[c] = bv[c] = 0.f;
    if (n + c < N) i8_column(n + c, xs, w_scale, bias, sc[c], bv[c]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = m0 + 32 * wm + 16 * i + g + 8 * hr;
      if (m >= M) continue;
      int row[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) row[c] = acc[i][c % 4][2 * hr + c / 4];
      i8_epilogue<8>(C, ldc, out_kind, m, n, N, row, sc, bv,
                     bias != nullptr, res, ldr, gelu, qs);
    }
}

}  // namespace repro_torch

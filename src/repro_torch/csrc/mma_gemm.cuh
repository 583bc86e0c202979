// One output tile of the layer's GEMMs on the tensor cores, with a fused
// epilogue: C = [res +] act(A.B [+ bias]).  Used by mma_gemm.cu for
// kernel 1's concat, up and down products (kernels/vita_layer.py), and by
// the float layer-group kernel (vita_layer_group.cu) for the same three
// products of each member.
//
// Types: A is fp32 (SA, LN2's z, the GELU hidden), B and the bias WT
// (fp32 or bf16, bf16 weights used exactly, never rounded), the residual
// RT and C OT (fp32 or bf16): in the bf16 modes the last product of a
// layer adds the bf16 input x and writes the layer's output in x's type,
// every other output stays fp32.  Products are
// fp32-accurate split TF32 on mma.sync m16n8k8 (tf32_split.cuh): three
// passes with fp32 B, two with bf16 B (exact in TF32); the sums fp32.
//
// Design: a 32 x 64 output tile per block (DeiT-T batch 8's 1,568 rows give
// 49 x 3 = 147 blocks for the D-wide products, 588 for the up product);
// A [32 x BK] and B [BK x 64] staged by 16-byte cp.async into a 4-stage
// ring (BK = 32 with fp32 B, 64 with bf16 B; B rows as 16-byte chunks in
// either type, never as scalar 2-byte loads); rows padded so the fragment
// loads hit distinct banks.  16 warps: 2 (16 rows) x 2 (32 columns) x 4
// k-groups, k-group w taking 8-deep steps w, w + 4, ... of every stage
// (on the card a 6-stage ring of 32-deep steps ran no faster than a
// 3-stage one: per stage, barriers and latency, not the loads' depth, set
// the pace); the four partial tiles are added in k-group order through
// shared memory before the epilogue.
// Every edge (M, N, K) is zero filled.  The m and n extent of a tile do
// not enter an output element's sum (its k order is set by BK and the
// k-groups alone), so a caller may walk the tiles in any order.  A, C and
// res carry no __restrict__: in the group kernel they are workspace that
// other blocks wrote earlier in the same launch, which must not be read
// through the read-only cache.
#pragma once

#include "tf32_split.cuh"

namespace repro_torch {

constexpr int MG_BM = 32, MG_BN = 64, MG_STAGES = 4, MG_KGROUPS = 4,
              MG_THREADS = 128 * MG_KGROUPS;

// The ring of one block: stages of A [32][BK + 8] fp32 and B [BK][64 + 4
// (fp32) or + 8 (bf16)], BK = 32 with fp32 B and 64 with bf16 B (the
// deeper fp32 stage halves the blocks an SM holds and ran slower).
template <typename WT>
struct MgSmem {
  static constexpr int BK = sizeof(WT) == 4 ? 32 : 64;
  static constexpr int LDA = BK + 8;                              // floats
  static constexpr int LDB = MG_BN + (sizeof(WT) == 4 ? 4 : 8);  // elements
  static constexpr int A_BYTES = MG_BM * LDA * 4;
  static constexpr int STAGE = A_BYTES + BK * LDB * (int)sizeof(WT);
  static constexpr int BYTES = MG_STAGES * STAGE;
};

// Output tile (mt, nt) of C; every thread of a MG_THREADS block calls it.
// vecs: bit 0, A's rows are 16-byte aligned; bit 1, B's are.  Warps of
// k-groups 1-3 return before k-group 0 has read their partial sums: a
// caller that runs another tile in the same shared memory syncs the block
// first.
template <typename WT, typename RT, typename OT>
__device__ __forceinline__ void mma_gemm_tile(
    unsigned char* smem, int mt, int nt, const float* A, long long lda,
    const WT* __restrict__ B, long long ldb, OT* C, long long ldc, int M,
    int N, int K, const WT* __restrict__ bias, const RT* res, long long ldr,
    int gelu, int vecs) {
  using S = MgSmem<WT>;
  constexpr bool EXACT_B = sizeof(WT) == 2;
  const int m0 = mt * MG_BM, n0 = nt * MG_BN;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, wm = warp % 2, wn = (warp / 2) % 2, wk = warp / 4;
  constexpr int BK = S::BK;
  const int steps = (K + BK - 1) / BK;
  auto issue = [&](int st) {
    unsigned char* stg = smem + (st % MG_STAGES) * S::STAGE;
    const int k0 = st * BK;
    if (vecs & 1)
      load_tile_fast<float, MG_THREADS, MG_BM, BK>(stg, S::LDA * 4, A, lda,
                                                   m0, M, k0, K);
    else
      load_tile<float, MG_THREADS>(stg, S::LDA * 4, A, lda, m0, M, k0, K,
                                   MG_BM, BK, false);
    if (vecs & 2)
      load_tile_fast<WT, MG_THREADS, BK, MG_BN>(
          stg + S::A_BYTES, S::LDB * (int)sizeof(WT), B, ldb, k0, K, n0, N);
    else
      load_tile<WT, MG_THREADS>(stg + S::A_BYTES, S::LDB * (int)sizeof(WT),
                                B, ldb, k0, K, n0, N, BK, MG_BN, false);
  };
  SplitAcc acc[2][2];  // [16-column block][even / odd tile]
#pragma unroll
  for (int i = 0; i < 4; ++i) split_zero(acc[i / 2][i % 2]);
  for (int st = 0; st < MG_STAGES - 1; ++st) {
    if (st < steps) issue(st);
    cp_async_commit();
  }
  for (int st = 0; st < steps; ++st) {
    if (st + MG_STAGES - 1 < steps) issue(st + MG_STAGES - 1);
    cp_async_commit();
    cp_async_wait<MG_STAGES - 1>();
    __syncthreads();
    const unsigned char* stg = smem + (st % MG_STAGES) * S::STAGE;
    const float* As = reinterpret_cast<const float*>(stg);
    const WT* Bs = reinterpret_cast<const WT*>(stg + S::A_BYTES);
#pragma unroll
    for (int j = 0; j < BK / 8 / MG_KGROUPS; ++j) {
      const int k = 8 * (wk + MG_KGROUPS * j);
      const SplitA a = load_split_a(As, S::LDA, 16 * wm + g, k);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const PairB bb = load_pair_b(Bs, S::LDB, k, 32 * wn + 16 * i);
        mma_split<EXACT_B>(acc[i][0], a, bb, 0);
        mma_split<EXACT_B>(acc[i][1], a, bb, 1);
      }
    }
    __syncthreads();
  }
  // k-groups 1-3 hand their partial tiles to k-group 0 through the ring.
  float* red = reinterpret_cast<float*>(smem);
  const int tg = threadIdx.x % 128;
  cp_async_wait<0>();
  if (wk > 0) {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      red[((wk - 1) * 16 + e) * 128 + tg] =
          split_value(acc[e / 8][(e / 4) % 2], e % 4);
  }
  __syncthreads();
  if (wk > 0) return;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + 16 * wm + g + 8 * (e >> 1);
        const int n = n0 + pair_col(32 * wn + 16 * i, half, e);
        if (m >= M || n >= N) continue;
        float v = split_value(acc[i][half], e);
#pragma unroll
        for (int w = 0; w < MG_KGROUPS - 1; ++w)
          v += red[(w * 16 + 8 * i + 4 * half + e) * 128 + tg];
        if (bias) v = v + to_f(bias[n]);
        if (gelu) v = gelu_tanh(v);
        if (res) v = to_f(res[(long long)m * ldr + n]) + v;
        store_f(C, (long long)m * ldc + n, v, nullptr);
      }
}

}  // namespace repro_torch

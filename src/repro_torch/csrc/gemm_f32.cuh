// One output tile of the fp32 GEMM with a fused epilogue:
//   C = [res +] act(A.B [+ bias]).
// Shared by gemm_f32.cu (one tile per block) and vita_layer_group.cu (the
// persistent group kernel walks the tiles of each stage).
//
// Design: 64x64 output tile per 256 threads, 16-deep k slices staged in
// shared memory as fp32 (A transposed so both operands are read as
// broadcasts or consecutive words), 4x4 outputs per thread accumulated with
// fmaf in k order.
//
// Types: A is always fp32 (every A in the layer chain is an fp32
// intermediate: z, SA, LN2's z, the GELU hidden).  B and the bias are WT
// (float or bf16, read into fp32 on staging: bf16 weights are used exactly,
// never rounded), the residual RT and C OT (float or bf16): in the bf16
// modes the last product of a layer adds the bf16 input x and writes the
// layer's output in x's type, every other output stays fp32.  Every edge (M = B*196, N = 1000 classes, K) is masked with zero
// fill.  CUDA cores only: wgmma/TMA are a later PR's work.
//
// B is addressed in column groups so that per-head (H, D, Dh) weight stacks
// are read in place: element (k, n) lives at
//   B[(n / grp) * grp_stride + k * ldb + (n % grp)]
// (a plain row-major (K, N) matrix is grp = N, ldb = N).
//
// The pointers carry no __restrict__: in the group kernel A, C and res are
// workspace that other blocks wrote earlier in the same launch, which must
// not be read through the read-only cache.
#pragma once

#include "common.cuh"

namespace repro_torch {

constexpr int GF_BM = 64, GF_BN = 64, GF_BK = 16;

struct GemmF32Smem {
  float As[GF_BK][GF_BM];
  float Bs[GF_BK][GF_BN];
};

// Output tile (mt, nt) of C; every thread of a 256-thread block calls it.
template <typename WT, typename RT, typename OT>
__device__ __forceinline__ void gemm_f32_tile(
    GemmF32Smem& s, int mt, int nt, const float* A, long long lda,
    const WT* B, long long ldb, int grp, long long grp_stride, OT* C,
    long long ldc, int M, int N, int K, const WT* bias, const RT* res,
    long long ldr, int gelu) {
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int m0 = mt * GF_BM, n0 = nt * GF_BN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += GF_BK) {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      int idx = t + 256 * l;
      int r = idx / GF_BK, c = idx % GF_BK;
      int m = m0 + r, k = k0 + c;
      s.As[c][r] = (m < M && k < K) ? A[(long long)m * lda + k] : 0.f;
      int kk = idx / GF_BN, nn = idx % GF_BN;
      int n = n0 + nn;
      k = k0 + kk;
      s.Bs[kk][nn] = (n < N && k < K)
                         ? to_f(B[(long long)(n / grp) * grp_stride + (long long)k * ldb + (n % grp)])
                         : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GF_BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s.As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = s.Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      float v = acc[i][j];
      if (bias) v = v + to_f(bias[n]);
      if (gelu) v = gelu_tanh(v);
      if (res) v = to_f(res[(long long)m * ldr + n]) + v;
      store_f(C, (long long)m * ldc + n, v, nullptr);
    }
  }
}

}  // namespace repro_torch

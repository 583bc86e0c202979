// One output tile of the int8 x int8 -> int32 GEMM with a requant
// epilogue.  Shared by gemm_i8.cu (one tile per block) and
// vita_layer_group.cu (the persistent group kernel walks each stage's
// tiles).
//
// Design: 64x64 output tile per 256 threads, 32-deep k slices staged in
// shared memory with both operands k-contiguous (B transposed on load) so
// one 32-bit word feeds one __dp4a; rows padded to 36 bytes so the
// per-column reads hit distinct banks.  Ragged M, N and K zero-fill, which
// leaves the integer sums exact.
//
// Epilogue (out_kind): 0 writes the raw int32 accumulator; 1 writes
//   v = acc * (x_scale * w_scale[n])  [+ bias[n]]  [-> gelu]  [res + v]
// as float; 2 writes the same v quantised to int8 at *out_scale.  Missing
// scales count as 1.  The bias is BT: float, or bf16 read into fp32 (a
// bf16 model's biases stay bf16 under PTQ, as the TPU kernels' in-kernel
// astype(float32) reads them).  B is addressed in column groups as in gemm_f32.cuh,
// and, as there, no pointer carries __restrict__.
#pragma once

#include "common.cuh"

namespace repro_torch {

constexpr int GI_BM = 64, GI_BN = 64, GI_BK = 32, GI_PADK = GI_BK + 4;

struct __align__(16) GemmI8Smem {
  int8_t As[GI_BM][GI_PADK];
  int8_t Bs[GI_BN][GI_PADK];
};

// Output tile (mt, nt) of C; every thread of a 256-thread block calls it.
template <typename BT>
__device__ __forceinline__ void gemm_i8_tile(
    GemmI8Smem& s, int mt, int nt, const int8_t* A, long long lda,
    const int8_t* B, long long ldb, int grp, long long grp_stride, void* C,
    long long ldc, int out_kind, int M, int N, int K, const float* x_scale,
    const float* w_scale, const BT* bias, const float* res, long long ldr,
    int gelu, const float* out_scale) {
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int m0 = mt * GI_BM, n0 = nt * GI_BN;
  int acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += GI_BK) {
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      int idx = t + 256 * l;
      int r = idx / GI_BK, c = idx % GI_BK;
      int m = m0 + r, k = k0 + c;
      s.As[r][c] = (m < M && k < K) ? A[(long long)m * lda + k] : (int8_t)0;
      int kk = idx / GI_BN, nn = idx % GI_BN;
      int n = n0 + nn;
      k = k0 + kk;
      s.Bs[nn][kk] = (n < N && k < K)
                         ? B[(long long)(n / grp) * grp_stride + (long long)k * ldb + (n % grp)]
                         : (int8_t)0;
    }
    __syncthreads();
#pragma unroll
    for (int k4 = 0; k4 < GI_BK / 4; ++k4) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const int*>(&s.As[ty + 16 * i][4 * k4]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const int*>(&s.Bs[tx + 16 * j][4 * k4]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  const float xs = x_scale ? *x_scale : 1.0f;
  const float qs = out_scale ? *out_scale : 1.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      long long o = (long long)m * ldc + n;
      if (out_kind == 0) {
        static_cast<int*>(C)[o] = acc[i][j];
        continue;
      }
      float sc = xs * (w_scale ? w_scale[n] : 1.0f);
      float v = (float)acc[i][j] * sc;
      if (bias) v = v + to_f(bias[n]);
      if (gelu) v = gelu_tanh(v);
      if (res) v = res[(long long)m * ldr + n] + v;
      if (out_kind == 1)
        static_cast<float*>(C)[o] = v;
      else
        static_cast<int8_t*>(C)[o] = quant_i8(v, qs);
    }
  }
}

}  // namespace repro_torch

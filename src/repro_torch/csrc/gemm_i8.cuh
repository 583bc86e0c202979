// One output tile of the int8 x int8 -> int32 GEMM with a requant
// epilogue on CUDA cores (__dp4a), and that epilogue, `i8_epilogue`, which
// the tensor-core tile (mma_gemm_i8.cuh, gemm_i8.cu's) shares.  The tile
// runs in the int8 layer-group kernel (vita_layer_group.cu), which walks
// each stage's tiles; the per-layer int8 chain runs the tensor-core tile.
// Both give every output bit for bit alike: the int32 sums are exact in
// any order, and the epilogue is this one function.
//
// Design: 64x64 output tile per 256 threads, 32-deep k slices staged in
// shared memory with both operands k-contiguous (B transposed on load) so
// one 32-bit word feeds one __dp4a; rows padded to 36 bytes so the
// per-column reads hit distinct banks.  Ragged M, N and K zero-fill, which
// leaves the integer sums exact.
//
// Epilogue (out_kind, `i8_epilogue`): 0 writes the raw int32 accumulator;
// 1 writes
//   v = acc * (x_scale * w_scale[n])  [+ bias[n]]  [-> gelu]  [res + v]
// as float; 2 writes the same v quantised to int8 at *out_scale.  Missing
// scales count as 1.  The bias is BT: float, or bf16 read into fp32 (a
// bf16 model's biases stay bf16 under PTQ, as the TPU kernels' in-kernel
// astype(float32) reads them).  B is addressed in column groups so that
// per-head (H, D, Dh) weight stacks are read in place: element (k, n)
// lives at B[(n / grp) * grp_stride + k * ldb + (n % grp)] (a plain
// row-major (K, N) matrix is grp = N, ldb = N).  No pointer carries
// __restrict__: in the group kernel A, C and res are workspace that other
// blocks wrote earlier in the same launch.
#pragma once

#include "common.cuh"

namespace repro_torch {

constexpr int GI_BM = 64, GI_BN = 64, GI_BK = 32, GI_PADK = GI_BK + 4;

// The epilogue's terms of output column n: sc = x_scale * w_scale[n] and
// the bias read into fp32 (0 where there is none); xs is *x_scale (1
// where missing).
template <typename BT>
__device__ __forceinline__ void i8_column(int n, float xs,
                                          const float* w_scale,
                                          const BT* bias, float& sc,
                                          float& bv) {
  sc = __fmul_rn(xs, w_scale ? w_scale[n] : 1.0f);
  bv = bias ? to_f(bias[n]) : 0.f;
}

// Outputs (m, n .. n + W - 1) of the int8 GEMM from their int32 sums acc
// and their columns' terms (`i8_column`); only columns below N are
// written.  Each product and sum is rounded on its own (no fused
// multiply-add), as the plain version computes them, wherever the caller
// inlines this.  W contiguous columns of a row go out in 16- or 8-byte
// stores where they are whole and aligned.  qs is *out_scale (1 where
// missing).
template <int W>
__device__ __forceinline__ void i8_epilogue(
    void* C, long long ldc, int out_kind, int m, int n, int N,
    const int (&acc)[W], const float (&sc)[W], const float (&bv)[W],
    bool has_bias, const float* res, long long ldr, int gelu, float qs) {
  const long long o = (long long)m * ldc + n;
  const bool whole = W > 1 && n + W <= N;
  if (out_kind == 0) {
    int* c = static_cast<int*>(C) + o;
    if (whole && reinterpret_cast<uintptr_t>(c) % 16 == 0) {
#pragma unroll
      for (int j = 0; j < W; j += 4)
        *reinterpret_cast<int4*>(c + j) =
            make_int4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < W; ++j)
        if (n + j < N) c[j] = acc[j];
    }
    return;
  }
  float v[W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    v[j] = __fmul_rn((float)acc[j], sc[j]);
    if (has_bias) v[j] = __fadd_rn(v[j], bv[j]);
    if (gelu) v[j] = gelu_tanh(v[j]);
    if (res && n + j < N)
      v[j] = __fadd_rn(res[(long long)m * ldr + n + j], v[j]);
  }
  if (out_kind == 1) {
    float* c = static_cast<float*>(C) + o;
    if (whole && reinterpret_cast<uintptr_t>(c) % 16 == 0) {
#pragma unroll
      for (int j = 0; j < W; j += 4)
        *reinterpret_cast<float4*>(c + j) =
            make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < W; ++j)
        if (n + j < N) c[j] = v[j];
    }
    return;
  }
  int8_t* c = static_cast<int8_t*>(C) + o;
  int8_t q[W];
#pragma unroll
  for (int j = 0; j < W; ++j) q[j] = quant_i8(v[j], qs);
  if constexpr (W % 8 == 0) {
    if (whole && reinterpret_cast<uintptr_t>(c) % 8 == 0) {
#pragma unroll
      for (int j = 0; j < W; j += 8) {
        uint32_t u[2] = {0u, 0u};
#pragma unroll
        for (int e = 0; e < 8; ++e)
          u[e / 4] |= (uint32_t)(uint8_t)q[j + e] << (8 * (e % 4));
        *reinterpret_cast<uint2*>(c + j) = make_uint2(u[0], u[1]);
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < W; ++j)
    if (n + j < N) c[j] = q[j];
}

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
      int a1[1] = {acc[i][j]};
      float sc[1], bv[1];
      i8_column(n, xs, w_scale, bias, sc[0], bv[0]);
      i8_epilogue<1>(C, ldc, out_kind, m, n, N, a1, sc, bv, bias != nullptr,
                     res, ldr, gelu, qs);
    }
  }
}

}  // namespace repro_torch

// The requant epilogue of the int8 x int8 -> int32 GEMM, `i8_epilogue`,
// and its per-column terms, `i8_column`: shared by the int8 tensor-core
// tile (mma_gemm_i8.cuh), which gemm_i8.cu (kernel 4 and the per-layer
// int8 chain) and the int8 layer group (vita_layer_group.cu) run, so both
// give every output bit for bit alike: the int32 sums are exact in any
// order, and the epilogue is this one function.
//
// Epilogue (out_kind, `i8_epilogue`): 0 writes the raw int32 accumulator;
// 1 writes
//   v = acc * (x_scale * w_scale[n])  [+ bias[n]]  [-> gelu]  [res + v]
// as float; 2 writes the same v quantised to int8 at *out_scale.  Missing
// scales count as 1.  The bias is BT: float, or bf16 read into fp32 (a
// bf16 model's biases stay bf16 under PTQ, as the TPU kernels' in-kernel
// astype(float32) reads them).  No pointer carries __restrict__: in the
// group kernel C and res are workspace that other blocks wrote earlier in
// the same launch.
#pragma once

#include "common.cuh"

namespace repro_torch {

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

}  // namespace repro_torch

// One row of LayerNorm, computed by one warp, optionally quantised to int8
// on the way out.  Shared by layer_norm.cu and vita_layer_group.cu.
//
// Two passes over the row held in global memory (population variance, eps
// as given), in fp32 whatever the types: x is XT (float or bf16), the LN
// vectors VT (float or bf16), each read into fp32, as the TPU kernels'
// `_ln` upcasts.  out is float (rows, d) when q_scale is null (the TPU
// kernel's fp32 z scratch), else int8 quantised at *q_scale.  No pointer
// carries __restrict__ (see attention.cuh).
#pragma once

#include "common.cuh"

namespace repro_torch {

template <typename XT, typename VT>
__device__ __forceinline__ void layer_norm_row(const XT* x, const VT* w,
                                               const VT* b, void* out,
                                               int row, int d, float eps,
                                               const float* q_scale) {
  const int lane = threadIdx.x % 32;
  const XT* xr = x + (size_t)row * d;
  float s = 0.f;
  for (int i = lane; i < d; i += 32) s += to_f(xr[i]);
  const float mu = warp_sum(s) / (float)d;
  float v = 0.f;
  for (int i = lane; i < d; i += 32) {
    float t = to_f(xr[i]) - mu;
    v += t * t;
  }
  const float var = warp_sum(v) / (float)d;
  const float inv = 1.0f / sqrtf(var + eps);
  const size_t o = (size_t)row * d;
  for (int i = lane; i < d; i += 32) {
    const float y = (to_f(xr[i]) - mu) * inv * to_f(w[i]) + to_f(b[i]);
    if (q_scale == nullptr)
      store_f(static_cast<float*>(out), o + i, y, nullptr);
    else
      store_f(static_cast<int8_t*>(out), o + i, y, q_scale);
  }
}

}  // namespace repro_torch

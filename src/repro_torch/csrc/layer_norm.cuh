// One row of LayerNorm, computed by one warp, optionally quantised to int8
// on the way out.  Shared by layer_norm.cu and vita_layer_group.cu.
//
// Two passes over the row held in global memory (population variance, eps
// as given).  out is float (rows, d) when q_scale is null, else int8
// quantised at *q_scale.  No pointer carries __restrict__ (see
// gemm_f32.cuh).
#pragma once

#include "common.cuh"

namespace repro_torch {

__device__ __forceinline__ void layer_norm_row(const float* x, const float* w,
                                               const float* b, void* out,
                                               int row, int d, float eps,
                                               const float* q_scale) {
  const int lane = threadIdx.x % 32;
  const float* xr = x + (size_t)row * d;
  float s = 0.f;
  for (int i = lane; i < d; i += 32) s += xr[i];
  const float mu = warp_sum(s) / (float)d;
  float v = 0.f;
  for (int i = lane; i < d; i += 32) {
    float t = xr[i] - mu;
    v += t * t;
  }
  const float var = warp_sum(v) / (float)d;
  const float inv = 1.0f / sqrtf(var + eps);
  if (q_scale == nullptr) {
    float* o = static_cast<float*>(out) + (size_t)row * d;
    for (int i = lane; i < d; i += 32) o[i] = (xr[i] - mu) * inv * w[i] + b[i];
  } else {
    const float qs = *q_scale;
    int8_t* o = static_cast<int8_t*>(out) + (size_t)row * d;
    for (int i = lane; i < d; i += 32)
      o[i] = quant_i8((xr[i] - mu) * inv * w[i] + b[i], qs);
  }
}

}  // namespace repro_torch

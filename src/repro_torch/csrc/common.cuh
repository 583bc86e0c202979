// Shared device helpers for the port's kernels.
//
// Numerics follow the JAX reference exactly in form:
//   * GELU is jax.nn.gelu's tanh approximation, x*(0.5*(1+tanh(c*(x+0.044715x^3))));
//   * int8 quantisation is clip(round_half_even(v / scale), +-127) with an
//     IEEE division (the build never passes --use_fast_math) and rintf;
//   * the int8 rescale multiplies the accumulator by (x_scale * w_scale),
//     the product of scales taken first.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro_torch {

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2/pi) rounded to float32
  float cdf = 0.5f * (1.0f + tanhf(c * (x + 0.044715f * (x * x * x))));
  return x * cdf;
}

__device__ __forceinline__ int8_t quant_i8(float v, float scale) {
  float r = rintf(v / scale);
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<int8_t>(r);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace repro_torch

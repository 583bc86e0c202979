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
#include <cuda_bf16.h>
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

// Element types: float32 or bfloat16 in memory, float32 in registers.
// Codes match the wrappers' `DTYPE_CODES` (kernels/int8_matmul.py).
enum ElemCode { kF32 = 0, kBF16 = 1 };

// Loads: an element of either type, read into fp32.
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}
// v rounded to T and back: the TPU kernels' astype(x.dtype) before a product.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// Stores of an fp32 result: float, bf16 (rounded to nearest even), or int8
// quantised at *q_scale (the requant chain's outputs).
__device__ __forceinline__ void store_f(float* out, long long i, float v,
                                        const float*) {
  out[i] = v;
}
__device__ __forceinline__ void store_f(__nv_bfloat16* out, long long i,
                                        float v, const float*) {
  out[i] = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_f(int8_t* out, long long i, float v,
                                        const float* q_scale) {
  out[i] = quant_i8(v, *q_scale);
}

// Host-side dispatch of a vision kernel's dtype mode (ref.PORTED_MODES):
// calls f(Tag<activation type>, Tag<weight type>) for the codes of
// float32 / float32, float32 / bf16 and bf16 / bf16; any other pair is
// refused with cudaErrorInvalidValue.
template <typename T> struct Tag { using type = T; };

template <typename F> int dispatch_mode(int xt, int wt, F&& f) {
  if (xt == kF32 && wt == kF32) return f(Tag<float>{}, Tag<float>{});
  if (xt == kF32 && wt == kBF16) return f(Tag<float>{}, Tag<__nv_bfloat16>{});
  if (xt == kBF16 && wt == kBF16)
    return f(Tag<__nv_bfloat16>{}, Tag<__nv_bfloat16>{});
  return (int)cudaErrorInvalidValue;
}

// One element type from its code (float32 or bf16), as a Tag; other codes
// are refused.
template <typename F> int dispatch_type(int code, F&& f) {
  if (code == kF32) return f(Tag<float>{});
  if (code == kBF16) return f(Tag<__nv_bfloat16>{});
  return (int)cudaErrorInvalidValue;
}

// MLP activations, in the order of ref.ACTIVATIONS.
__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case 0: return gelu_tanh(x);
    case 1: return fmaxf(x, 0.f);
    case 2: { const float r = fmaxf(x, 0.f); return r * r; }
    case 3: return x / (1.0f + expf(-x));
    default: return x;
  }
}

}  // namespace repro_torch

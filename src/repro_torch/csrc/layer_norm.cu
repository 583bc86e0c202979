// Row LayerNorm, optionally quantised to int8 on the way out.
//
// Replaces: the LN1/LN2 steps inside repro/kernels/vita_layer.py
// (_vita_layer_kernel, _vita_layer_int8_kernel), which the TPU ran once per
// image with z resident in VMEM across the head steps.  On Hopper the
// normalised rows go to device memory (L2-resident at these sizes) and the
// GEMMs read them back: "nothing leaves the grid" is dropped here.
// Bound: bytes (one read of x, one write of z; ~10 flops per element).
// Design: one warp per row, two passes over the row held in global memory
// (population variance, eps as given), rows spread over 8 warps a block.
#include "common.cuh"

namespace repro_torch {

__global__ void layer_norm_kernel(const float* __restrict__ x,
                                  const float* __restrict__ w,
                                  const float* __restrict__ b,
                                  void* __restrict__ out, int rows, int d,
                                  float eps, const float* __restrict__ q_scale) {
  const int warps = blockDim.x / 32;
  const int row = blockIdx.x * warps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
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

// out: float (rows, d) when q_scale is null, else int8 quantised at *q_scale.
extern "C" int rt_layer_norm(const float* x, const float* w, const float* b,
                             void* out, int rows, int d, float eps,
                             const float* q_scale, void* stream) {
  const int warps = 8;
  dim3 grid((rows + warps - 1) / warps);
  repro_torch::layer_norm_kernel<<<grid, warps * 32, 0, (cudaStream_t)stream>>>(
      x, w, b, out, rows, d, eps, q_scale);
  return (int)cudaGetLastError();
}

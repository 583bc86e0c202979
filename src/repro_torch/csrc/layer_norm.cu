// Row LayerNorm, optionally quantised to int8 on the way out.
//
// Replaces: the LN1/LN2 steps inside repro/kernels/vita_layer.py
// (_vita_layer_kernel, _vita_layer_int8_kernel), which the TPU ran once per
// image with z resident in VMEM across the head steps.  On Hopper the
// normalised rows go to device memory (L2-resident at these sizes) and the
// GEMMs read them back: "nothing leaves the grid" is dropped here.
// Bound: bytes (one read of x, one write of z; ~10 flops per element).
// Design: one warp per row (`layer_norm_row`, layer_norm.cuh, shared with
// the layer-group kernel), rows spread over 8 warps a block.
#include "layer_norm.cuh"

namespace repro_torch {

__global__ void layer_norm_kernel(const float* __restrict__ x,
                                  const float* __restrict__ w,
                                  const float* __restrict__ b,
                                  void* __restrict__ out, int rows, int d,
                                  float eps, const float* __restrict__ q_scale) {
  const int warps = blockDim.x / 32;
  const int row = blockIdx.x * warps + threadIdx.x / 32;
  if (row >= rows) return;
  layer_norm_row(x, w, b, out, row, d, eps, q_scale);
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

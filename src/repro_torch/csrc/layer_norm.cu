// Row LayerNorm, optionally quantised to int8 on the way out.
//
// Replaces: the LN1/LN2 steps inside repro/kernels/vita_layer.py
// (_vita_layer_kernel, _vita_layer_int8_kernel), which the TPU ran once per
// image with z resident in VMEM across the head steps.  On Hopper the
// normalised rows go to device memory (L2-resident at these sizes) and the
// GEMMs read them back: "nothing leaves the grid" is dropped here.
// Bound: bytes (one read of x, one write of z; ~10 flops per element).
// Design: one warp per row (`layer_norm_row`, layer_norm.cuh, shared with
// the layer-group kernel), rows spread over 8 warps a block.  x and the LN
// vectors are float32 or bf16 (`dispatch_mode`: the vision modes); z is
// always fp32 (or int8), as the TPU kernel's z scratch.
#include "layer_norm.cuh"

namespace repro_torch {

template <typename XT, typename VT>
__global__ void layer_norm_kernel(const XT* __restrict__ x,
                                  const VT* __restrict__ w,
                                  const VT* __restrict__ b,
                                  void* __restrict__ out, int rows, int d,
                                  float eps, const float* __restrict__ q_scale) {
  const int warps = blockDim.x / 32;
  const int row = blockIdx.x * warps + threadIdx.x / 32;
  if (row >= rows) return;
  layer_norm_row(x, w, b, out, row, d, eps, q_scale);
}

}  // namespace repro_torch

// out: float (rows, d) when q_scale is null, else int8 quantised at
// *q_scale; xt / vt: the ElemCode of x and of the LN vectors.
extern "C" int rt_layer_norm(const void* x, const void* w, const void* b,
                             void* out, int rows, int d, float eps,
                             const float* q_scale, int xt, int vt,
                             void* stream) {
  using namespace repro_torch;
  const int warps = 8;
  dim3 grid((rows + warps - 1) / warps);
  return dispatch_mode(xt, vt, [&](auto xtag, auto vtag) {
    using XT = typename decltype(xtag)::type;
    using VT = typename decltype(vtag)::type;
    layer_norm_kernel<XT, VT><<<grid, warps * 32, 0, (cudaStream_t)stream>>>(
        (const XT*)x, (const VT*)w, (const VT*)b, out, rows, d, eps, q_scale);
    return (int)cudaGetLastError();
  });
}

// Exact per-head softmax attention for ViT sequence lengths, global or
// windowed (Swin).
//
// Replaces: the engine-2 core (repro/kernels/vita_msa.py::softmax_av) as
// used inside repro/kernels/vita_layer.py::vita_layer / vita_layer_int8 and
// repro/kernels/vita_msa.py::vita_msa_int8.  The TPU ran one (image, head)
// per sequential grid step with the whole head's Q/K/V/S in VMEM.  Here
// each block takes one (image, head, 32-query tile) in parallel and holds
// that head's K and V (N x Dh fp32 each: 98 KiB at N=196, Dh=64; 128 KiB at
// N=256) in dynamic shared memory.  The work item is `attention_tile`
// (attention.cuh), shared with the layer-group kernel; its rows are
// `attend_row`, shared with vita_msa.cu.
// Bound: operations at DeiT-T/ViT-B widths (4*N*N*Dh flops per head against
// 4*N*Dh*4 bytes in and out), on CUDA cores.  K/V are re-read once per
// query tile (ceil(N/32) times per head), from L2.
//
// Windowed mode (Swin): the caller folds windows into the batch axis, so
// "image" b is window b % nW of an image, and passes the relative-position
// bias (H, N, N) and the region mask (nW, N, N); row n of head h in batch
// row b adds bias[h][n][:] + mask[b % nW][n][:] to its scores after the
// scale, as the TPU kernel adds its `extra` term.  Both null: global mode.
//
// q/k/v share one stride set: element e of token n, head h, image b is at
// base[b*sb + n*sn + h*sh + e].  out uses (ob, on, oh) the same way and is
// float, or int8 quantised at *out_scale when out_scale is not null.
#include "attention.cuh"

namespace repro_torch {

__global__ void __launch_bounds__(ATT_WARPS * 32)
attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, long long sb, long long sn,
                 long long sh, void* __restrict__ out, long long ob,
                 long long on, long long oh, int N, int Dh, float scale,
                 const float* __restrict__ out_scale,
                 const float* __restrict__ bias,
                 const float* __restrict__ mask, int nW) {
  extern __shared__ float smem[];
  attention_tile(smem, q, k, v, sb, sn, sh, out, ob, on, oh, N, Dh, scale,
                 out_scale, bias, mask, nW, blockIdx.x, blockIdx.y, blockIdx.z);
}

}  // namespace repro_torch

extern "C" int rt_attention(const float* q, const float* k, const float* v,
                            long long sb, long long sn, long long sh, void* out,
                            long long ob, long long on, long long oh, int B,
                            int H, int N, int Dh, float scale,
                            const float* out_scale, const float* bias,
                            const float* mask, int nW, void* stream) {
  using namespace repro_torch;
  size_t smem = sizeof(float) * attention_smem_floats(N, Dh);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + ATT_QTILE - 1) / ATT_QTILE, H, B);
  attention_kernel<<<grid, ATT_WARPS * 32, smem, (cudaStream_t)stream>>>(
      q, k, v, sb, sn, sh, out, ob, on, oh, N, Dh, scale, out_scale, bias,
      mask, nW);
  return (int)cudaGetLastError();
}

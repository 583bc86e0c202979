// Tiled int8 x int8 -> int32 GEMM with a requant epilogue.
//
// Replaces: repro/kernels/int8_matmul.py::int8_matmul (tiled MXU product
// with x_scale * w_scale[n] fused into the last k-step), and the int8
// matmuls inside repro/kernels/vita_layer.py::vita_layer_int8 and
// repro/kernels/vita_msa.py::vita_msa_int8.  The TPU kept the int32 concat
// accumulator in VMEM across the head grid; here the concat projection is
// one GEMM over the requantised (B*N, H*Dh) attention output, so the int32
// sum over heads is taken inside one dot product instead.
// Bound: at the embed shape (1568x768x192) bytes (~1.6 MB for 0.46 GOP);
// at the layer shapes operations.  int8 here runs on CUDA cores with
// __dp4a (4 MACs per instruction), not the int8 tensor cores.
// Design: one block per 64x64 output tile; the tile and its epilogue
// (out_kind 0: int32, 1: rescaled float, 2: requantised int8) are
// `gemm_i8_tile` (gemm_i8.cuh), shared with the layer-group kernel; the
// bias is float or bf16 (bt).
#include "gemm_i8.cuh"

namespace repro_torch {

template <typename BT>
__global__ void __launch_bounds__(256)
gemm_i8_kernel(const int8_t* __restrict__ A, long long lda,
               const int8_t* __restrict__ B, long long ldb, int grp,
               long long grp_stride, void* __restrict__ C, long long ldc,
               int out_kind, int M, int N, int K,
               const float* __restrict__ x_scale, const float* __restrict__ w_scale,
               const BT* __restrict__ bias, const float* __restrict__ res,
               long long ldr, int gelu, const float* __restrict__ out_scale) {
  __shared__ GemmI8Smem s;
  gemm_i8_tile(s, blockIdx.y, blockIdx.x, A, lda, B, ldb, grp, grp_stride, C,
               ldc, out_kind, M, N, K, x_scale, w_scale, bias, res, ldr, gelu,
               out_scale);
}

}  // namespace repro_torch

extern "C" int rt_gemm_i8(const int8_t* A, long long lda, const int8_t* B,
                          long long ldb, int grp, long long grp_stride, void* C,
                          long long ldc, int out_kind, int M, int N, int K,
                          const float* x_scale, const float* w_scale,
                          const void* bias, const float* res, long long ldr,
                          int gelu, const float* out_scale, int bt,
                          void* stream) {
  using namespace repro_torch;
  dim3 grid((N + GI_BN - 1) / GI_BN, (M + GI_BM - 1) / GI_BM);
  return dispatch_type(bt, [&](auto btag) {
    using BT = typename decltype(btag)::type;
    gemm_i8_kernel<BT><<<grid, 256, 0, (cudaStream_t)stream>>>(
        A, lda, B, ldb, grp, grp_stride, C, ldc, out_kind, M, N, K, x_scale,
        w_scale, (const BT*)bias, res, ldr, gelu, out_scale);
    return (int)cudaGetLastError();
  });
}

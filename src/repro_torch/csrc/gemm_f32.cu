// Tiled fp32 GEMM with a fused epilogue: C = [res +] act(A.B [+ bias]).
//
// Replaces: the float matmuls inside repro/kernels/vita_layer.py::vita_layer
// (per-head Q/K/V, the head-sliced concat projection accumulated in VMEM,
// both MLP matmuls in the h == H-1 tail).  The TPU carried the concat
// accumulator across a sequential head grid; Hopper blocks run in parallel
// and carry nothing, so the concat projection is one GEMM over the merged
// (B*N, H*Dh) attention output and the residual add moves into its epilogue.
// Bound: operations.  At DeiT-T widths one layer's GEMMs are ~0.2 GFLOP per
// image against ~2 MB of operands, far above the fp32 ridge (67 TFLOP/s
// over 3.35 TB/s = 20 flop/byte); with bf16 weights the sums stay fp32 on
// CUDA cores, so the fp32 rate still bounds it.
// Design: one block per 64x64 output tile; the tile itself is
// `gemm_f32_tile` (gemm_f32.cuh), shared with the layer-group kernel.  The
// weight and bias type (wt), the residual's (rt) and the output's (ot) are
// float or bf16 each; A is fp32.
#include "gemm_f32.cuh"

namespace repro_torch {

template <typename WT, typename RT, typename OT>
__global__ void __launch_bounds__(256)
gemm_f32_kernel(const float* __restrict__ A, long long lda,
                const WT* __restrict__ B, long long ldb, int grp,
                long long grp_stride, OT* __restrict__ C, long long ldc,
                int M, int N, int K, const WT* __restrict__ bias,
                const RT* __restrict__ res, long long ldr, int gelu) {
  __shared__ GemmF32Smem s;
  gemm_f32_tile(s, blockIdx.y, blockIdx.x, A, lda, B, ldb, grp, grp_stride, C,
                ldc, M, N, K, bias, res, ldr, gelu);
}

}  // namespace repro_torch

// wt / rt / ot: the ElemCode of B and bias, of res, and of C.
extern "C" int rt_gemm_f32(const float* A, long long lda, const void* B,
                           long long ldb, int grp, long long grp_stride, void* C,
                           long long ldc, int M, int N, int K, const void* bias,
                           const void* res, long long ldr, int gelu, int wt,
                           int rt, int ot, void* stream) {
  using namespace repro_torch;
  dim3 grid((N + GF_BN - 1) / GF_BN, (M + GF_BM - 1) / GF_BM);
  return dispatch_type(wt, [&](auto wtag) {
    return dispatch_type(rt, [&](auto rtag) {
      return dispatch_type(ot, [&](auto otag) {
        using WT = typename decltype(wtag)::type;
        using RT = typename decltype(rtag)::type;
        using OT = typename decltype(otag)::type;
        gemm_f32_kernel<WT, RT, OT><<<grid, 256, 0, (cudaStream_t)stream>>>(
            A, lda, (const WT*)B, ldb, grp, grp_stride, (OT*)C, ldc, M, N, K,
            (const WT*)bias, (const RT*)res, ldr, gelu);
        return (int)cudaGetLastError();
      });
    });
  });
}

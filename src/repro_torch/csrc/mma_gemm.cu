// The float layer's GEMMs on the tensor cores, with a fused epilogue:
// C = [res +] act(A.B [+ bias]).
//
// Replaces: the concat projection (accumulated over heads in VMEM on the
// TPU) and both MLP matmuls inside repro/kernels/vita_layer.py::vita_layer;
// kernels/vita_layer.py chains them after the MSA tile (vita_msa.cu).
// Bound: operations, 2*M*N*K; at split TF32 (three passes with fp32 B, two
// with bf16 B) the rate of fp32-accurate products is 165 (248) TFLOP/s
// against 67 on the CUDA cores.  Design: the tile of mma_gemm.cuh, one
// block per 32 x 64 output tile.  The weight and bias type (wt), the
// residual's (rt) and the output's (ot) are float or bf16 each; A is fp32.
#include "mma_gemm.cuh"

namespace repro_torch {

template <typename WT, typename RT, typename OT>
__global__ void __launch_bounds__(MG_THREADS)
mma_gemm_kernel(const float* __restrict__ A, long long lda,
                const WT* __restrict__ B, long long ldb, OT* __restrict__ C,
                long long ldc, int M, int N, int K,
                const WT* __restrict__ bias, const RT* __restrict__ res,
                long long ldr, int gelu, int vecs) {
  extern __shared__ __align__(16) unsigned char smem[];
  mma_gemm_tile(smem, blockIdx.y, blockIdx.x, A, lda, B, ldb, C, ldc, M, N,
                K, bias, res, ldr, gelu, vecs);
}

}  // namespace repro_torch

// wt / rt / ot: the ElemCode of B and bias, of res, and of C.
extern "C" int rt_mma_gemm(const float* A, long long lda, const void* B,
                           long long ldb, void* C, long long ldc, int M,
                           int N, int K, const void* bias, const void* res,
                           long long ldr, int gelu, int wt, int rt, int ot,
                           void* stream) {
  using namespace repro_torch;
  dim3 grid((N + MG_BN - 1) / MG_BN, (M + MG_BM - 1) / MG_BM);
  return dispatch_type(wt, [&](auto wtag) {
    return dispatch_type(rt, [&](auto rtag) {
      return dispatch_type(ot, [&](auto otag) {
        using WT = typename decltype(wtag)::type;
        using RT = typename decltype(rtag)::type;
        using OT = typename decltype(otag)::type;
        // Rows of whole 16-byte chunks take the tile's cp.async fast path.
        const int vecs = (vec_ok<float>(A, lda) && K % 4 == 0 ? 1 : 0) |
                         (vec_ok<WT>(B, ldb) && N % (16 / (int)sizeof(WT)) == 0
                              ? 2 : 0);
        constexpr int smem = MgSmem<WT>::BYTES;
        cudaError_t err = cudaFuncSetAttribute(
            mma_gemm_kernel<WT, RT, OT>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
        mma_gemm_kernel<WT, RT, OT>
            <<<grid, MG_THREADS, smem, (cudaStream_t)stream>>>(
                A, lda, (const WT*)B, ldb, (OT*)C, ldc, M, N, K,
                (const WT*)bias, (const RT*)res, ldr, gelu, vecs);
        return (int)cudaGetLastError();
      });
    });
  });
}

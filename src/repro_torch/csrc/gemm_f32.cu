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
// over 3.35 TB/s = 20 flop/byte).
// Design: 64x64 output tile per 256-thread block, 16-deep k slices staged in
// shared memory (A transposed so both operands are read as broadcasts or
// consecutive words), 4x4 outputs per thread accumulated with fmaf in k
// order.  Every edge (M = B*196, N = 1000 classes, K) is masked with zero
// fill.  CUDA cores only: wgmma/TMA are a later PR's work.
//
// B is addressed in column groups so that per-head (H, D, Dh) weight stacks
// are read in place: element (k, n) lives at
//   B[(n / grp) * grp_stride + k * ldb + (n % grp)]
// (a plain row-major (K, N) matrix is grp = N, ldb = N).
#include "common.cuh"

namespace repro_torch {

constexpr int BM = 64, BN = 64, BK = 16;

__global__ void __launch_bounds__(256)
gemm_f32_kernel(const float* __restrict__ A, long long lda,
                const float* __restrict__ B, long long ldb, int grp,
                long long grp_stride, float* __restrict__ C, long long ldc,
                int M, int N, int K, const float* __restrict__ bias,
                const float* __restrict__ res, long long ldr, int gelu) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      int idx = t + 256 * l;
      int r = idx / BK, c = idx % BK;
      int m = m0 + r, k = k0 + c;
      As[c][r] = (m < M && k < K) ? A[(long long)m * lda + k] : 0.f;
      int kk = idx / BN, nn = idx % BN;
      int n = n0 + nn;
      k = k0 + kk;
      Bs[kk][nn] = (n < N && k < K)
                       ? B[(long long)(n / grp) * grp_stride + (long long)k * ldb + (n % grp)]
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      float v = acc[i][j];
      if (bias) v = v + bias[n];
      if (gelu) v = gelu_tanh(v);
      if (res) v = res[(long long)m * ldr + n] + v;
      C[(long long)m * ldc + n] = v;
    }
  }
}

}  // namespace repro_torch

extern "C" int rt_gemm_f32(const float* A, long long lda, const float* B,
                           long long ldb, int grp, long long grp_stride, float* C,
                           long long ldc, int M, int N, int K, const float* bias,
                           const float* res, long long ldr, int gelu, void* stream) {
  using namespace repro_torch;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_f32_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      A, lda, B, ldb, grp, grp_stride, C, ldc, M, N, K, bias, res, ldr, gelu);
  return (int)cudaGetLastError();
}

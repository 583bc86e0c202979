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
// Design: 64x64 output tile per 256-thread block, 32-deep k slices staged
// in shared memory with both operands k-contiguous (B transposed on load)
// so one 32-bit word feeds one __dp4a; rows padded to 36 bytes so the
// per-column reads hit distinct banks.  Ragged M, N and K zero-fill, which
// leaves the integer sums exact.
//
// Epilogue (out_kind): 0 writes the raw int32 accumulator; 1 writes
//   v = acc * (x_scale * w_scale[n])  [+ bias[n]]  [-> gelu]  [res + v]
// as float; 2 writes the same v quantised to int8 at *out_scale.  Missing
// scales count as 1.  B is addressed in column groups as in gemm_f32.cu.
#include "common.cuh"

namespace repro_torch {

constexpr int BM = 64, BN = 64, BK = 32, PADK = BK + 4;

__global__ void __launch_bounds__(256)
gemm_i8_kernel(const int8_t* __restrict__ A, long long lda,
               const int8_t* __restrict__ B, long long ldb, int grp,
               long long grp_stride, void* __restrict__ C, long long ldc,
               int out_kind, int M, int N, int K,
               const float* __restrict__ x_scale, const float* __restrict__ w_scale,
               const float* __restrict__ bias, const float* __restrict__ res,
               long long ldr, int gelu, const float* __restrict__ out_scale) {
  __shared__ __align__(16) int8_t As[BM][PADK];
  __shared__ __align__(16) int8_t Bs[BN][PADK];
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      int idx = t + 256 * l;
      int r = idx / BK, c = idx % BK;
      int m = m0 + r, k = k0 + c;
      As[r][c] = (m < M && k < K) ? A[(long long)m * lda + k] : (int8_t)0;
      int kk = idx / BN, nn = idx % BN;
      int n = n0 + nn;
      k = k0 + kk;
      Bs[nn][kk] = (n < N && k < K)
                       ? B[(long long)(n / grp) * grp_stride + (long long)k * ldb + (n % grp)]
                       : (int8_t)0;
    }
    __syncthreads();
#pragma unroll
    for (int k4 = 0; k4 < BK / 4; ++k4) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const int*>(&As[ty + 16 * i][4 * k4]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const int*>(&Bs[tx + 16 * j][4 * k4]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  const float xs = x_scale ? *x_scale : 1.0f;
  const float qs = out_scale ? *out_scale : 1.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      long long o = (long long)m * ldc + n;
      if (out_kind == 0) {
        static_cast<int*>(C)[o] = acc[i][j];
        continue;
      }
      float s = xs * (w_scale ? w_scale[n] : 1.0f);
      float v = (float)acc[i][j] * s;
      if (bias) v = v + bias[n];
      if (gelu) v = gelu_tanh(v);
      if (res) v = res[(long long)m * ldr + n] + v;
      if (out_kind == 1)
        static_cast<float*>(C)[o] = v;
      else
        static_cast<int8_t*>(C)[o] = quant_i8(v, qs);
    }
  }
}

}  // namespace repro_torch

extern "C" int rt_gemm_i8(const int8_t* A, long long lda, const int8_t* B,
                          long long ldb, int grp, long long grp_stride, void* C,
                          long long ldc, int out_kind, int M, int N, int K,
                          const float* x_scale, const float* w_scale,
                          const float* bias, const float* res, long long ldr,
                          int gelu, const float* out_scale, void* stream) {
  using namespace repro_torch;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_i8_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      A, lda, B, ldb, grp, grp_stride, C, ldc, out_kind, M, N, K, x_scale,
      w_scale, bias, res, ldr, gelu, out_scale);
  return (int)cudaGetLastError();
}

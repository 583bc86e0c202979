// Tiled int8 x int8 -> int32 GEMM with a requant epilogue, on the int8
// tensor cores.
//
// Replaces: repro/kernels/int8_matmul.py::int8_matmul (tiled MXU product
// with x_scale * w_scale[n] fused into the last k-step), and the int8
// matmuls inside repro/kernels/vita_layer.py::vita_layer_int8 and
// repro/kernels/vita_msa.py::vita_msa_int8.  The TPU kept the int32 concat
// accumulator in VMEM across the head grid; here the concat projection is
// one GEMM over the requantised (B*N, H*Dh) attention output, so the int32
// sum over heads is taken inside one dot product instead (exact in any
// order, so the k order of the tile does not matter).
// Bound: at the embed shape (1568x768x192) bytes (~2.6 MB with the fp32
// output, for 0.46 GOP at 1,979 TOP/s); at the layer's widest products
// operations.
// Design: one block per 64 x 64 output tile of `mma_gemm_i8_tile`
// (mma_gemm_i8.cuh: mma.sync m16n8k32 with int32 accumulators, a 4-stage
// cp.async ring 128 deep in k); kernels/int8_matmul.py::gemm_i8_plan
// splits each tile's k steps over two warp groups where the tiles leave
// SMs idle, and chooses each operand's copy width; the launch takes the
// plan as is.  The epilogue (out_kind 0: int32, 1: rescaled float, 2:
// requantised int8) is `i8_epilogue` (gemm_i8.cuh); the int8 layer group
// runs the same tile and epilogue; the bias is float or bf16 (bt).
#include <cstring>
#include <type_traits>

#include "mma_gemm_i8.cuh"

namespace repro_torch {

template <int KG, typename BT>
__global__ void __launch_bounds__(MiTile<KG>::THREADS)
mma_gemm_i8_kernel(const int8_t* __restrict__ A, long long lda,
                   const int8_t* __restrict__ B, long long ldb, int grp,
                   long long grp_stride, void* __restrict__ C, long long ldc,
                   int out_kind, int M, int N, int K,
                   const float* __restrict__ x_scale,
                   const float* __restrict__ w_scale,
                   const BT* __restrict__ bias, const float* __restrict__ res,
                   long long ldr, int gelu, const float* __restrict__ out_scale,
                   int a_w, int b_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  mma_gemm_i8_tile<KG>(smem, blockIdx.y, blockIdx.x, A, lda, B, ldb, grp,
                       grp_stride, C, ldc, out_kind, M, N, K, x_scale,
                       w_scale, bias, res, ldr, gelu, out_scale, a_w, b_w);
}

// The plan's fields (kernels/int8_matmul.py::I8Plan.launch_ints()).
struct I8Layout {
  int bm, bn, kgroups, stages, a_w, b_w;
};

template <int KG, typename BT>
int launch_i8(const I8Layout& p, const int8_t* A, long long lda,
              const int8_t* B, long long ldb, int grp, long long grp_stride,
              void* C, long long ldc, int out_kind, int M, int N, int K,
              const float* x_scale, const float* w_scale, const void* bias,
              const float* res, long long ldr, int gelu,
              const float* out_scale, cudaStream_t stream) {
  using T = MiTile<KG>;
  auto kernel = mma_gemm_i8_kernel<KG, BT>;
  if constexpr (T::SMEM > 48 * 1024) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (attr != cudaSuccess) return (int)attr;
  }
  dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(
      A, lda, B, ldb, grp, grp_stride, C, ldc, out_kind, M, N, K, x_scale,
      w_scale, (const BT*)bias, res, ldr, gelu, out_scale, p.a_w, p.b_w);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// B element (k, n) is B[(n / grp) * grp_stride + k * ldb + n % grp].
// plan: the 6 ints of the wrapper's I8Plan (tile rows and columns, k
// groups, ring stages, A's and B's copy widths in bytes), refused where its
// tile or k groups are not built or a copy width would cross a row, a
// head or an alignment.
extern "C" int rt_gemm_i8(const int8_t* A, long long lda, const int8_t* B,
                          long long ldb, int grp, long long grp_stride, void* C,
                          long long ldc, int out_kind, int M, int N, int K,
                          const float* x_scale, const float* w_scale,
                          const void* bias, const float* res, long long ldr,
                          int gelu, const float* out_scale, int bt,
                          const int* plan, void* stream) {
  using namespace repro_torch;
  I8Layout p;
  std::memcpy(&p, plan, sizeof p);
  if (p.stages != MI_STAGES || !width_ok(p.a_w, lda, K, 0, 0, A) ||
      !width_ok(p.b_w, ldb, grp, grp_stride, N, B))
    return (int)cudaErrorInvalidValue;
  return dispatch_type(bt, [&](auto btag) {
    using BT = typename decltype(btag)::type;
    auto go = [&](auto kg) {
      return launch_i8<decltype(kg)::value, BT>(
          p, A, lda, B, ldb, grp, grp_stride, C, ldc, out_kind, M, N, K,
          x_scale, w_scale, bias, res, ldr, gelu, out_scale,
          (cudaStream_t)stream);
    };
    if (p.bm != MiTile<1>::BM || p.bn != MiTile<1>::BN)
      return (int)cudaErrorInvalidValue;
    if (p.kgroups == 1) return go(std::integral_constant<int, 1>{});
    if (p.kgroups == 2) return go(std::integral_constant<int, 2>{});
    return (int)cudaErrorInvalidValue;
  });
}

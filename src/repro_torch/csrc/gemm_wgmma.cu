// Kernel 1's fp32 GEMMs on Hopper's own path: C = [res +] act(A.B [+
// bias]) in split TF32 on wgmma, A and the weights' hi and lo planes fed
// by a TMA ring (gemm_wgmma.cuh).
//
// Replaces: the concat projection (accumulated over heads in VMEM on the
// TPU) and both MLP matmuls inside repro/kernels/vita_layer.py::vita_layer,
// with fp32 weights; kernels/vita_layer.py chains them after the MSA tile
// and routes the rest (bf16 weights, unaligned rows) to mma_gemm.cu.
// Bound: operations, 2*M*N*K at split TF32's 165 TFLOP/s of fp32-accurate
// products (three TF32 passes at 495).  Design: the header's; the tile
// shape (64 or 128 rows, BN columns), the ring depth and the grid come
// from kernels/vita_layer.py::gemm_wgmma_plan.  On an H100 at 700 W
// DeiT-S's three products at bucket 32 run at 67, 97 and 88 TFLOP/s (41-59%
// of the bound, against 22-26 on mma.sync); without its epilogue the up
// product's main loop reaches 131 (a tile's epilogue, not overlapped with
// the next tile's products, holds about 40% of its time).
#include <dlfcn.h>

#include "gemm_wgmma.cuh"

namespace repro_torch {
namespace {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once in the libcuda.so.1 that the
// process already has loaded (the library is not linked against it).
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!h) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h ? reinterpret_cast<EncodeTiled>(
                   dlsym(h, "cuTensorMapEncodeTiled"))
             : nullptr;
  }();
  return fn;
}

// A row-major fp32 matrix (rows x cols, leading dimension ld) as boxes of
// `box_rows` rows x 32 columns, 128-byte swizzled, zero filled past the
// edges.
bool encode(CUtensorMap* map, const float* p, int rows, int cols,
            long long ld, int box_rows) {
  const EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {(cuuint32_t)WG_BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// `encode` through a small cache: a map depends on nothing but its
// arguments, so the weights' planes and the activations the allocator
// hands out again each micro-batch reuse theirs.  One cache a host thread.
bool cached_encode(CUtensorMap* map, const float* p, int rows, int cols,
                   long long ld, int box_rows) {
  struct Entry {
    CUtensorMap map;
    const float* p;
    long long ld;
    int rows, cols, box_rows;
  };
  constexpr int SLOTS = 256;
  static thread_local Entry cache[SLOTS] = {};
  const uintptr_t h = (reinterpret_cast<uintptr_t>(p) >> 8) ^
                      (uintptr_t)(rows * 31 + cols * 7 + box_rows);
  Entry& e = cache[h % SLOTS];
  if (e.p != p || e.rows != rows || e.cols != cols || e.ld != ld ||
      e.box_rows != box_rows) {
    if (!encode(&e.map, p, rows, cols, ld, box_rows)) {
      e.p = nullptr;
      return false;
    }
    e.p = p;
    e.rows = rows;
    e.cols = cols;
    e.ld = ld;
    e.box_rows = box_rows;
  }
  *map = e.map;
  return true;
}

template <int BN, int CONS>
int launch(const float* A, long long lda, const float* Bh, const float* Bl,
           void* C, long long ldc, int M, int N, int K, const float* bias,
           const void* res, long long ldr, int gelu, int rt, int ot,
           int stages, int grid, cudaStream_t stream) {
  using S = WgSmem<BN, CONS>;
  const int smem = S::bytes(stages);
  // One attribute call per instantiation, at the most any plan asks for.
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_wgmma_kernel<BN, CONS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap ma, mbh, mbl;
  if (!cached_encode(&ma, A, M, K, lda, S::BM) ||
      !cached_encode(&mbh, Bh, N, K, K, BN) ||
      !cached_encode(&mbl, Bl, N, K, K, BN))
    return (int)cudaErrorInvalidValue;
  gemm_wgmma_kernel<BN, CONS><<<grid, 128 * (CONS + 1), smem, stream>>>(
      ma, mbh, mbl, C, ldc, M, N, K, bias, res, ldr, gelu, rt, ot, stages);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// A (M x K, row stride lda, 16-byte aligned rows); bh / bl the weights'
// hi and lo planes (N x K, contiguous); bias fp32 (N) or null; res (row
// stride ldr) and C (row stride ldc) fp32 or bf16 (rt / ot: ElemCode).
// bn, consumers, stages and grid: the plan's tile width, consumer
// warpgroups, ring depth and blocks.
extern "C" int rt_gemm_wgmma(const float* A, long long lda, const float* bh,
                             const float* bl, void* C, long long ldc, int M,
                             int N, int K, const float* bias, const void* res,
                             long long ldr, int gelu, int rt, int ot, int bn,
                             int consumers, int stages, int grid,
                             void* stream) {
  using namespace repro_torch;
  const cudaStream_t s = (cudaStream_t)stream;
#define RT_WG_CASE(BN_, CONS_)                                              \
  if (bn == BN_ && consumers == CONS_)                                      \
    return launch<BN_, CONS_>(A, lda, bh, bl, C, ldc, M, N, K, bias, res,   \
                              ldr, gelu, rt, ot, stages, grid, s);
  RT_WG_CASE(32, 1) RT_WG_CASE(96, 1)
  RT_WG_CASE(32, 2) RT_WG_CASE(64, 2) RT_WG_CASE(96, 2)
#undef RT_WG_CASE
  return (int)cudaErrorInvalidValue;
}

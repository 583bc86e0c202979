// Asynchronous 16-byte copies from device memory into shared memory
// (cp.async, sm_80 and later) and the 2-D tile loader over them, the bf16
// tensor-core pieces (ldmatrix, mma.sync m16n8k16 with fp32 accumulation),
// the parts of a block a tile syncs over, and the launch helpers shared by
// decode_attention.cu, fused_mlp*.cu, vita_msa.cu and mma_gemm.cu.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace repro_torch {

// The threads that run one tile (kernel 4's int8 GEMM tile, the attention
// tile): the whole block, or part threadIdx.x / THREADS of it, which syncs
// on named barrier 1 + that part (barrier 0 is __syncthreads').
struct WholeBlock {
  static __device__ __forceinline__ int tid() { return threadIdx.x; }
  static __device__ __forceinline__ void sync() { __syncthreads(); }
};
template <int THREADS>
struct BlockPart {
  static __device__ __forceinline__ int tid() {
    return threadIdx.x % THREADS;
  }
  static __device__ __forceinline__ void sync() {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + (int)threadIdx.x / THREADS),
                 "n"(THREADS)
                 : "memory");
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to dst, bypassing L1; where `valid` is false nothing
// is read and dst is zero-filled (the src-size operand 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Tile rows [row0, row0 + tr) x columns [col0, col0 + tc) of a row-major
// (rows x cols, leading dimension ld) matrix into shared memory at `dst`
// (row stride `ds` bytes) by THREADS threads; entries past the matrix are
// zeros.  With `vec` (ld and the base 16-byte aligned, col0 a multiple of
// 16 bytes) each 16-byte chunk inside the matrix is a cp.async; a chunk
// across its right edge, and every chunk without `vec`, is copied by
// plain loads.  `src` carries no __restrict__: the layer-group kernel
// stages workspace that other blocks wrote earlier in the same launch,
// which must not be read through the read-only cache.
template <typename T, int THREADS>
__device__ __forceinline__ void load_tile(unsigned char* dst, int ds,
                                          const T* src,
                                          long long ld, int row0, int rows,
                                          int col0, int cols, int tr, int tc,
                                          bool vec) {
  constexpr int V = 16 / (int)sizeof(T);
  const int cpr = tc / V;
  for (int i = threadIdx.x; i < tr * cpr; i += THREADS) {
    const int r = i / cpr, c = (i % cpr) * V, row = row0 + r, col = col0 + c;
    T* d = reinterpret_cast<T*>(dst + r * ds) + c;
    const bool rin = row < rows;
    if (vec && (!rin || col + V <= cols || col >= cols)) {
      const bool ok = rin && col + V <= cols;
      cp_async16(d, ok ? src + row * ld + col : src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        d[e] = rin && col + e < cols ? src[row * ld + col + e]
                                     : from_f<T>(0.f);
    }
  }
}

// Four 8x8 b16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i; register i of every lane holds its part of
// matrix i.  `trans` loads each matrix transposed.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a . b for a 16x16 bf16 A (row major, 4 registers), a 16x8 bf16 B
// (column major, 2 registers) and a 16x8 fp32 accumulator (4 registers).
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Lane addressing of ldmatrix.x4 over a 16 x 16 block: the row and the
// column (in elements) whose 16 bytes this lane points at; matrices 0-3
// are (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15).
__device__ __forceinline__ int lm_row(int lane) {
  return (lane % 8) + 8 * ((lane / 8) % 2);
}
__device__ __forceinline__ int lm_col(int lane) { return 8 * (lane / 16); }

// True where `p` and a row of `ld` elements of T keep 16-byte chunks
// aligned.
template <typename T>
inline bool vec_ok(const void* p, long long ld) {
  return p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (ld * (long long)sizeof(T)) % 16 == 0;
}

// The card's SM count.
inline int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

}  // namespace repro_torch

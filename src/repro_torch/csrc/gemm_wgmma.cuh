// The layer's fp32 GEMM on Hopper's own path: split-TF32 products on
// wgmma, fed by a TMA ring, with a fused epilogue: C = [res +] act(A.B
// [+ bias]).  Used by gemm_wgmma.cu for kernel 1's concat, up and down
// products with fp32 weights (kernels/vita_layer.py); mma_gemm.cuh keeps
// the bf16-weight modes, rows that are not 16-byte aligned and the layer
// group (vita_layer_group.cu).
//
// Arithmetic: as tf32_split.cuh defines it.  A and B split into hi and lo
// TF32 parts by the same integer rounding; a_hi.b_hi + a_lo.b_hi +
// a_hi.b_lo, a_lo.b_lo dropped.  Each 32-deep chunk of a_hi.b_hi (one ring
// stage, four wgmma k steps) collects in a fresh accumulator that is then
// added to the running fp32 sum by a rounded fp32 add; the small terms
// collect in an accumulator of their own across all of K.  An output
// element's k order is the walk over 32-deep stages from k = 0: a
// function of K alone, not of M, of the tile shape or of the tile order.
// No split K, no atomics.
//
// Operands: TF32 wgmma reads shared-memory operands K-major only.  A's
// fp32 rows (K-major already) arrive by TMA, one 64-row slice per
// consumer warpgroup; each thread splits its fragment into hi and lo in
// registers and issues wgmma with A in registers.  B arrives as the
// weights' hi and lo planes, W_hi^T and W_lo^T (N x K, split once by the
// caller and kept with the weight), each a K-major wgmma operand.  Every
// tile in shared memory is 128-byte swizzled (rows of 32 floats): TMA
// writes that layout, wgmma's descriptors read it, and the A fragment
// loads hit eight distinct 16-byte chunks of a row group.
//
// Design (hopper-kernels guide, section 1): a persistent grid of one block
// an SM; CONS consumer warpgroups (a BM = 64 * CONS x BN output tile) and
// one producer warp that keeps a ring of `stages` stages (A [BM][32], B_hi
// [BN][32], B_lo [BN][32]) in flight with TMA, completed on mbarriers and
// released by the consumers.  Tiles are walked n fastest, a block taking
// every gridDim.x-th; the epilogue of one tile overlaps the loads of the
// next.  Every edge (M, N, K) is zero filled by TMA and masked at the
// store.
#pragma once

#include <cstdint>
#include <cuda.h>

#include "tf32_split.cuh"

namespace repro_torch {

constexpr int WG_BK = 32;  // k depth of a stage: one 128-byte swizzled row

// Shared memory of a ring stage and of the whole block (the ring, 1,024
// bytes to align it for the swizzle, two mbarriers a stage): the same
// numbers as kernels/vita_layer.py::gemm_wgmma_plan.
template <int BN, int CONS>
struct WgSmem {
  static constexpr int BM = 64 * CONS;
  static constexpr int A_BYTES = BM * WG_BK * 4;
  static constexpr int B_BYTES = BN * WG_BK * 4;
  static constexpr int STAGE = A_BYTES + 2 * B_BYTES;
  static int bytes(int stages) { return stages * (STAGE + 16) + 1024; }
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// A box of a 2-D tensor map at (c0 innermost, c1) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// wgmma's shared-memory descriptor of a K-major tile of 32-float rows,
// 128-byte swizzled, 1,024-byte aligned: 8-row groups 1,024 bytes apart.
// A k step of 8 advances the start address by 32 bytes (+2).
__device__ __forceinline__ uint64_t wg_desc(const void* tile) {
  return (uint64_t)((smem_addr(tile) & 0x3ffff) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the wgmma fence and wait around it.
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x BN fp32, BN / 2 registers a thread) = [d +] a . b: one
// m64nBNk8 TF32 wgmma with A in registers (the m16n8k8 fragment of the
// warp's 16 rows) and B from a descriptor.
template <int BN>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<96> {
  static __device__ __forceinline__ void mma(float (&d)[48], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

// The epilogue's residual and stores over a consumer thread's fragment:
// elements 4j + 2h + q of `v` at row m + 8h, column n + 8j + q, taken as
// the pairs q = 0, 1.  With PAIRS (N, the row strides even, the pointers
// 8-byte aligned: every product kernel 1 runs) a pair is one 8-byte (fp32)
// or 4-byte (bf16) access; else two.  Every residual load is issued
// unconditionally (one past the edge reads element 0 and is never
// stored), so the loads go out together rather than one after another
// behind their branches.
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x,
                                           float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

template <bool PAIRS, int R, typename T>
__device__ __forceinline__ void add_res(float (&v)[R],
                                        const T* __restrict__ res,
                                        long long ldr, long long m, int n,
                                        int M, int N) {
#pragma unroll
  for (int i = 0; i < R; i += 2) {
    const long long row = m + 8 * ((i >> 1) & 1);
    const int col = n + 8 * (i >> 2);
    if constexpr (PAIRS) {
      const float2 r = load_pair(res + (row < M && col < N ? row * ldr + col
                                                           : 0));
      v[i] = r.x + v[i];
      v[i + 1] = r.y + v[i + 1];
    } else {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const bool in = row < M && col + q < N;
        v[i + q] = to_f(res[in ? row * ldr + col + q : 0]) + v[i + q];
      }
    }
  }
}

template <bool PAIRS, int R, typename T>
__device__ __forceinline__ void store_rows(const float (&v)[R],
                                           T* __restrict__ C, long long ldc,
                                           long long m, int n, int M, int N) {
#pragma unroll
  for (int i = 0; i < R; i += 2) {
    const long long row = m + 8 * ((i >> 1) & 1);
    const int col = n + 8 * (i >> 2);
    if (row >= M) continue;
    if constexpr (PAIRS) {
      if (col < N) store_pair(C + row * ldc + col, v[i], v[i + 1]);
    } else {
#pragma unroll
      for (int q = 0; q < 2; ++q)
        if (col + q < N) store_f(C, row * ldc + col + q, v[i + q], nullptr);
    }
  }
}

// The residual and the stores of a fragment, in the residual's and the
// output's types.
template <bool PAIRS, int R>
__device__ __forceinline__ void finish(float (&v)[R], void* __restrict__ C,
                                       long long ldc, const void* res,
                                       long long ldr, int rt, int ot,
                                       long long m, int n, int M, int N) {
  if (res) {
    if (rt == kBF16)
      add_res<PAIRS>(v, static_cast<const __nv_bfloat16*>(res), ldr, m, n,
                     M, N);
    else
      add_res<PAIRS>(v, static_cast<const float*>(res), ldr, m, n, M, N);
  }
  if (ot == kBF16)
    store_rows<PAIRS>(v, static_cast<__nv_bfloat16*>(C), ldc, m, n, M, N);
  else
    store_rows<PAIRS>(v, static_cast<float*>(C), ldc, m, n, M, N);
}

// One persistent block: see the file's note.  res and C are fp32 or bf16
// (rt, ot: ElemCode); bias fp32.
template <int BN, int CONS>
__global__ void __launch_bounds__(128 * (CONS + 1), 1)
    gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_bh,
                      const __grid_constant__ CUtensorMap map_bl,
                      void* __restrict__ C, long long ldc, int M, int N,
                      int K, const float* __restrict__ bias,
                      const void* __restrict__ res, long long ldr, int gelu,
                      int rt, int ot, int stages) {
  using S = WgSmem<BN, CONS>;
  constexpr int R = BN / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * S::STAGE);
  uint64_t* empty = full + stages;
  const int wg = threadIdx.x / 128;
  const int ntiles = (N + BN - 1) / BN;
  const int tiles = (M + S::BM - 1) / S::BM * ntiles;
  const int steps = (K + WG_BK - 1) / WG_BK;
  const bool pairs =
      !(N & 1) && !(ldc & 1) && !(reinterpret_cast<uintptr_t>(C) & 7) &&
      (!res || (!(ldr & 1) && !(reinterpret_cast<uintptr_t>(res) & 7)));
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * CONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (wg == CONS) {
    // The producer: one thread walks the block's tiles and their stages.
    if constexpr (CONS > 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 128 * CONS) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / ntiles * S::BM, n0 = tile % ntiles * BN;
        for (int s = 0; s < steps; ++s) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = smem + stage * S::STAGE;
          mbar_expect_tx(&full[stage], S::STAGE);
          tma_load_2d(st, &map_a, &full[stage], s * WG_BK, m0);
          tma_load_2d(st + S::A_BYTES, &map_bh, &full[stage], s * WG_BK, n0);
          tma_load_2d(st + S::A_BYTES + S::B_BYTES, &map_bl, &full[stage],
                      s * WG_BK, n0);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    if constexpr (CONS > 1)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    // Row r0 and r0 + 8 of the tile (both r0 % 8 == g in the swizzle).
    const int r0 = 64 * wg + 16 * ((threadIdx.x / 32) % 4) + g;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / ntiles * S::BM, n0 = tile % ntiles * BN;
      float v[R], hh[R], lo[R];
#pragma unroll
      for (int i = 0; i < R; ++i) v[i] = hh[i] = lo[i] = 0.f;
      for (int s = 0; s < steps; ++s) {
        mbar_wait(&full[stage], phase);
        const unsigned char* st = smem + stage * S::STAGE;
        const float* As = reinterpret_cast<const float*>(st);
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // k = 8j + t in 16-byte chunk 2j, k = 8j + t + 4 in chunk 2j + 1,
          // each at chunk ^ (row % 8).
          const int c0 = ((2 * j) ^ g) * 4 + t, c1 = ((2 * j + 1) ^ g) * 4 + t;
          split_tf32(As[r0 * WG_BK + c0], ah[j][0], al[j][0]);
          split_tf32(As[(r0 + 8) * WG_BK + c0], ah[j][1], al[j][1]);
          split_tf32(As[r0 * WG_BK + c1], ah[j][2], al[j][2]);
          split_tf32(As[(r0 + 8) * WG_BK + c1], ah[j][3], al[j][3]);
        }
        const uint64_t dh = wg_desc(st + S::A_BYTES);
        const uint64_t dl = wg_desc(st + S::A_BYTES + S::B_BYTES);
        pin(hh);
        pin(lo);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          Wgmma<BN>::mma(hh, ah[j], dh + 2 * j, j);
          Wgmma<BN>::mma(lo, al[j], dh + 2 * j, 1);
          Wgmma<BN>::mma(lo, ah[j], dl + 2 * j, 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(hh);
        pin(lo);
        if (lane == 0) mbar_arrive(&empty[stage]);
#pragma unroll
        for (int i = 0; i < R; ++i) v[i] += hh[i];
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      // The epilogue, [res +] act(sum [+ bias]): the sums, bias and
      // activation over the whole fragment first, without branches, so
      // the independent elements' chains interleave; then the residual
      // and the stores, by row.  C, res and bias do not alias.
#pragma unroll
      for (int i = 0; i < R; ++i) v[i] += lo[i];
      if (bias) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int n = n0 + 8 * j + 2 * t;
          const float b0 = n < N ? bias[n] : 0.f;
          const float b1 = n + 1 < N ? bias[n + 1] : 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) v[4 * j + e] += e & 1 ? b1 : b0;
        }
      }
      if (gelu) {
#pragma unroll
        for (int i = 0; i < R; ++i) v[i] = gelu_tanh(v[i]);
      }
      if (pairs)
        finish<true>(v, C, ldc, res, ldr, rt, ot, m0 + r0, n0 + 2 * t, M, N);
      else
        finish<false>(v, C, ldc, res, ldr, rt, ot, m0 + r0, n0 + 2 * t, M,
                      N);
    }
  }
}

}  // namespace repro_torch

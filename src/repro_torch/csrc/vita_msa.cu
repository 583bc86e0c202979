// Float per-head MSA in one kernel: Q/K/V projection and exact softmax
// attention, with Q, K, V and the scores kept on chip.
//
// Replaces: repro/kernels/vita_msa.py::vita_msa_batched (and its
// single-image wrapper vita_msa), the (B, H)-grid Pallas kernel of the
// unfused float executor.  Its defining trait is that per (image, head)
// only that head's Q/K/V/S ever exist on chip and SA is the only tensor
// written.  This kernel keeps that: z and the weights are read, SA is
// written, and nothing else reaches device memory.
//
// Design (a): one block per (image, head, 32-query tile).  The block
// projects the whole head's K and V into shared memory (z and the weight
// columns stream through 16-deep slices, so z never has to fit), then only
// its own 32 Q rows, then runs `attend_row` (attention.cuh) per row, one
// warp a row.  K and V are recomputed once per query tile, ceil(N/32)
// times per head: 7 at DeiT-T's N = 196, 2 at Swin's n = 49.  Design (b),
// one block per (image, head) with Q projected row by row in each warp,
// would project K/V once but gives only B*H blocks: 24 at DeiT-T batch 8
// for 132 SMs.  (a) gives 168 blocks there and 3072 at Swin-T stage 1
// (bucket 8), and its dynamic shared memory (`msa_smem_bytes` in
// kernels/vita_msa.py) is
// K [N][Dh+1] + V [N][Dh] + Q [32][Dh] + 8 score rows [N]: 113 KiB at
// N 196, Dh 64; 145 KiB at ViT-B's N 256; 18 KiB at n 49, Dh 32.
// Bound: operations, on CUDA cores.  Per (image, head) the projections are
// 6*N*D*Dh flops and the attention 4*N*N*Dh; the recomputation of K/V adds
// (ceil(N/32) - 1) * 4*N*D*Dh.  wgmma/TMA are later work.
//
// Windowed mode (Swin) and qkv_bias as in attention.cu / the TPU kernel:
// bias (H, N, N) + mask (nW, N, N) join the scores after the scale, the
// mask picked by b % nW; qkv_bias (3, H, Dh) is added to the projections.
//
// dtype modes (ref.PORTED_MODES), as the TPU kernel runs them: z is ZT and
// the weights and qkv_bias WT, each read into fp32 as they are staged, so
// Q, K and V are fp32 sums of exact products.  With z fp32 (bf16 weights
// or not) everything after is fp32 and the output fp32.  With z bf16 the
// kernel rounds where the TPU kernel rounds (`softmax_av`, out_dtype =
// z.dtype): V is kept in shared memory as bf16, P is rounded to bf16
// before the AV product, the AV sum is fp32 and the output bf16.  K, Q and
// the scores stay fp32.  The bf16 build stages V in half the bytes:
// `msa_smem_bytes` (kernels/vita_msa.py) mirrors the layout below.
#include "attention.cuh"

namespace repro_torch {

constexpr int WARPS = 8, THREADS = WARPS * 32, QTILE = 32;
constexpr int TM = 64, TE = 64, KC = 16;

// out[r * ld + e] = sum_d z[(n0 + r) * D + d] * W[d * Dh + e] (+ bias[e])
// for r < rows, e < Dh: 64 x 64 output tiles, 4 x 4 per thread, KC-deep
// slices of z and W staged in shared memory as fp32, summed in d order with
// fmaf, stored as OT (fp32, or bf16 for V in the bf16 mode).
template <typename ZT, typename WT, typename OT>
__device__ void project(const ZT* __restrict__ z, int D, int n0, int rows,
                        const WT* __restrict__ W, int Dh,
                        const WT* __restrict__ bias, OT* out, int ld,
                        float (*Zs)[TM], float (*Ws)[TE]) {
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  for (int r0 = 0; r0 < rows; r0 += TM) {
    for (int e0 = 0; e0 < Dh; e0 += TE) {
      float acc[4][4] = {};
      for (int d0 = 0; d0 < D; d0 += KC) {
#pragma unroll
        for (int l = 0; l < KC * TM / THREADS; ++l) {
          const int idx = t + THREADS * l;
          int r = idx / KC, c = idx % KC, d = d0 + c;
          Zs[c][r] = (r0 + r < rows && d < D)
                         ? to_f(z[(long long)(n0 + r0 + r) * D + d]) : 0.f;
          const int kk = idx / TE, e = idx % TE;
          d = d0 + kk;
          Ws[kk][e] = (e0 + e < Dh && d < D) ? to_f(W[(long long)d * Dh + e0 + e])
                                             : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) {
          float a[4], w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = Zs[kk][ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) w[j] = Ws[kk][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + ty + 16 * i;
        if (r >= rows) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = e0 + tx + 16 * j;
          if (e < Dh)
            store_f(out, (long long)r * ld + e,
                    bias ? acc[i][j] + to_f(bias[e]) : acc[i][j], nullptr);
        }
      }
    }
  }
}

// Dynamic shared memory of one block, in bytes: K [N][Dh+1], Q [QTILE][Dh]
// and WARPS score rows [N] in fp32, then V [N][Dh] in ZT.
__host__ __device__ inline size_t msa_smem_bytes(int N, int Dh, size_t zsize) {
  return sizeof(float) * ((size_t)N * (Dh + 1) + (size_t)QTILE * Dh +
                          (size_t)WARPS * N) +
         zsize * N * Dh;
}

template <typename ZT, typename WT>
__global__ void __launch_bounds__(THREADS)
vita_msa_kernel(const ZT* __restrict__ z, const WT* __restrict__ wq,
                const WT* __restrict__ wk, const WT* __restrict__ wv,
                const WT* __restrict__ qkv_bias,
                const float* __restrict__ bias, const float* __restrict__ mask,
                int nW, ZT* __restrict__ out, int N, int D, int H, int Dh,
                float scale) {
  extern __shared__ float smem[];
  __shared__ float Zs[KC][TM];
  __shared__ float Ws[KC][TE];
  const int ks = Dh + 1;                  // padded K row: lanes read distinct banks
  float* Ks = smem;                       // [N][Dh+1]
  float* Qs = Ks + (size_t)N * ks;        // [QTILE][Dh]
  const int warp = threadIdx.x / 32;
  float* prow = Qs + QTILE * Dh + (size_t)warp * N;   // [N]
  ZT* Vs = reinterpret_cast<ZT*>(Qs + QTILE * Dh + (size_t)WARPS * N);  // [N][Dh]
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * QTILE;
  const ZT* zb = z + (long long)b * N * D;
  const long long wo = (long long)h * D * Dh;
  const WT* qb = qkv_bias ? qkv_bias + (size_t)h * Dh : nullptr;
  const size_t part = (size_t)H * Dh;     // stride from the Q to the K to the V bias
  project(zb, D, 0, N, wk + wo, Dh, qb ? qb + part : nullptr, Ks, ks, Zs, Ws);
  project(zb, D, 0, N, wv + wo, Dh, qb ? qb + 2 * part : nullptr, Vs, Dh, Zs, Ws);
  const int rows = min(QTILE, N - q0);
  project(zb, D, q0, rows, wq + wo, Dh, qb, Qs, Dh, Zs, Ws);
  __syncthreads();
  const float* bias_h = bias ? bias + (size_t)h * N * N : nullptr;
  const float* mask_w = mask ? mask + (size_t)(b % nW) * N * N : nullptr;
  for (int r = warp; r < rows; r += WARPS) {
    const int n = q0 + r;
    attend_row(Qs + r * Dh, Ks, ks, Vs, N, Dh, scale,
               bias_h ? bias_h + (size_t)n * N : nullptr,
               mask_w ? mask_w + (size_t)n * N : nullptr, prow, out,
               (((long long)b * H + h) * N + n) * Dh, nullptr);
  }
}

}  // namespace repro_torch

// zt / wt: the ElemCode of z (and out) and of the weights and qkv_bias.
extern "C" int rt_vita_msa(const void* z, const void* wq, const void* wk,
                           const void* wv, const void* qkv_bias,
                           const float* bias, const float* mask, int nW,
                           void* out, int B, int N, int D, int H, int Dh,
                           float scale, int zt, int wt, void* stream) {
  using namespace repro_torch;
  return dispatch_mode(zt, wt, [&](auto ztag, auto wtag) {
    using ZT = typename decltype(ztag)::type;
    using WT = typename decltype(wtag)::type;
    const int smem = (int)msa_smem_bytes(N, Dh, sizeof(ZT));
    cudaError_t err = cudaFuncSetAttribute(
        vita_msa_kernel<ZT, WT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((N + QTILE - 1) / QTILE, H, B);
    vita_msa_kernel<ZT, WT><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const ZT*)z, (const WT*)wq, (const WT*)wk, (const WT*)wv,
        (const WT*)qkv_bias, bias, mask, nW, (ZT*)out, N, D, H, Dh, scale);
    return (int)cudaGetLastError();
  });
}

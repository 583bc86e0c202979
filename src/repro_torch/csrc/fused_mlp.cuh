// Pieces shared by the fused MLP's two regimes (fused_mlp.cu: few rows,
// fused_mlp_rows.cu: many rows): the hidden activation, the fragment addressing of
// the bf16 tensor-core path, the output store and the kernel that adds
// fp32 partials in order.
#pragma once

#include <algorithm>
#include <type_traits>

#include "async_copy.cuh"
#include "common.cuh"

namespace repro_torch {

constexpr int MLP_THREADS = 256, MLP_BH = 64;  // threads; hidden chunk

// The hidden value of column m: act(g) * (u + b1[m]) gated, else
// act(u + b1[m]), rounded to x's type (the TPU kernel's h.astype(x.dtype)
// before the second product); 0 outside the rows and the hidden width.
template <typename XT, typename WT>
__device__ __forceinline__ float hidden_value(float u, float g, bool in,
                                              const WT* __restrict__ b1,
                                              int m, int act, bool gated) {
  if (!in) return 0.f;
  if (b1) u += to_f(b1[m]);
  return round_to<XT>(gated ? activate(g, act) * u : activate(u, act));
}

// Four consecutive values at p (16 or 8 bytes, 16- or 8-byte aligned)
// as fp32.
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.y));
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}

// Element (r, col) of the output: into this block's fp32 partial, or, with
// no partial, plus b2 and rounded to x's type.
template <typename XT, typename WT>
__device__ __forceinline__ void emit(float v, int r, int col, int R,
                                     int Dout, XT* __restrict__ out,
                                     float* __restrict__ partial,
                                     long long part,
                                     const WT* __restrict__ b2) {
  if (r >= R || col >= Dout) return;
  const long long o = (long long)r * Dout + col;
  if (partial)
    partial[part * R * Dout + o] = v;
  else
    out[o] = from_f<XT>(b2 ? v + to_f(b2[col]) : v);
}

// out = sum over splits of partial (in split order) + b2, rounded to XT.
template <typename XT, typename WT>
__global__ void fused_mlp_finish(const float* __restrict__ partial,
                                 const WT* __restrict__ b2,
                                 XT* __restrict__ out, long long n, int Dout,
                                 int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
#pragma unroll 8  // the loads run ahead; the adds stay in split order
  for (int z = 0; z < splits; ++z) s += partial[z * n + i];
  if (b2) s += to_f(b2[i % Dout]);
  out[i] = from_f<XT>(s);
}

template <typename XT, typename WT>
int launch_finish(const float* partial, const WT* b2, XT* out, int R,
                  int Dout, int splits, cudaStream_t stream) {
  const long long n = (long long)R * Dout;
  fused_mlp_finish<XT, WT><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      partial, b2, out, n, Dout, splits);
  return (int)cudaGetLastError();
}

// Hidden chunks per block for `requested` splits (0: `target` blocks)
// over `chunks`, at most `cap` chunks a block; the splits that gives.
inline int split_chunks(int chunks, int requested, int target, int cap,
                        int* cpb) {
  const int want = std::max(1, requested > 0 ? requested : target);
  *cpb = std::min(std::max(1, (chunks + want - 1) / want), cap);
  return (chunks + *cpb - 1) / *cpb;
}

}  // namespace repro_torch

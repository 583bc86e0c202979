// Fused MLP: out = act(x W1 + b1) W2 + b2, or gated,
// out = (act(x Wg) * (x W1 + b1)) W2 + b2, with the hidden activation
// never in device memory.  x and out are XT, the weights and biases WT:
// float32 / float32, bf16 / bf16, or float32 x with bf16 weights (a bf16
// vision model served on float32 images); float32 sums.
//
// Replaces: repro/kernels/fused_mlp.py::fused_mlp (the paper's inter-layer
// MLP optimisation: hidden chunks are computed, pushed through the
// activation and consumed by the output accumulation at once).  The TPU
// kernel walks hidden chunks on a sequential grid axis with an (bn, D_out)
// VMEM accumulator, rounds each hidden chunk to x's dtype before the second
// product, and asserts n % bn == 0.
//
// Design: one block per (row tile, output-column slice, hidden split), as
// `make_plan` below lays them out.  The block's x rows stay resident in
// shared memory, in x's type (BR x D: 16 rows, or 8 where 16 do not fit;
// 80 KiB at D 2560 in bf16, 160 KiB in fp32).  It walks its hidden range in chunks of 64:
//   h = act(x_tile . Wg[:, chunk]) * (x_tile . W1[:, chunk] + b1[chunk])
//       (or act(x_tile . W1 + b1)), rounded to x's type (not the
//       weights': the TPU kernel's h.astype(x.dtype)) -> shared memory
//   acc += h . W2[chunk, slice]                         -> registers
// with the W1/Wg and W2 slices streamed through 16-deep shared-memory
// stages as float (bf16 weights exactly).  The accumulator is BR rows x (32*J) columns in
// registers (J <= 8), so an output wider than 256 columns is split across
// blocks, each recomputing the hidden chunk for its slice (10 slices at
// D_out 2560).  Where row tiles x slices leave the card's SMs idle (decode:
// 4 rows), the hidden dimension is split too: each split writes its
// float32 partial sums to `partial` (splits x R x D_out) and a second
// kernel adds them in split order, adds b2 and rounds to x's type.  Rows,
// hidden and output columns past the ends are masked.
// Bound: operations (2*R*M*(D*(1 + gated) + D_out) flops; the fp32 CUDA-core
// rate for fp32 inputs, the bf16 tensor-core rate for bf16) against the
// bytes of x, the weights and the output; at decode (R = 4) the weights'
// bytes bound it.  The recomputation per output slice adds
// (slices - 1) * 2*R*M*D*(1 + gated).  wgmma/TMA are later work.
#include <algorithm>

#include "common.cuh"

namespace repro_torch {

constexpr int WARPS = 8, THREADS = WARPS * 32, BH = 64, KC = 16;
constexpr int BR_MAX = 16;

template <typename XT, typename WT, int J, int RPW>
__global__ void __launch_bounds__(THREADS)
fused_mlp_kernel(const XT* __restrict__ x, const WT* __restrict__ w1,
                 const WT* __restrict__ b1, const WT* __restrict__ wg,
                 const WT* __restrict__ w2, const WT* __restrict__ b2,
                 XT* __restrict__ out, float* __restrict__ partial, int R,
                 int D, int Dp, int M, int Dout, int act, int chunks_per_split) {
  constexpr int BR = RPW * WARPS;         // the block's token rows
  constexpr int BO = 32 * J;              // the block's output columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  XT* Xs = reinterpret_cast<XT*>(smem_raw);  // [BR][Dp], Dp = D rounded up to KC
  __shared__ float W1s[KC][BH];
  __shared__ float Wgs[KC][BH];
  __shared__ float Hs[BR_MAX][BH];
  __shared__ float W2s[KC][BO];
  const int t = threadIdx.x, lane = t % 32, r0 = (t / 32) * RPW;
  const int row0 = blockIdx.x * BR, c0 = blockIdx.y * BO;
  const bool gated = wg != nullptr;
  for (int i = t; i < BR * Dp; i += THREADS) {
    const int r = i / Dp, d = i % Dp;
    Xs[i] = (row0 + r < R && d < D) ? x[(long long)(row0 + r) * D + d]
                                    : from_f<XT>(0.f);
  }
  const int m_begin = blockIdx.z * chunks_per_split * BH;
  const int m_end = min(M, m_begin + chunks_per_split * BH);
  float acc[RPW][J] = {};
  for (int m0 = m_begin; m0 < m_end; m0 += BH) {
    // u[r][c] = sum_d x[r][d] w1[d][m0 + c] (and g with wg), c = lane, lane + 32
    float hacc[RPW][2] = {}, gacc[RPW][2] = {};
    for (int d0 = 0; d0 < Dp; d0 += KC) {
#pragma unroll
      for (int l = 0; l < KC * BH / THREADS; ++l) {
        const int idx = t + THREADS * l, kk = idx / BH, c = idx % BH;
        const int d = d0 + kk, m = m0 + c;
        const bool in = d < D && m < M;
        const long long o = (long long)d * M + m;
        W1s[kk][c] = in ? to_f(w1[o]) : 0.f;
        if (gated) Wgs[kk][c] = in ? to_f(wg[o]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const float u0 = W1s[kk][lane], u1 = W1s[kk][lane + 32];
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const float xv = to_f(Xs[(r0 + i) * Dp + d0 + kk]);
          hacc[i][0] = fmaf(xv, u0, hacc[i][0]);
          hacc[i][1] = fmaf(xv, u1, hacc[i][1]);
        }
        if (gated) {
          const float g0 = Wgs[kk][lane], g1 = Wgs[kk][lane + 32];
#pragma unroll
          for (int i = 0; i < RPW; ++i) {
            const float xv = to_f(Xs[(r0 + i) * Dp + d0 + kk]);
            gacc[i][0] = fmaf(xv, g0, gacc[i][0]);
            gacc[i][1] = fmaf(xv, g1, gacc[i][1]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        const int c = lane + 32 * c2, m = m0 + c;
        float v = 0.f;
        if (m < M) {
          const float u = b1 ? hacc[i][c2] + to_f(b1[m]) : hacc[i][c2];
          v = gated ? activate(gacc[i][c2], act) * u : activate(u, act);
          v = round_to<XT>(v);
        }
        Hs[r0 + i][c] = v;
      }
    // acc[r][c] += sum_k h[r][k] * w2[m0 + k][c0 + c]
    for (int k0 = 0; k0 < BH; k0 += KC) {
#pragma unroll
      for (int l = 0; l < KC * BO / THREADS; ++l) {
        const int idx = t + THREADS * l, kk = idx / BO, c = idx % BO;
        const int m = m0 + k0 + kk, col = c0 + c;
        W2s[kk][c] = (m < M && col < Dout) ? to_f(w2[(long long)m * Dout + col])
                                           : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        float hv[RPW];
#pragma unroll
        for (int i = 0; i < RPW; ++i) hv[i] = Hs[r0 + i][k0 + kk];
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const float u = W2s[kk][lane + 32 * j];
#pragma unroll
          for (int i = 0; i < RPW; ++i) acc[i][j] = fmaf(hv[i], u, acc[i][j]);
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = row0 + r0 + i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int col = c0 + lane + 32 * j;
      if (col >= Dout) continue;
      const long long o = (long long)r * Dout + col;
      if (partial)
        partial[(long long)blockIdx.z * R * Dout + o] = acc[i][j];
      else
        out[o] = from_f<XT>(b2 ? acc[i][j] + to_f(b2[col]) : acc[i][j]);
    }
  }
}

// out = sum over splits of partial (in split order) + b2, rounded to XT.
template <typename XT, typename WT>
__global__ void fused_mlp_finish(const float* __restrict__ partial,
                                 const WT* __restrict__ b2, XT* __restrict__ out,
                                 long long n, int Dout, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[z * n + i];
  if (b2) s += to_f(b2[i % Dout]);
  out[i] = from_f<XT>(s);
}

// The launch plan, known only here: token rows per block (16, or 8 where
// 16 rows of x in its type and the largest static shared memory of the kernel
// pass the card's opt-in limit), the fewest output slices of at most 256
// columns, and hidden splits (1 where row tiles x slices cover the card's
// SMs, else about two blocks per SM, at most one split per 64-wide chunk).
struct Plan {
  int rows, slices, splits;
};

constexpr int STATIC_SMEM_MAX =
    (int)sizeof(float) * (2 * KC * BH + BR_MAX * BH + KC * 32 * 8);

int make_plan(int R, int D, int M, int Dout, int esize, Plan* p) {
  int dev = 0, limit = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long Dp = (D + KC - 1) / KC * KC;
  p->rows = 16 * esize * Dp + STATIC_SMEM_MAX <= limit  ? 16
            : 8 * esize * Dp + STATIC_SMEM_MAX <= limit ? 8
                                                        : 0;
  if (p->rows == 0) return (int)cudaErrorInvalidValue;  // D too wide
  p->slices = (Dout + 255) / 256;
  const int blocks = (R + p->rows - 1) / p->rows * p->slices;
  const int chunks = (M + BH - 1) / BH;
  p->splits =
      blocks >= sms ? 1 : std::min(chunks, (2 * sms + blocks - 1) / blocks);
  return (int)cudaSuccess;
}

template <typename XT, typename WT, int J, int RPW>
int launch(const XT* x, const WT* w1, const WT* b1, const WT* wg,
           const WT* w2, const WT* b2, XT* out, float* partial, int R, int D,
           int M, int Dout, int act, int slices, int splits,
           cudaStream_t stream) {
  constexpr int BR = RPW * WARPS;
  const int Dp = (D + KC - 1) / KC * KC;
  const int smem = (int)sizeof(XT) * BR * Dp;
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel<XT, WT, J, RPW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (M + BH - 1) / BH;
  const int cps = (chunks + splits - 1) / splits;
  splits = (chunks + cps - 1) / cps;
  dim3 grid((R + BR - 1) / BR, slices, splits);
  fused_mlp_kernel<XT, WT, J, RPW><<<grid, THREADS, smem, stream>>>(
      x, w1, b1, wg, w2, b2, out, splits > 1 ? partial : nullptr, R, D, Dp, M,
      Dout, act, cps);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long n = (long long)R * Dout;
  fused_mlp_finish<XT, WT><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      partial, b2, out, n, Dout, splits);
  return (int)cudaGetLastError();
}

template <typename XT, typename WT, int RPW>
int dispatch_j(const void* x, const void* w1, const void* b1, const void* wg,
               const void* w2, const void* b2, void* out, float* partial, int R,
               int D, int M, int Dout, int act, int slices, int splits,
               cudaStream_t s) {
  // Slices a multiple of 32 columns wide.
  const int J = ((Dout + slices - 1) / slices + 31) / 32;
  auto x_ = (const XT*)x;
  auto w1_ = (const WT*)w1, b1_ = (const WT*)b1, wg_ = (const WT*)wg,
       w2_ = (const WT*)w2, b2_ = (const WT*)b2;
  auto o_ = (XT*)out;
#define RT_MLP_CASE(JJ)                                                      \
  case JJ:                                                                   \
    return launch<XT, WT, JJ, RPW>(x_, w1_, b1_, wg_, w2_, b2_, o_, partial, \
                                   R, D, M, Dout, act, slices, splits, s);
  switch (J) {
    RT_MLP_CASE(1) RT_MLP_CASE(2) RT_MLP_CASE(3) RT_MLP_CASE(4)
    RT_MLP_CASE(5) RT_MLP_CASE(6) RT_MLP_CASE(7)
    default: RT_MLP_CASE(8)
  }
#undef RT_MLP_CASE
}

template <typename XT, typename WT>
int dispatch(const void* x, const void* w1, const void* b1, const void* wg,
             const void* w2, const void* b2, void* out, float* partial, int R,
             int D, int M, int Dout, int act, int splits, cudaStream_t s) {
  Plan p;
  const int err = make_plan(R, D, M, Dout, (int)sizeof(XT), &p);
  if (err != 0) return err;
  if (splits < 1 || (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  return p.rows == 16
             ? dispatch_j<XT, WT, 2>(x, w1, b1, wg, w2, b2, out, partial, R,
                                     D, M, Dout, act, p.slices, splits, s)
             : dispatch_j<XT, WT, 1>(x, w1, b1, wg, w2, b2, out, partial, R,
                                     D, M, Dout, act, p.slices, splits, s);
}

}  // namespace repro_torch

// The plan's hidden splits for R rows of x (D wide, x's ElemCode kF32 or
// kBF16) through an M-wide hidden to Dout columns: the caller sizes
// `partial` from them.
extern "C" int rt_fused_mlp_splits(int R, int D, int M, int Dout, int dtype,
                                   int* splits) {
  repro_torch::Plan p{0, 0, 1};
  const int err = repro_torch::make_plan(
      R, D, M, Dout, dtype == repro_torch::kBF16 ? 2 : 4, &p);
  *splits = p.splits;
  return err;
}

// splits: hidden splits (1 = none; else `partial` holds splits x R x Dout
// floats); xt: the ElemCode of x and out, wt: of every weight and bias
// (`dispatch_mode`: float32 / float32, float32 / bf16, bf16 / bf16).
extern "C" int rt_fused_mlp(const void* x, const void* w1, const void* b1,
                            const void* wg, const void* w2, const void* b2,
                            void* out, float* partial, int R, int D, int M,
                            int Dout, int act, int splits, int xt, int wt,
                            void* stream) {
  using namespace repro_torch;
  cudaStream_t s = (cudaStream_t)stream;
  return dispatch_mode(xt, wt, [&](auto xtag, auto wtag) {
    return dispatch<typename decltype(xtag)::type,
                    typename decltype(wtag)::type>(
        x, w1, b1, wg, w2, b2, out, partial, R, D, M, Dout, act, splits, s);
  });
}

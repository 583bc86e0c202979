// Fused GELU MLP: out = gelu(x W1 + b1) W2 + b2, the hidden activation
// never in device memory.
//
// Replaces: repro/kernels/fused_mlp.py::fused_mlp (the paper's inter-layer
// MLP optimisation: hidden chunks are computed, pushed through the
// activation and consumed by the output accumulation at once).  The TPU
// kernel walks hidden chunks on a sequential grid axis with an (bn, D_out)
// VMEM accumulator and asserts n % bn == 0.
//
// Design: one block per (16-token tile, output-column slice).  The block's
// x rows stay resident in shared memory (16 x D floats, 12 KiB at D 192,
// 48 KiB at D 768).  It walks the hidden dimension in chunks of 64:
//   h = gelu(x_tile . W1[:, chunk] + b1[chunk])   -> shared memory (4 KiB)
//   acc += h . W2[chunk, slice]                   -> registers
// with the W1 and W2 slices streamed through 16-deep shared-memory stages,
// and adds b2 once at the end.  The accumulator is 16 rows x (32*J) columns
// in registers (J <= 8, two rows and J columns per thread), so an output
// wider than 256 columns is split across blocks and each block recomputes
// the hidden chunk for its slice: once at D_out 96-256 (ViT/DeiT-T, Swin-T
// stages 1-2), twice at 384 (stage 3), three times at 768 (stage 4,
// ViT-B).  Token counts are ragged (1568 at DeiT-T batch 8, 392 to 25,088
// at Swin-T): rows past the end are zero-filled and never written, and the
// hidden and output edges are masked the same way.
// Bound: operations (2*R*M*(D + D_out) flops at 67 TFLOP/s against
// 4*(R*(D + D_out) + D*M + M*D_out) bytes), on CUDA cores; the
// recomputation above adds (slices - 1) * 2*R*M*D.  wgmma/TMA are later
// work.
#include "common.cuh"

namespace repro_torch {

constexpr int WARPS = 8, THREADS = WARPS * 32, BR = 16, RPW = BR / WARPS;
constexpr int BH = 64, KC = 16;

template <int J>
__global__ void __launch_bounds__(THREADS)
fused_mlp_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ w2,
                 const float* __restrict__ b2, float* __restrict__ out, int R,
                 int D, int Dp, int M, int Dout) {
  constexpr int BO = 32 * J;              // the block's output columns
  extern __shared__ float Xs[];           // [BR][Dp], Dp = D rounded up to KC
  __shared__ float W1s[KC][BH];
  __shared__ float Hs[BR][BH];
  __shared__ float W2s[KC][BO];
  const int t = threadIdx.x, lane = t % 32, r0 = (t / 32) * RPW;
  const int row0 = blockIdx.x * BR, c0 = blockIdx.y * BO;
  for (int i = t; i < BR * Dp; i += THREADS) {
    const int r = i / Dp, d = i % Dp;
    Xs[i] = (row0 + r < R && d < D) ? x[(long long)(row0 + r) * D + d] : 0.f;
  }
  float acc[RPW][J] = {};
  for (int m0 = 0; m0 < M; m0 += BH) {
    // h[r][c] = gelu(sum_d x[r][d] * w1[d][m0 + c] + b1[m0 + c]), c = lane, lane + 32
    float hacc[RPW][2] = {};
    for (int d0 = 0; d0 < Dp; d0 += KC) {
#pragma unroll
      for (int l = 0; l < KC * BH / THREADS; ++l) {
        const int idx = t + THREADS * l, kk = idx / BH, c = idx % BH;
        const int d = d0 + kk, m = m0 + c;
        W1s[kk][c] = (d < D && m < M) ? w1[(long long)d * M + m] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const float u0 = W1s[kk][lane], u1 = W1s[kk][lane + 32];
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const float xv = Xs[(r0 + i) * Dp + d0 + kk];
          hacc[i][0] = fmaf(xv, u0, hacc[i][0]);
          hacc[i][1] = fmaf(xv, u1, hacc[i][1]);
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
        if (m < M) v = gelu_tanh(b1 ? hacc[i][c2] + b1[m] : hacc[i][c2]);
        Hs[r0 + i][c] = v;
      }
    // acc[r][c] += sum_k h[r][k] * w2[m0 + k][c0 + c]
    for (int k0 = 0; k0 < BH; k0 += KC) {
#pragma unroll
      for (int l = 0; l < KC * BO / THREADS; ++l) {
        const int idx = t + THREADS * l, kk = idx / BO, c = idx % BO;
        const int m = m0 + k0 + kk, col = c0 + c;
        W2s[kk][c] = (m < M && col < Dout) ? w2[(long long)m * Dout + col] : 0.f;
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
      if (col < Dout)
        out[(long long)r * Dout + col] = b2 ? acc[i][j] + b2[col] : acc[i][j];
    }
  }
}

template <int J>
int launch(const float* x, const float* w1, const float* b1, const float* w2,
           const float* b2, float* out, int R, int D, int M, int Dout,
           int slices, cudaStream_t stream) {
  const int Dp = (D + KC - 1) / KC * KC;
  const int smem = (int)sizeof(float) * BR * Dp;
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel<J>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((R + BR - 1) / BR, slices);
  fused_mlp_kernel<J><<<grid, THREADS, smem, stream>>>(x, w1, b1, w2, b2, out,
                                                       R, D, Dp, M, Dout);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

extern "C" int rt_fused_mlp(const float* x, const float* w1, const float* b1,
                            const float* w2, const float* b2, float* out, int R,
                            int D, int M, int Dout, void* stream) {
  using namespace repro_torch;
  // The fewest slices of at most 256 columns, each a multiple of 32 wide.
  const int slices = (Dout + 255) / 256;
  const int J = ((Dout + slices - 1) / slices + 31) / 32;
  cudaStream_t s = (cudaStream_t)stream;
  switch (J) {
    case 1: return launch<1>(x, w1, b1, w2, b2, out, R, D, M, Dout, slices, s);
    case 2: return launch<2>(x, w1, b1, w2, b2, out, R, D, M, Dout, slices, s);
    case 3: return launch<3>(x, w1, b1, w2, b2, out, R, D, M, Dout, slices, s);
    case 4: return launch<4>(x, w1, b1, w2, b2, out, R, D, M, Dout, slices, s);
    case 5: return launch<5>(x, w1, b1, w2, b2, out, R, D, M, Dout, slices, s);
    case 6: return launch<6>(x, w1, b1, w2, b2, out, R, D, M, Dout, slices, s);
    case 7: return launch<7>(x, w1, b1, w2, b2, out, R, D, M, Dout, slices, s);
    default: return launch<8>(x, w1, b1, w2, b2, out, R, D, M, Dout, slices, s);
  }
}

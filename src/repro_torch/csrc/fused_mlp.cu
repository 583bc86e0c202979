// Fused MLP, few rows (a decode step or a short prompt: at most 16 rows
// of x): out = act(x W1 + b1) W2 + b2, or gated,
// out = (act(x Wg) * (x W1 + b1)) W2 + b2, with the hidden activation
// never in device memory.  x and out are XT, the weights and biases WT:
// float32 / float32, bf16 / bf16, or float32 x with bf16 weights (a bf16
// vision model served on float32 images); float32 sums.  Many rows go to
// fused_mlp_rows.cu (the wrapper's plan, kernels/fused_mlp.py).
//
// Replaces: repro/kernels/fused_mlp.py::fused_mlp (the paper's inter-layer
// MLP optimisation: hidden chunks are computed, pushed through the
// activation and consumed by the output accumulation at once).  The TPU
// kernel walks hidden chunks on a sequential grid axis with an (bn, D_out)
// VMEM accumulator, rounds each hidden chunk to x's dtype before the second
// product, and asserts n % bn == 0.
//
// Bound: bytes.  With 4-16 rows the products are 2-32 flops per weight
// byte, so the weights (D x M, twice gated, and M x D_out) have to be read
// once at the memory's rate: 118 MB, 35 us, at RecurrentGemma-2B's D 2560,
// M 7680 in bf16.
// Design: every weight byte is read once.
//   * Block z takes a range of 64-wide hidden chunks (about one block per
//     SM: `split_chunks`, at most 8 chunks a block) and ALL D_out
//     columns, so each hidden chunk is computed exactly once.  Phase 1
//     computes the block's hidden chunks (all rows, padded to 16) into
//     shared memory, rounded to x's type; phase 2 walks the output in
//     column tiles, each the sum over the block's hidden rows, and writes
//     it once: into the block's fp32 partial (rows x D_out), which a
//     finish kernel adds in block order with b2, rounded to x's type (a
//     single block writes out itself).
//   * x, W1 and Wg tiles (phase 1: 128 rows of D in bf16, 64 in fp32) and
//     W2 tiles (phase 2: 64 hidden rows x 512 bytes) are one sequence of
//     steps through a four-stage ring of 16-byte cp.async copies (up to
//     45 KiB a stage, ~100 KiB in flight per SM), so phase 2's weights are
//     in flight while phase 1 ends.  Fewer, larger steps paid: on the
//     H100 the step count, not the ring's depth, set the time (4, 6 or 8
//     stages of half this depth ran alike; twice the depth ran faster).  Tile rows are padded by 16 bytes so
//     that ldmatrix rows fall on distinct banks.  Rows, hidden and output
//     columns past the ends are zero-filled.
//   * bf16: mma.sync m16n8k16 (bf16 in, fp32 accumulate) on ldmatrix
//     fragments, the rows padded to 16.  fp32 and mixed: fp32 FMAs on CUDA
//     cores, each thread a column and up to 4 (phase 1) or 8-16 (phase 2)
//     rows, x and h read 4 deep along k; the row count and the gate are
//     template constants of the inner loops, which have no branch (a
//     branch kept the loads from running ahead of the FMAs).
#include "fused_mlp.cuh"

namespace repro_torch {

constexpr int FEW_ROWS = 16, FEW_STAGES = 4, FEW_CPB_MAX = 8;

template <typename XT, typename WT>
struct Few {
  static constexpr bool TC = sizeof(XT) == 2;  // bf16 x and weights: mma
  static constexpr int KT = 256 / (int)sizeof(WT);  // phase-1 depth
  static constexpr int NT = 512 / (int)sizeof(WT);  // phase-2 width
  static constexpr int SX = KT * (int)sizeof(XT) + 16;
  static constexpr int SW = MLP_BH * (int)sizeof(WT) + 16;
  static constexpr int S2 = NT * (int)sizeof(WT) + 16;
  static constexpr int P1 = FEW_ROWS * SX + 2 * KT * SW;
  static constexpr int P2 = MLP_BH * S2;
  static constexpr int STAGE = P1 > P2 ? P1 : P2;
  using HT = typename std::conditional<TC, __nv_bfloat16, float>::type;
  static __host__ __device__ int hs_stride(int cpb) {
    return cpb * MLP_BH * (int)sizeof(HT) + 16;
  }
  static int smem(int cpb) {
    return FEW_STAGES * STAGE + FEW_ROWS * hs_stride(cpb);
  }
};

template <typename XT, typename WT>
__global__ void __launch_bounds__(MLP_THREADS)
fused_mlp_kernel(const XT* __restrict__ x, const WT* __restrict__ w1,
                 const WT* __restrict__ b1, const WT* __restrict__ wg,
                 const WT* __restrict__ w2, const WT* __restrict__ b2,
                 XT* __restrict__ out, float* __restrict__ partial, int R,
                 int D, int M, int Dout, int act, int cpb, int vecs) {
  using C = Few<XT, WT>;
  constexpr int KT = C::KT, NT = C::NT, BH = MLP_BH;
  extern __shared__ __align__(16) unsigned char smem[];
  const bool gated = wg != nullptr;
  const bool vx = vecs & 1, vw1 = vecs & 2, vw2 = vecs & 4;
  const int chunks = (M + BH - 1) / BH;
  const int c_begin = blockIdx.x * cpb, ncb = min(cpb, chunks - c_begin);
  const int nk1 = (D + KT - 1) / KT, p1 = ncb * nk1;
  const int total = p1 + (Dout + NT - 1) / NT * ncb;
  unsigned char* hs = smem + FEW_STAGES * C::STAGE;
  const int hss = C::hs_stride(cpb);
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;

  auto issue = [&](int s) {
    unsigned char* st = smem + (s % FEW_STAGES) * C::STAGE;
    if (s < p1) {
      const int d0 = (s % nk1) * KT, m0 = (c_begin + s / nk1) * BH;
      load_tile<XT, MLP_THREADS>(st, C::SX, x, D, 0, R, d0, D, FEW_ROWS, KT,
                                 vx);
      st += FEW_ROWS * C::SX;
      load_tile<WT, MLP_THREADS>(st, C::SW, w1, M, d0, D, m0, M, KT, BH,
                                 vw1);
      if (gated)
        load_tile<WT, MLP_THREADS>(st + KT * C::SW, C::SW, wg, M, d0, D, m0,
                                   M, KT, BH, vw1);
    } else {
      const int s2 = s - p1;
      load_tile<WT, MLP_THREADS>(st, C::S2, w2, Dout,
                                 (c_begin + s2 % ncb) * BH, M, s2 / ncb * NT,
                                 Dout, BH, NT, vw2);
    }
  };

  // Phase 1: hacc / gacc (the up and gate products); phase 2: oacc.
  float hacc[4], gacc[4], oacc[4][4];
  for (int s = 0; s < FEW_STAGES - 1; ++s) {
    if (s < total) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < total; ++s) {
    if (s + FEW_STAGES - 1 < total) issue(s + FEW_STAGES - 1);
    cp_async_commit();
    cp_async_wait<FEW_STAGES - 1>();
    __syncthreads();
    const unsigned char* st = smem + (s % FEW_STAGES) * C::STAGE;
    if (s < p1) {
      const int kt = s % nk1, cl = s / nk1, m0 = (c_begin + cl) * BH;
      if (kt == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) hacc[i] = gacc[i] = 0.f;
      }
      const unsigned char* w1s = st + FEW_ROWS * C::SX;
      const unsigned char* wgs = w1s + KT * C::SW;
      if constexpr (C::TC) {
        // Warp w: hidden columns [8w, 8w + 8) of the chunk, all 16 rows
        // (the gate's branch outside the loop keeps it straight-line).
        auto products = [&](auto gated_c) {
#pragma unroll
          for (int k2 = 0; k2 < KT / 32; ++k2) {
            uint32_t a0[4], a1[4], b[4];
            const unsigned char* xa =
                st + lm_row(lane) * C::SX + (k2 * 32 + lm_col(lane)) * 2;
            ldmatrix_x4(a0, xa);
            ldmatrix_x4(a1, xa + 32);
            ldmatrix_x4_trans(b, w1s + (k2 * 32 + lane) * C::SW + warp * 16);
            mma_bf16_16816(hacc, a0, b[0], b[1]);
            mma_bf16_16816(hacc, a1, b[2], b[3]);
            if constexpr (decltype(gated_c)::value) {
              ldmatrix_x4_trans(b,
                                wgs + (k2 * 32 + lane) * C::SW + warp * 16);
              mma_bf16_16816(gacc, a0, b[0], b[1]);
              mma_bf16_16816(gacc, a1, b[2], b[3]);
            }
          }
        };
        if (gated)
          products(std::true_type{});
        else
          products(std::false_type{});
        if (kt == nk1 - 1) {
          const int g = lane / 4, col = warp * 8 + 2 * (lane % 4);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = g + 8 * h;
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              v[e] = hidden_value<XT, WT>(hacc[2 * h + e], gacc[2 * h + e],
                                          r < R && m0 + col + e < M, b1,
                                          m0 + col + e, act, gated);
            *reinterpret_cast<__nv_bfloat162*>(
                hs + r * hss + (cl * BH + col) * 2) =
                __floats2bfloat162_rn(v[0], v[1]);
          }
        }
      } else {
        // Thread: hidden column t % 64, rows t / 64 + 4i (x, fp32 here,
        // read 4 deep along k).  The loop is straight-line: one row where
        // the thread has one valid row (a decode step's 4), else 4 (rows
        // past R are zeros), the gate's branch outside it.
        const int col = t % BH, rq = t / BH;
        constexpr int SWE = C::SW / (int)sizeof(WT);
        const WT* w1r = reinterpret_cast<const WT*>(w1s) + col;
        const WT* wgr = reinterpret_cast<const WT*>(wgs) + col;
        auto products = [&](auto nr_c, auto gated_c) {
          constexpr int NR = decltype(nr_c)::value;
          constexpr bool GATED = decltype(gated_c)::value;
          for (int k = 0; k < KT; k += 4) {
            float xv[NR][4];
#pragma unroll
            for (int i = 0; i < NR; ++i)
              load4(reinterpret_cast<const float*>(st + (rq + 4 * i) * C::SX) +
                        k, xv[i]);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const float u = to_f(w1r[(k + kk) * SWE]);
#pragma unroll
              for (int i = 0; i < NR; ++i)
                hacc[i] = fmaf(xv[i][kk], u, hacc[i]);
              if constexpr (GATED) {
                const float gw = to_f(wgr[(k + kk) * SWE]);
#pragma unroll
                for (int i = 0; i < NR; ++i)
                  gacc[i] = fmaf(xv[i][kk], gw, gacc[i]);
              }
            }
          }
        };
        if (R - rq <= 4)
          gated ? products(std::integral_constant<int, 1>{}, std::true_type{})
                : products(std::integral_constant<int, 1>{},
                           std::false_type{});
        else
          gated ? products(std::integral_constant<int, 4>{}, std::true_type{})
                : products(std::integral_constant<int, 4>{},
                           std::false_type{});
        if (kt == nk1 - 1) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = rq + 4 * i, m = m0 + col;
            reinterpret_cast<float*>(hs + r * hss)[cl * BH + col] =
                hidden_value<XT, WT>(hacc[i], gacc[i], r < R && m < M, b1,
                                     m, act, gated);
          }
        }
      }
    } else {
      const int s2 = s - p1, kc = s2 % ncb, n0 = s2 / ncb * NT;
      if (kc == 0) {
#pragma unroll
        for (int i = 0; i < 16; ++i) oacc[i / 4][i % 4] = 0.f;
      }
      if constexpr (C::TC) {
        // Warp w: output columns [32w, 32w + 32) of the tile.
#pragma unroll
        for (int ks = 0; ks < BH / 16; ++ks) {
          uint32_t a[4], b[4];
          ldmatrix_x4(a, hs + lm_row(lane) * hss +
                             (kc * BH + ks * 16 + lm_col(lane)) * 2);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            ldmatrix_x4_trans(b, st + (ks * 16 + lm_row(lane)) * C::S2 +
                                     (warp * 32 + 16 * np + lm_col(lane)) * 2);
            mma_bf16_16816(oacc[2 * np], a, b[0], b[1]);
            mma_bf16_16816(oacc[2 * np + 1], a, b[2], b[3]);
          }
        }
        if (kc == ncb - 1) {
          const int g = lane / 4;
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              emit<XT, WT>(oacc[j][i], g + 8 * (i / 2),
                           n0 + warp * 32 + 8 * j + 2 * (lane % 4) + i % 2,
                           R, Dout, out, partial, blockIdx.x, b2);
        }
      } else {
        // Thread: output column t % NT, rows t / NT + RG i (h read 4
        // deep along k); the rows a thread owns at R <= 4, or all RPT
        // (rows past R are zeros), in a straight-line loop.
        constexpr int RG = MLP_THREADS / NT, RPT = FEW_ROWS / RG;
        constexpr int SMALL = 4 / RG, S2E = C::S2 / (int)sizeof(WT);
        const int col = t % NT, rq = t / NT;
        const WT* w2r = reinterpret_cast<const WT*>(st) + col;
        const float* hr = reinterpret_cast<const float*>(hs) + kc * BH;
        const int hse = hss / 4;
        auto products = [&](auto nr_c) {
          constexpr int NR = decltype(nr_c)::value;
          for (int k = 0; k < BH; k += 4) {
            float h[NR][4];
#pragma unroll
            for (int i = 0; i < NR; ++i)
              load4(hr + (rq + RG * i) * hse + k, h[i]);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const float w = to_f(w2r[(k + kk) * S2E]);
#pragma unroll
              for (int i = 0; i < NR; ++i)
                oacc[i / 4][i % 4] =
                    fmaf(h[i][kk], w, oacc[i / 4][i % 4]);
            }
          }
        };
        if (R <= 4)
          products(std::integral_constant<int, SMALL>{});
        else
          products(std::integral_constant<int, RPT>{});
        if (kc == ncb - 1) {
#pragma unroll
          for (int i = 0; i < RPT; ++i)
            emit<XT, WT>(oacc[i / 4][i % 4], rq + RG * i, n0 + col, R, Dout,
                         out, partial, blockIdx.x, b2);
        }
      }
    }
    __syncthreads();  // the stage is free for the step STAGES - 1 ahead
  }
  cp_async_wait<0>();
}

// Chunks per block and the splits (blocks) for `requested` splits (0:
// one block per SM).
int few_plan(int M, int requested, int* cpb, int* splits) {
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  *splits = split_chunks((M + MLP_BH - 1) / MLP_BH, requested, sms,
                         FEW_CPB_MAX, cpb);
  return 0;
}

template <typename XT, typename WT>
int launch(const void* x_, const void* w1_, const void* b1_, const void* wg_,
           const void* w2_, const void* b2_, void* out_, float* partial,
           int R, int D, int M, int Dout, int act, int splits,
           cudaStream_t stream) {
  using C = Few<XT, WT>;
  auto x = (const XT*)x_;
  auto w1 = (const WT*)w1_, b1 = (const WT*)b1_, wg = (const WT*)wg_,
       w2 = (const WT*)w2_, b2 = (const WT*)b2_;
  auto out = (XT*)out_;
  if (R > FEW_ROWS) return (int)cudaErrorInvalidValue;
  int cpb = 1;
  int err = few_plan(M, splits, &cpb, &splits);
  if (err != 0) return err;
  if (splits > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  const int smem = C::smem(cpb);
  cudaError_t e = cudaFuncSetAttribute(
      fused_mlp_kernel<XT, WT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const int vecs = (vec_ok<XT>(x, D) ? 1 : 0) |
                   (vec_ok<WT>(w1, M) && (!wg || vec_ok<WT>(wg, M)) ? 2 : 0) |
                   (vec_ok<WT>(w2, Dout) ? 4 : 0);
  fused_mlp_kernel<XT, WT><<<splits, MLP_THREADS, smem, stream>>>(
      x, w1, b1, wg, w2, b2, out, splits > 1 ? partial : nullptr, R, D, M,
      Dout, act, cpb, vecs);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  return launch_finish<XT, WT>(partial, b2, out, R, Dout, splits, stream);
}

}  // namespace repro_torch

// The hidden splits (blocks, each writing an R x Dout fp32 partial) the
// few-rows plan makes for an M-wide hidden: one block per SM, or about
// `requested` (> 0), never more than 8 chunks of 64 a block.  R, D, Dout
// and dtype do not change it.
extern "C" int rt_fused_mlp_splits(int R, int D, int M, int Dout, int dtype,
                                   int requested, int* splits) {
  int cpb = 1;
  (void)R; (void)D; (void)Dout; (void)dtype;
  return repro_torch::few_plan(M, requested, &cpb, splits);
}

// R <= 16 rows; splits: from rt_fused_mlp_splits (1: no partial, else
// `partial` holds splits x R x Dout floats); xt: the ElemCode of x and
// out, wt: of every weight and bias (`dispatch_mode`).
extern "C" int rt_fused_mlp(const void* x, const void* w1, const void* b1,
                            const void* wg, const void* w2, const void* b2,
                            void* out, float* partial, int R, int D, int M,
                            int Dout, int act, int splits, int xt, int wt,
                            void* stream) {
  using namespace repro_torch;
  cudaStream_t s = (cudaStream_t)stream;
  return dispatch_mode(xt, wt, [&](auto xtag, auto wtag) {
    return launch<typename decltype(xtag)::type,
                  typename decltype(wtag)::type>(
        x, w1, b1, wg, w2, b2, out, partial, R, D, M, Dout, act, splits, s);
  });
}

// Fused MLP, many rows (vision tokens, long prompts: more than 16 rows of
// x): out = act(x W1 + b1) W2 + b2, or gated, as in fused_mlp.cu, in the
// same three dtype modes; float32 sums.
//
// Replaces: repro/kernels/fused_mlp.py::fused_mlp (see fused_mlp.cu; this
// file is its many-rows regime, chosen by the wrapper's plan).
//
// Bound: operations, 2 * R * M * (D * (1 + gated) + D_out) flops: on the
// bf16 tensor cores for bf16 x, at the fp32 CUDA-core rate otherwise.
// Design: one block per (row tile: 64 rows in bf16, 32 in fp32; output
// slice of at most 256 columns; hidden split).  The block walks its
// hidden chunks of 64.  Phase 1 computes
//   h = act(x_tile . Wg[:, chunk]) * (x_tile . W1[:, chunk] + b1)
// (or act(x_tile . W1 + b1)) over D in 64- (bf16) or 32-deep steps and
// rounds it to x's type into shared memory; phase 2 adds h . W2[chunk,
// slice], 64 (bf16) or 16 hidden rows a step, to the block's accumulator
// in registers.  Every x, W1, Wg and W2 tile is one step of a four-stage
// ring of 16-byte cp.async copies with 16-byte row padding (ldmatrix rows
// on distinct banks); rows, hidden and output columns past the ends are
// zero-filled.  Outputs wider than 256 columns recompute the hidden chunk
// once per slice (3 slices at D_out 768).  Where row tiles x slices leave
// the card's SMs idle (DeiT-T's 1,576 rows are 25 tiles), the hidden
// chunks split across blocks too, each writing an fp32 partial that a
// finish kernel adds in split order with b2 (one wave of blocks).
//   * bf16: mma.sync m16n8k16 (bf16 in, fp32 accumulate) fed by ldmatrix;
//     8 warps as 4 (16 rows) x 2 (half the columns) in both phases.
//   * fp32 and mixed (fp32 x, bf16 weights exact in fp32): fp32 FMAs with
//     a register-blocked tile, 2 x 4 (x2, gated) hidden values and 4 x 8
//     outputs a thread, x and h read 4 deep along k per 16-byte load.
//     Split-precision TF32 on the tensor cores is later work: its error
//     against the fp32 checks is not measured.
//   * In both, the gate, the slice width and the warp's column pairs are
//     template constants of branch-free inner loops (a branch kept the
//     shared loads from running ahead of the products).
#include "fused_mlp.cuh"

namespace repro_torch {

constexpr int ROWS_STAGES = 4, ROWS_BO = 256;

// Rows of a block's tile: 64 on the tensor cores (one block per SM: 162
// registers a thread), 32 with FMAs (two blocks per SM hide the latency
// of the shared-memory operands).
inline int rows_tile(bool tc) { return tc ? 64 : 32; }
inline int rows_blocks_per_sm(bool tc) { return tc ? 1 : 2; }

template <typename XT, typename WT>
struct Rows {
  static constexpr bool TC = sizeof(XT) == 2;  // bf16 x and weights: mma
  static constexpr int BR = TC ? 64 : 32;
  static constexpr int MIN_BLOCKS = TC ? 1 : 2;
  static constexpr int KT1 = TC ? 64 : 32, KT2 = TC ? 64 : 16;  // step rows
  static constexpr int RP1 = BR / 16, RP2 = BR / 8;  // FMA rows a thread
  static constexpr int SX = KT1 * (int)sizeof(XT) + 16;
  static constexpr int SW = MLP_BH * (int)sizeof(WT) + 16;
  static constexpr int S2 = ROWS_BO * (int)sizeof(WT) + 16;
  static constexpr int P1 = BR * SX + 2 * KT1 * SW;
  static constexpr int P2 = KT2 * S2;
  static constexpr int STAGE = P1 > P2 ? P1 : P2;
  using HT = typename std::conditional<TC, __nv_bfloat16, float>::type;
  static constexpr int HSS = MLP_BH * (int)sizeof(HT) + 16;
  static constexpr int SMEM = ROWS_STAGES * STAGE + BR * HSS;
};

template <typename XT, typename WT>
__global__ void __launch_bounds__(MLP_THREADS, (Rows<XT, WT>::MIN_BLOCKS))
fused_mlp_rows_kernel(const XT* __restrict__ x, const WT* __restrict__ w1,
                      const WT* __restrict__ b1, const WT* __restrict__ wg,
                      const WT* __restrict__ w2, const WT* __restrict__ b2,
                      XT* __restrict__ out, float* __restrict__ partial,
                      int R, int D, int M, int Dout, int act, int bo, int cps,
                      int vecs) {
  using C = Rows<XT, WT>;
  constexpr int KT1 = C::KT1, KT2 = C::KT2, BH = MLP_BH, BR = C::BR;
  extern __shared__ __align__(16) unsigned char smem[];
  const bool gated = wg != nullptr;
  const bool vx = vecs & 1, vw1 = vecs & 2, vw2 = vecs & 4;
  const int row0 = blockIdx.x * BR, c0 = blockIdx.y * bo, z = blockIdx.z;
  const int chunks = (M + BH - 1) / BH, ch0 = z * cps;
  const int nch = min(cps, chunks - ch0);
  const int nk1 = (D + KT1 - 1) / KT1, per = nk1 + BH / KT2;
  const int total = nch * per;
  unsigned char* hs = smem + ROWS_STAGES * C::STAGE;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;

  auto issue = [&](int s) {
    unsigned char* st = smem + (s % ROWS_STAGES) * C::STAGE;
    const int j = s % per, m0 = (ch0 + s / per) * BH;
    if (j < nk1) {
      const int d0 = j * KT1;
      load_tile<XT, MLP_THREADS>(st, C::SX, x, D, row0, R, d0, D, BR, KT1,
                                 vx);
      st += BR * C::SX;
      load_tile<WT, MLP_THREADS>(st, C::SW, w1, M, d0, D, m0, M, KT1, BH,
                                 vw1);
      if (gated)
        load_tile<WT, MLP_THREADS>(st + KT1 * C::SW, C::SW, wg, M, d0, D, m0,
                                   M, KT1, BH, vw1);
    } else {
      load_tile<WT, MLP_THREADS>(st, C::S2, w2, Dout, m0 + (j - nk1) * KT2,
                                 M, c0, Dout, KT2, bo, vw2);
    }
  };

  // Phase 1: hacc / gacc; phase 2: oacc, the block's output tile.
  float hacc[4][4], gacc[4][4], oacc[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  const int half = bo / 2, ntp = half / 16;  // TC: a warp's column pairs
  for (int s = 0; s < ROWS_STAGES - 1; ++s) {
    if (s < total) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < total; ++s) {
    if (s + ROWS_STAGES - 1 < total) issue(s + ROWS_STAGES - 1);
    cp_async_commit();
    cp_async_wait<ROWS_STAGES - 1>();
    __syncthreads();
    const unsigned char* st = smem + (s % ROWS_STAGES) * C::STAGE;
    const int j = s % per, m0 = (ch0 + s / per) * BH;
    if (j < nk1) {
      if (j == 0) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) hacc[n][e] = gacc[n][e] = 0.f;
      }
      const unsigned char* w1s = st + BR * C::SX;
      const unsigned char* wgs = w1s + KT1 * C::SW;
      if constexpr (C::TC) {
        // Warp (wr, wc): rows [16 wr, +16), hidden columns [32 wc, +32).
        const int wr = warp % 4, wc = warp / 4;
        auto products = [&](auto gated_c) {
#pragma unroll
          for (int ks = 0; ks < KT1 / 16; ++ks) {
            uint32_t a[4], b[4];
            ldmatrix_x4(a, st + (16 * wr + lm_row(lane)) * C::SX +
                               (ks * 16 + lm_col(lane)) * 2);
#pragma unroll
            for (int np = 0; np < 2; ++np) {
              const int off = (ks * 16 + lm_row(lane)) * C::SW +
                              (32 * wc + 16 * np + lm_col(lane)) * 2;
              ldmatrix_x4_trans(b, w1s + off);
              mma_bf16_16816(hacc[2 * np], a, b[0], b[1]);
              mma_bf16_16816(hacc[2 * np + 1], a, b[2], b[3]);
              if constexpr (decltype(gated_c)::value) {
                ldmatrix_x4_trans(b, wgs + off);
                mma_bf16_16816(gacc[2 * np], a, b[0], b[1]);
                mma_bf16_16816(gacc[2 * np + 1], a, b[2], b[3]);
              }
            }
          }
        };
        if (gated)
          products(std::true_type{});
        else
          products(std::false_type{});
        if (j == nk1 - 1) {
          const int g = lane / 4;
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = 16 * wr + g + 8 * h;
              const int col = 32 * wc + 8 * n + 2 * (lane % 4);
              float v[2];
#pragma unroll
              for (int e = 0; e < 2; ++e)
                v[e] = hidden_value<XT, WT>(
                    hacc[n][2 * h + e], gacc[n][2 * h + e],
                    row0 + r < R && m0 + col + e < M, b1, m0 + col + e, act,
                    gated);
              *reinterpret_cast<__nv_bfloat162*>(hs + r * C::HSS + col * 2) =
                  __floats2bfloat162_rn(v[0], v[1]);
            }
        }
      } else {
        // Thread: hidden columns 4 tc + e, rows tr + 16 i; x (fp32 here)
        // read 4 deep along k per 16-byte load.
        const int tc = t % 16, tr = t / 16;
        auto products = [&](auto gated_c) {
          for (int k = 0; k < KT1; k += 4) {
            float xv[C::RP1][4];
#pragma unroll
            for (int i = 0; i < C::RP1; ++i)
              load4(reinterpret_cast<const float*>(st + (tr + 16 * i) *
                                                            C::SX) + k,
                    xv[i]);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              float u[4];
              load4(reinterpret_cast<const WT*>(w1s + (k + kk) * C::SW) +
                        4 * tc, u);
#pragma unroll
              for (int i = 0; i < C::RP1; ++i)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  hacc[i][e] = fmaf(xv[i][kk], u[e], hacc[i][e]);
              if constexpr (decltype(gated_c)::value) {
                load4(reinterpret_cast<const WT*>(wgs + (k + kk) * C::SW) +
                          4 * tc, u);
#pragma unroll
                for (int i = 0; i < C::RP1; ++i)
#pragma unroll
                  for (int e = 0; e < 4; ++e)
                    gacc[i][e] = fmaf(xv[i][kk], u[e], gacc[i][e]);
              }
            }
          }
        };
        if (gated)
          products(std::true_type{});
        else
          products(std::false_type{});
        if (j == nk1 - 1) {
#pragma unroll
          for (int i = 0; i < C::RP1; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = tr + 16 * i, col = 4 * tc + e;
              reinterpret_cast<float*>(hs + r * C::HSS)[col] =
                  hidden_value<XT, WT>(hacc[i][e], gacc[i][e],
                                       row0 + r < R && m0 + col < M, b1,
                                       m0 + col, act, gated);
            }
        }
      }
    } else {
      const int hk = (j - nk1) * KT2;  // the step's rows within the chunk
      if constexpr (C::TC) {
        // Warp (wr, wc): rows [16 wr, +16), columns [wc * bo / 2, +bo / 2).
        // The warp's column pairs (1-8) are a template constant, so the
        // loop has no branch between its loads and products.
        const int wr = warp % 4, wc = warp / 4;
        auto products = [&](auto ntp_c) {
          constexpr int NTP = decltype(ntp_c)::value;
#pragma unroll
          for (int ks = 0; ks < KT2 / 16; ++ks) {
            uint32_t a[4], b[4];
            ldmatrix_x4(a, hs + (16 * wr + lm_row(lane)) * C::HSS +
                               (hk + ks * 16 + lm_col(lane)) * 2);
#pragma unroll
            for (int np = 0; np < NTP; ++np) {
              ldmatrix_x4_trans(b, st + (ks * 16 + lm_row(lane)) * C::S2 +
                                       (wc * half + 16 * np + lm_col(lane)) *
                                           2);
              mma_bf16_16816(oacc[2 * np], a, b[0], b[1]);
              mma_bf16_16816(oacc[2 * np + 1], a, b[2], b[3]);
            }
          }
        };
        switch (ntp) {
          case 1: products(std::integral_constant<int, 1>{}); break;
          case 2: products(std::integral_constant<int, 2>{}); break;
          case 3: products(std::integral_constant<int, 3>{}); break;
          case 4: products(std::integral_constant<int, 4>{}); break;
          case 5: products(std::integral_constant<int, 5>{}); break;
          case 6: products(std::integral_constant<int, 6>{}); break;
          case 7: products(std::integral_constant<int, 7>{}); break;
          default: products(std::integral_constant<int, 8>{}); break;
        }
      } else {
        // Thread: output columns 4 tc + 128 jj + e, rows tr + 8 i; h read
        // 4 deep along k per 16-byte load.  Slices of at most 128 columns
        // take one jj; columns past the slice read column 0 and store
        // nothing (no branch in the loop).
        const int tc = t % 32, tr = t / 32;
        auto products = [&](auto njj_c) {
          constexpr int NJJ = decltype(njj_c)::value;
          for (int k = 0; k < KT2; k += 4) {
            float h[C::RP2][4];
#pragma unroll
            for (int i = 0; i < C::RP2; ++i)
              load4(reinterpret_cast<const float*>(hs + (tr + 8 * i) *
                                                            C::HSS) + hk + k,
                    h[i]);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
              for (int jj = 0; jj < NJJ; ++jj) {
                const int col =
                    4 * tc + 128 * jj < bo ? 4 * tc + 128 * jj : 0;
                float w[4];
                load4(reinterpret_cast<const WT*>(st + (k + kk) * C::S2) +
                          col, w);
#pragma unroll
                for (int i = 0; i < C::RP2; ++i)
#pragma unroll
                  for (int e = 0; e < 4; ++e)
                    oacc[2 * i + jj][e] =
                        fmaf(h[i][kk], w[e], oacc[2 * i + jj][e]);
              }
          }
        };
        if (bo > 128)
          products(std::integral_constant<int, 2>{});
        else
          products(std::integral_constant<int, 1>{});
      }
    }
    __syncthreads();  // the stage is free for the step STAGES - 1 ahead
  }
  cp_async_wait<0>();

  float* part = gridDim.z > 1 ? partial : nullptr;
  if constexpr (C::TC) {
    const int wr = warp % 4, wc = warp / 4, g = lane / 4;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      if (n >= 2 * ntp) break;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        emit<XT, WT>(oacc[n][i], row0 + 16 * wr + g + 8 * (i / 2),
                     c0 + wc * half + 8 * n + 2 * (lane % 4) + i % 2, R,
                     Dout, out, part, z, b2);
    }
  } else {
    const int tc = t % 32, tr = t / 32;
#pragma unroll
    for (int i = 0; i < C::RP2; ++i)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = 4 * tc + 128 * jj;
        if (col >= bo) break;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          emit<XT, WT>(oacc[2 * i + jj][e], row0 + tr + 8 * i, c0 + col + e,
                       R, Dout, out, part, z, b2);
      }
  }
}

// Output slices of at most 256 columns (`bo` wide, a multiple of 32) and
// the hidden splits: 1 where row tiles x slices fill the card, else as
// many as keep the grid in one wave, or `requested` (> 0).  tc: bf16 x
// (the tensor-core tile).
int rows_plan(int R, int M, int Dout, bool tc, int requested, int* bo,
              int* slices, int* cps, int* splits) {
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  *slices = (Dout + ROWS_BO - 1) / ROWS_BO;
  *bo = ((Dout + *slices - 1) / *slices + 31) / 32 * 32;
  const int br = rows_tile(tc), wave = sms * rows_blocks_per_sm(tc);
  const int blocks = (R + br - 1) / br * *slices;
  const int chunks = (M + MLP_BH - 1) / MLP_BH;
  const int target = blocks >= wave ? 1 : wave / blocks;
  *splits = split_chunks(chunks, requested, target, chunks, cps);
  return 0;
}

template <typename XT, typename WT>
int launch(const void* x_, const void* w1_, const void* b1_, const void* wg_,
           const void* w2_, const void* b2_, void* out_, float* partial,
           int R, int D, int M, int Dout, int act, int splits,
           cudaStream_t stream) {
  using C = Rows<XT, WT>;
  auto x = (const XT*)x_;
  auto w1 = (const WT*)w1_, b1 = (const WT*)b1_, wg = (const WT*)wg_,
       w2 = (const WT*)w2_, b2 = (const WT*)b2_;
  auto out = (XT*)out_;
  int bo = 0, slices = 0, cps = 1;
  int err = rows_plan(R, M, Dout, C::TC, splits, &bo, &slices, &cps,
                      &splits);
  if (err != 0) return err;
  if (splits > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fused_mlp_rows_kernel<XT, WT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int vecs = (vec_ok<XT>(x, D) ? 1 : 0) |
                   (vec_ok<WT>(w1, M) && (!wg || vec_ok<WT>(wg, M)) ? 2 : 0) |
                   (vec_ok<WT>(w2, Dout) ? 4 : 0);
  dim3 grid((R + C::BR - 1) / C::BR, slices, splits);
  fused_mlp_rows_kernel<XT, WT><<<grid, MLP_THREADS, C::SMEM, stream>>>(
      x, w1, b1, wg, w2, b2, out, partial, R, D, M, Dout, act, bo, cps,
      vecs);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  return launch_finish<XT, WT>(partial, b2, out, R, Dout, splits, stream);
}

}  // namespace repro_torch

// The hidden splits of the many-rows plan (1: no partial; else `partial`
// holds splits x R x Dout floats); `requested` > 0 asks for about that
// many instead.  D does not change it; dtype (x's) picks the tile.
extern "C" int rt_fused_mlp_rows_splits(int R, int D, int M, int Dout,
                                        int dtype, int requested,
                                        int* splits) {
  int bo = 0, slices = 0, cps = 1;
  (void)D;
  return repro_torch::rows_plan(R, M, Dout, dtype == repro_torch::kBF16,
                                requested, &bo, &slices, &cps, splits);
}

// As rt_fused_mlp (fused_mlp.cu), for any number of rows.
extern "C" int rt_fused_mlp_rows(const void* x, const void* w1,
                                 const void* b1, const void* wg,
                                 const void* w2, const void* b2, void* out,
                                 float* partial, int R, int D, int M,
                                 int Dout, int act, int splits, int xt,
                                 int wt, void* stream) {
  using namespace repro_torch;
  cudaStream_t s = (cudaStream_t)stream;
  return dispatch_mode(xt, wt, [&](auto xtag, auto wtag) {
    return launch<typename decltype(xtag)::type,
                  typename decltype(wtag)::type>(
        x, w1, b1, wg, w2, b2, out, partial, R, D, M, Dout, act, splits, s);
  });
}

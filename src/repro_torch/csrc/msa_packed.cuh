// The packed MSA tile: per-head attention, Q/K/V projection included, at
// short sequences, one block per G whole sequences and all H heads.
//
// Replaces: the cluster tile (msa_tile.cuh, `vita_msa_kernel`) wherever
// kernels/vita_msa.py::msa_packed_plan gives a layout: fp32 z with fp32 or
// bf16 weights, N <= 32, Dh <= 32, and a block's buffers within two blocks
// an SM.  Both callers of vita_msa.cu take it there: kernel 1's fused
// layer (SA merged as (B*N, H*Dh)) and kernel 5 (SA as (B, H, N, Dh)).
// The cluster tile gives every (sequence, head) a cluster of 64-row
// blocks; at TNT-S's inner stream (N 16, D 24, 4 heads of Dh 6) that is 16
// valid rows of 64, Dh padded to 32 (96 projected columns for 18), a second
// 32-row attention pass of padding alone and z read once per head, in
// 25,088 blocks of 512 threads a bucket of 32 images at one block an SM.
//
// Bound: bytes.  z in and SA out, B N (D + H Dh) fp32 values (19.3 MB at
// TNT-S's bucket 32: 5.8 us at 3.35 TB/s), against 2 B N D 3 H Dh + 4 B H
// N N Dh operations (0.50 GFLOP: about 1 us at TF32's 495 TFLOP/s).  So
// the tile reads each z row once and writes each SA value once, and keeps
// everything between on chip:
//   * G = floor(64 / N) sequences a block (R = G N <= 64 rows: 4 sequences
//     and no padded row at N 16), ceil(B / G) blocks, the last one ragged;
//     4 warps, 41.4 KB of shared memory and 113 registers a thread at
//     TNT-S's shape, so that four blocks share an SM; no cluster;
//   * the block's z rows are copied in once (cp.async where the rows are
//     16-byte aligned) beside the H heads' three weight slices, side by
//     side, and projected in one product, [R x D] . [D x 3 H DP], DP = Dh
//     padded to the MMA's 8 columns; the product runs on mma.sync m16n8k8
//     in split TF32 (tf32_split.cuh: three passes with fp32 weights, two
//     with bf16 ones, fp32 sums), as the cluster tile's fp32-z projection;
//   * one warp per (sequence, head, 16-query slice) then computes S = Q.K^T
//     * scale [+ bias[h] + mask[b % nW]] over the sequence's keys, keys
//     past N at -inf, the cluster tile's exact softmax (row max, expf, sum,
//     times __frcp_rn(sum)) and P.V, both products in split TF32, with S
//     and P in registers: under tf32_split.cuh's permuted k, the
//     accumulator fragment of S's 8-key tile j is P's A fragment for keys
//     8j..8j+7, so P never goes through shared memory;
//   * SA is staged in shared memory (over z and the weights, which the
//     block is done with) in the order of the launch's output strides,
//     and written as one run of consecutive addresses where those are
//     dense, as both callers' are.
// Measured on an H100 (700 W) at TNT-S's bucket 32: 0.057 ms a call
// against the cluster tile's 1.80 ms and matmul + SDPA's 0.31 ms.
// V rows past a sequence's N keys read as zero: the padding keys of one
// sequence are the next one's rows, and a P of zero times a NaN there
// would still be NaN.
#pragma once

#include "tf32_split.cuh"

namespace repro_torch {

// PK_SMEM_LIMIT: the most each of two resident blocks may use (an SM's
// 233,472 bytes, less the 1,024 the card keeps for each block).
constexpr int PK_WARPS = 4, PK_THREADS = 32 * PK_WARPS, PK_ROWS = 64,
              PK_MAX_N = 32, PK_MAX_DP = 32,
              PK_SMEM_LIMIT = 233472 / 2 - 1024;

// Shared memory of one block, byte offsets: z [RM][ldz] fp32 at 0 (RM = R
// rounded up to 16; rows past the block's sequences zero), W [kp][ldw] in
// the weights' type at w_off (row k, column (p H + h) DP + e is w_p[h][k][e],
// p = 0, 1, 2 for Q, K, V; zero past D, Dh and 3 H DP), Q, K and V of every
// row [qrows][ldq] fp32 at qkv_off (the product's columns as W's), and SA
// [R][H Dh] fp32 at 0 over z and W.  qrows covers the rows the last
// sequence's 16-row query slices read past R.  The paddings put the lanes
// of every fragment load on distinct banks (ldz and ldq 8 or 24 mod 32,
// ldw 4 mod 16 in fp32 and 8 or 24 mod 32 in bf16).
// kernels/vita_msa.py::msa_packed_plan computes the layout (the fields in
// this order) and the launch takes it as is; `packed_layout_ok` checks only
// the limits the tile's code assumes.
struct PackedLayout {
  int seqs, rows, kp, ldz, dp, cols, ldw, ldq, qrows, w_off, qkv_off, smem;
};
static_assert(sizeof(PackedLayout) == 12 * sizeof(int), "plan is 12 ints");

inline bool packed_layout_ok(const PackedLayout& L, int N, int D, int H,
                             int Dh, int w_size) {
  const int rm = (L.rows + 15) / 16 * 16, mq = (N + 15) / 16;
  return N >= 1 && N <= PK_MAX_N && D >= 1 && H >= 1 && Dh >= 1 &&
         L.seqs == PK_ROWS / N && L.rows == L.seqs * N &&
         L.dp % 8 == 0 && Dh <= L.dp && L.dp <= PK_MAX_DP &&
         L.kp % 8 == 0 && L.kp >= D && L.ldz % 8 == 0 && L.ldz >= L.kp &&
         L.cols % 16 == 0 && L.cols >= 3 * H * L.dp && L.ldw >= L.cols &&
         L.ldw % 2 == 0 && L.ldq % 2 == 0 && L.ldq >= L.cols &&
         L.qrows >= rm && L.qrows >= (L.seqs - 1) * N + 16 * mq &&
         L.w_off % 16 == 0 && L.w_off >= rm * L.ldz * 4 &&
         L.qkv_off % 16 == 0 &&
         L.qkv_off >= L.w_off + L.kp * L.ldw * w_size &&
         L.qkv_off >= L.rows * H * Dh * 4 &&
         L.smem >= L.qkv_off + L.qrows * L.ldq * 4 &&
         L.smem <= PK_SMEM_LIMIT;
}

// 4 bytes from src to dst by cp.async, zero-filled where !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// The whole tile for sequences [G blockIdx.x, G blockIdx.x + G) of z (B,
// N, D) fp32, DP = L.dp; out element (sequence b, token n, head h, column
// e) is out[b ob + n on + h oh + e].  vecs: bit 0, z's rows are 16-byte
// aligned; bit 1, the weights can be copied 4 bytes at a time (fp32, or
// bf16 pairs at an even Dh).
template <typename WT, int DP>
__global__ void __launch_bounds__(PK_THREADS, 4)
msa_packed_kernel(const float* __restrict__ z, const WT* __restrict__ wq,
                  const WT* __restrict__ wk, const WT* __restrict__ wv,
                  const WT* __restrict__ qkv_bias,
                  const float* __restrict__ bias,
                  const float* __restrict__ mask, int nW,
                  float* __restrict__ out, long long ob, long long on,
                  long long oh, int B, int N, int D, int H, int Dh,
                  float scale, PackedLayout L, int vecs) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool EXACT_W = sizeof(WT) == 2;       // bf16 weights in TF32
  constexpr int DS = DP / 8, CBG = 3;             // column blocks a task
  const float* Zs = reinterpret_cast<const float*>(smem);
  WT* Ws = reinterpret_cast<WT*>(smem + L.w_off);
  float* Qs = reinterpret_cast<float*>(smem + L.qkv_off);
  float* Os = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int b0 = blockIdx.x * L.seqs, seqs = min(L.seqs, B - b0);
  const int rm = (L.rows + 15) / 16 * 16, hdp = H * DP, hdh = H * Dh;

  // 1. The block's z rows and the three weight slices of every head, part
  // p, head h at columns (p H + h) DP: copied U values at a time.
  load_tile<float, PK_THREADS>(smem, L.ldz * 4, z, D, b0 * N,
                               (b0 + seqs) * N, 0, D, rm, L.kp, vecs & 1);
  constexpr int U = 4 / (int)sizeof(WT), UPR = DP / U;   // units a row
  const long long slice = (long long)D * Dh;
  for (int ph = 0; ph < 3 * H; ++ph) {
    const WT* w = (ph < H ? wq : ph < 2 * H ? wk : wv) + ph % H * slice;
    WT* dst = Ws + ph * DP;
#pragma unroll 2
    for (int i = tid; i < L.kp * UPR; i += PK_THREADS) {
      const int k = i / UPR, e = i % UPR * U;
      const bool ok = k < D && e < Dh;
      if (vecs & 2) {
        cp_async4(dst + k * L.ldw + e, ok ? w + k * Dh + e : w, ok);
      } else {
#pragma unroll
        for (int u = 0; u < U; ++u)
          dst[k * L.ldw + e + u] =
              ok && e + u < Dh ? w[k * Dh + e + u] : from_f<WT>(0.f);
      }
    }
  }
  for (int i = tid; i < L.kp * (L.cols - 3 * hdp); i += PK_THREADS) {
    const int k = i / (L.cols - 3 * hdp), c = 3 * hdp + i % (L.cols - 3 * hdp);
    Ws[k * L.ldw + c] = from_f<WT>(0.f);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // 2. Q, K and V of every row and head: task (16-row tile pm, column
  // blocks cg CBG .. of 16) a warp at a time, qkv_bias added in the
  // epilogue.
  const int mt = rm / 16, ncb = L.cols / 16, ngr = (ncb + CBG - 1) / CBG;
  for (int task = warp; task < mt * ngr; task += PK_WARPS) {
    const int pm = task % mt, cb0 = task / mt * CBG;
    SplitAcc acc[CBG][2];
#pragma unroll
    for (int i = 0; i < CBG; ++i) {
      split_zero(acc[i][0]);
      split_zero(acc[i][1]);
    }
    for (int k0 = 0; k0 < L.kp; k0 += 8) {
      const SplitA a = load_split_a(Zs, L.ldz, 16 * pm + g, k0);
#pragma unroll
      for (int i = 0; i < CBG; ++i) {
        if (cb0 + i >= ncb) break;
        const PairB bb = load_pair_b(Ws, L.ldw, k0, 16 * (cb0 + i));
        mma_split<EXACT_W>(acc[i][0], a, bb, 0);
        mma_split<EXACT_W>(acc[i][1], a, bb, 1);
      }
    }
#pragma unroll
    for (int i = 0; i < CBG; ++i) {
      if (cb0 + i >= ncb) break;
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = pair_col(16 * (cb0 + i), half, e);
          const int r = 16 * pm + g + 8 * (e >> 1);
          float v = split_value(acc[i][half], e);
          if (qkv_bias && col < 3 * hdp && col % DP < Dh)
            v += to_f(qkv_bias[col / DP * Dh + col % DP]);
          Qs[r * L.ldq + col] = v;
        }
    }
  }
  __syncthreads();

  // 3. Attention: task (sequence s, head h, 16-query slice mq) a warp at a
  // time.  Lane (g, t) holds rows g and g + 8 of the slice; element e of
  // key tile j is row g + 8 (e >> 1), key 8 j + 2 t + (e & 1).  SA is
  // staged in the order of the output's strides: (token, head) or (head,
  // token) inside each sequence's N H Dh values.
  const int mqs = (N + 15) / 16, nkt = (N + 7) / 8, per = N * hdh;
  const bool n_outer = on >= oh;
  const int sn = n_outer ? hdh : Dh, sh = n_outer ? Dh : N * Dh;
  const float ninf = __int_as_float(0xff800000);
  for (int task = warp; task < seqs * H * mqs; task += PK_WARPS) {
    const int mq = task % mqs, h = task / mqs % H, s = task / (mqs * H);
    const int kr = s * N, qr = kr + 16 * mq;       // buffer rows
    const float* Qh = Qs + h * DP;
    const float* Kh = Qs + hdp + h * DP;
    const float* Vh = Qs + 2 * hdp + h * DP;
    SplitAcc sc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) split_zero(sc[j]);
#pragma unroll
    for (int k0 = 0; k0 < DP; k0 += 8) {
      const SplitA qa = load_split_a(Qh + qr * L.ldq, L.ldq, g, k0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= nkt) break;
        const float2 kv = *reinterpret_cast<const float2*>(
            Kh + (kr + 8 * j + g) * L.ldq + k0 + 2 * t);
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(kv.x, bh0, bl0);
        split_tf32(kv.y, bh1, bl1);
        mma_split<false>(sc[j], qa, bh0, bh1, bl0, bl1);
      }
    }
    // The exact softmax of rows g and g + 8 over the N keys: a row's keys
    // lie on the four lanes of its quad.
    const long long b = b0 + s;
    const float* bias_h = bias ? bias + (size_t)h * N * N : nullptr;
    const float* mask_w = mask ? mask + (size_t)(b % nW) * N * N : nullptr;
    float pv[4][4], mx[2] = {ninf, ninf}, sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 16 * mq + g + 8 * (e >> 1);
        const int key = 8 * j + 2 * t + (e & 1);
        float v = ninf;
        if (j < nkt && key < N) {
          v = split_value(sc[j], e) * scale;
          if (bias_h && n < N)
            v = (v + bias_h[(size_t)n * N + key]) +
                mask_w[(size_t)n * N + key];
        }
        pv[j][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      mx[q] = fmaxf(mx[q], __shfl_xor_sync(0xffffffffu, mx[q], 1));
      mx[q] = fmaxf(mx[q], __shfl_xor_sync(0xffffffffu, mx[q], 2));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(pv[j][e] - mx[e >> 1]);
        pv[j][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      sum[q] += __shfl_xor_sync(0xffffffffu, sum[q], 1);
      sum[q] += __shfl_xor_sync(0xffffffffu, sum[q], 2);
      sum[q] = __frcp_rn(sum[q]);
    }
    // P.V: key tile j of P is the A fragment of k step j (slot t: key 8 j
    // + 2 t, elements 0 and 2; slot t + 4: key 8 j + 2 t + 1, elements 1
    // and 3); V's column tiles of 8.
    SplitAcc so[DS];
#pragma unroll
    for (int c = 0; c < DS; ++c) split_zero(so[c]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= nkt) break;
      SplitA pa;
      split_tf32(pv[j][0] * sum[0], pa.hi[0], pa.lo[0]);
      split_tf32(pv[j][2] * sum[1], pa.hi[1], pa.lo[1]);
      split_tf32(pv[j][1] * sum[0], pa.hi[2], pa.lo[2]);
      split_tf32(pv[j][3] * sum[1], pa.hi[3], pa.lo[3]);
      const int key = 8 * j + 2 * t;
#pragma unroll
      for (int c = 0; c < DS; ++c) {
        const float* vp = Vh + (kr + key) * L.ldq + 8 * c + g;
        const float v0 = key < N ? vp[0] : 0.f;
        const float v1 = key + 1 < N ? vp[L.ldq] : 0.f;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(v0, bh0, bl0);
        split_tf32(v1, bh1, bl1);
        mma_split<false>(so[c], pa, bh0, bh1, bl0, bl1);
      }
    }
    // SA of the slice's valid rows and columns to the staging buffer,
    // which overlays z and W: every read of them ended before the barrier
    // above.
#pragma unroll
    for (int c = 0; c < DS; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 16 * mq + g + 8 * (e >> 1);
        const int col = 8 * c + 2 * t + (e & 1);
        if (n < N && col < Dh)
          Os[s * per + n * sn + h * sh + col] = split_value(so[c], e);
      }
  }
  __syncthreads();

  // 4. SA out: one run of consecutive addresses where the output's strides
  // are the staging's, else element by element.
  float* dst = out + b0 * ob;
  if (ob == per && on == sn && oh == sh) {
    for (int i = tid; i < seqs * per; i += PK_THREADS) dst[i] = Os[i];
  } else {
    for (int i = tid; i < seqs * per; i += PK_THREADS) {
      const int s = i / per, r = i % per, e = r % Dh;
      const int n = n_outer ? r / hdh : r / Dh % N;
      const int h = n_outer ? r / Dh % H : r / (N * Dh);
      dst[s * ob + n * on + h * oh + e] = Os[i];
    }
  }
}

}  // namespace repro_torch

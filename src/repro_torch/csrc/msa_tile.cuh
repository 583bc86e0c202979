// The MSA tile: one (image, head) of per-head attention, Q/K/V projection
// included, by a cluster of C thread blocks.  Shared by vita_msa.cu's two
// callers: kernel 5 (`vita_msa_batched`, SA as (B, H, N, Dh) in z's type)
// and kernel 1's fused layer (`vita_layer`, SA merged as (B*N, H*Dh) in
// fp32 from its fp32 LN1 output); the output layout is three strides.
// Its three steps are device functions of their own: `msa_project` (a
// block's 64 rows against the head's weights), `msa_gather` (the peers' K
// and V through distributed shared memory) and `msa_attend` (the block's
// rows over all N keys).  `msa_tile` runs the three; the layer-group
// kernel (vita_layer_group.cu) runs the first and the last in stages of
// their own, with K and V passing through device memory in between.
// Where K and V of all N rows do not fit a block (Dh 65-128, more than 8
// slices, or more than a block's shared memory) the plan is paged: only
// `msa_project` runs here (vita_msa.cu's projection kernel, or the layer
// group's stage), at DP 64 or 128, and attention.cuh's tile pages K and V
// out of device memory.
//
// Work split.  Block c of the cluster owns rows [64 c, 64 c + 64) of the N
// tokens (C = ceil(N / 64) <= 8, kernels/vita_msa.py::msa_plan: 4 at DeiT-T's and
// ViT-B's N, 1 at Swin's 49).  It projects Q, K and V for its own rows
// only, keeping them in its shared memory (K and V at their rows of
// full-height K and V buffers), syncs the cluster, copies every peer's K
// and V rows out of the peer's shared memory (distributed shared memory,
// many 16-byte remote loads in flight a thread) into its own buffers,
// syncs the cluster again (no block leaves, or reuses its smem, while a
// peer still reads it), and attends its rows over all N keys.  So each K
// and V row is projected once per (image, head), and the DeiT-T batch-8
// grid (96 blocks of 16 warps) runs in one wave.
//
// Projection: the 64 rows against the head's three weight slices side by
// side, [64 x D] . [D x 3 DP] (DP = Dh padded to 32 or 64 with zero
// columns), 16 warps as 4 (16 rows) x 4 (16-column blocks cb, cb + 4,
// cb + 8).  z rows and weight rows stream through a ring of 16-byte
// cp.async copies, KC = 32 (fp32 z) or 64 (bf16 z) deep, that overlays
// the K, V and score buffers (3-8 stages, as many as they hold).
//   * bf16 z (bf16 weights): mma.sync m16n8k16, bf16 in, fp32 sums, fed
//     by ldmatrix: the products are exact, only the order of the sum
//     differs from the TPU kernel's fp32 dot.
//   * fp32 z: split TF32 on m16n8k8 (tf32_split.cuh), three passes with
//     fp32 weights, two with bf16 weights (exact in TF32).
//   qkv_bias joins in the epilogue; V is stored in z's type (the TPU
//   kernel's v.astype(z.dtype)), Q and K in fp32.
// Attention, 32 query rows a pass: S = Q . K^T * scale [+ bias[h] +
// mask[b % nW]] by split TF32 (Q and K are fp32 in every mode; the TPU
// kernel never rounds them), warps as 2 (16 rows) x 8 (key tiles), keys
// padded to NK = N rounded up to 16 with -inf scores; the exact softmax
// over all N keys, one warp a row (two rows a warp side by side), P
// normalised by its row sum before it is rounded to z's type
// (softmax_av); then P . V: bf16 P and V on m16n8k16 in the bf16 mode,
// split TF32 on fp32 P and V otherwise, each (16-row, 16-column) tile
// split over key groups whose fp32 sums are added in order.
#pragma once

#include <cooperative_groups.h>

#include "tf32_split.cuh"

namespace repro_torch {

constexpr int MSA_WARPS = 16, MSA_THREADS = 32 * MSA_WARPS, MSA_ROWS = 64,
              MSA_SUB = 32, MSA_MIN_STAGES = 3, MSA_MAX_STAGES = 8,
              MSA_MAX_CLUSTER = 8, MSA_SMEM_LIMIT = 232448;

// Shared memory of one block, byte offsets: Q [64][DP + 8] fp32, then K [C
// 64][DP + 8] fp32, V [C 64][DP + 4] fp32 or [DP + 8] bf16, and S [32][lds]
// fp32 with, in the bf16 mode, P [32][NK + 8] bf16 (S doubles as the
// buffer in which P.V's key groups add their sums).  The projection's ring
// (`stages` of z [64][KC + 8] and W [KC][3 DP + 4 (fp32) or + 8 (bf16)])
// overlays K, V and S, which it is done with before they are written: as
// many stages as that room holds, 3 to 8.  The row paddings put the lanes
// of every fragment load on distinct banks.  kernels/vita_msa.py::msa_plan
// computes the layout (the fields in this order) and the launch takes it
// as is; `msa_layout_ok` checks only the limits the tile's code assumes.
//
// Paged plans (`paged` 1): where K and V of all N rows do not fit one
// block beside Q and the scores (Dh past 64, N past 8 slices of 64, or
// more than a block's shared memory), the projection runs alone, one
// block per (image, head, 64-row slice) at DP 64 or 128, its ring at
// offset 0 (ring_off 0, the buffer offsets unused), and writes Q, K and V
// to device memory; the attention then pages K and V through the
// attention tile (attention.cuh) at its own layout.
struct MsaLayout {
  int dp, rows, cluster, nk, lds, stage, stages;
  int q_off, k_off, v_off, s_off, p_off, ring_off, smem, paged;
};
static_assert(sizeof(MsaLayout) == 15 * sizeof(int), "plan is 15 ints");

// The limits a plan for N tokens of head width Dh must keep: Dh padded to
// a DP the tile is built for, blocks of MSA_ROWS rows covering N (in at
// most MSA_MAX_CLUSTER blocks a cluster), and one block's shared memory.
inline bool msa_layout_ok(const MsaLayout& L, int N, int Dh) {
  const bool dp_ok = L.paged ? L.dp == 64 || L.dp == 128
                             : L.dp == 32 || L.dp == 64;
  const bool common = dp_ok && Dh >= 1 && Dh <= L.dp && N >= 1 &&
                      L.rows == MSA_ROWS && L.cluster >= 1 &&
                      (long long)L.cluster * L.rows >= N &&
                      L.stages >= 1 && L.stage > 0 &&
                      L.smem <= MSA_SMEM_LIMIT;
  if (L.paged == 1)
    return common && L.ring_off == 0 && L.stages <= MSA_MAX_STAGES &&
           (long long)L.stages * L.stage <= L.smem;
  return common && L.paged == 0 && L.cluster <= MSA_MAX_CLUSTER &&
         L.nk >= N;
}

namespace cg = cooperative_groups;

// Step 1: project rows [row0, row0 + 64) of image b (zero rows past N)
// against head h's three weight slices; every thread of a MSA_THREADS
// block calls it.  Each value goes to `put(part, r, col, v)`: part 0 Q,
// 1 K, 2 V, r the row within the 64, col < DP (qkv_bias added).  The copy
// ring lies at L.ring_off; every thread is past its last read of it when
// `put` is called.  vecs: bit 0, z rows are 16-byte aligned; bit 1, the
// weight rows are.  Up to DP 64 the three slices go side by side in one
// pass; at DP 128 (paged plans only) one slice a pass, three passes over
// z, so that a warp holds the accumulators of DP 32's side-by-side pass
// (each value's sum over D runs in the same order either way), or the
// passes of slices [p_first, p_last) only.  Between passes `put` has
// run, so it must not write what the ring overlays: in paged plans it
// writes device memory.
template <typename ZT, typename WT, int DP, typename Put>
__device__ __forceinline__ void msa_project(
    unsigned char* smem, const MsaLayout& L, const ZT* z,
    const WT* __restrict__ wq, const WT* __restrict__ wk,
    const WT* __restrict__ wv, const WT* __restrict__ qkv_bias, int N,
    int D, int H, int Dh, int vecs, int h, int b, int row0, Put&& put,
    int p_first = 0, int p_last = 3) {
  constexpr bool TC = sizeof(ZT) == 2;            // bf16 z and weights
  constexpr bool EXACT_W = sizeof(WT) == 2;       // bf16 weights in TF32
  constexpr int KC = TC ? 64 : 32;
  constexpr int NP = DP > 64 ? 1 : 3;             // weight slices a pass
  constexpr int LDZ = KC + 8, LDW = NP * DP + (sizeof(WT) == 4 ? 4 : 8);
  constexpr int NBLK = NP * DP / 16, NB = (NBLK + 3) / 4;
  unsigned char* ring = smem + L.ring_off;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;

  const ZT* zb = z + (long long)b * N * D;
  const long long wo = (long long)h * D * Dh;
  const WT* wsrc[3] = {wq + wo, wk + wo, wv + wo};
  const bool vz = vecs & 1, vw = vecs & 2;
  const int steps = (D + KC - 1) / KC, S = L.stages;
  // Warp (pm, wn): rows 16 pm.. of the 64 and column blocks wn, wn + 4,
  // ... of the pass's NP DP columns.
  const int pm = warp % 4, wn = warp / 4;
  const int n0 = row0;
  for (int p0 = p_first; p0 < p_last; p0 += NP) {
    auto issue = [&](int st) {
      unsigned char* stg = ring + (st % S) * L.stage;
      const int k0 = st * KC;
      if (vz)
        load_tile_fast<ZT, MSA_THREADS, MSA_ROWS, KC>(
            stg, LDZ * (int)sizeof(ZT), zb, D, n0, N, k0, D);
      else
        load_tile<ZT, MSA_THREADS>(stg, LDZ * (int)sizeof(ZT), zb, D, n0, N,
                                   k0, D, MSA_ROWS, KC, false);
      unsigned char* ws = stg + MSA_ROWS * LDZ * sizeof(ZT);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        unsigned char* wp = ws + p * DP * sizeof(WT);
        if (vw)
          load_tile_fast<WT, MSA_THREADS, KC, DP>(
              wp, LDW * (int)sizeof(WT), wsrc[p0 + p], Dh, k0, D, 0, Dh);
        else
          load_tile<WT, MSA_THREADS>(wp, LDW * (int)sizeof(WT), wsrc[p0 + p],
                                     Dh, k0, D, 0, Dh, KC, DP, false);
      }
    };
    float acc[NB][2][4];      // bf16 products
    SplitAcc sacc[NB][2];     // split TF32 products
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        acc[i][e / 4][e % 4] = 0.f;
        if (e < 2) split_zero(sacc[i][e]);
      }
    for (int st = 0; st < S - 1; ++st) {
      if (st < steps) issue(st);
      cp_async_commit();
    }
    for (int st = 0; st < steps; ++st) {
      if (st + S - 1 < steps) issue(st + S - 1);
      cp_async_commit();
      cp_async_wait_n(S - 1);
      __syncthreads();
      const unsigned char* stg = ring + (st % S) * L.stage;
      const ZT* zs = reinterpret_cast<const ZT*>(stg);
      const WT* ws =
          reinterpret_cast<const WT*>(stg + MSA_ROWS * LDZ * sizeof(ZT));
      if constexpr (TC) {
#pragma unroll
        for (int ks = 0; ks < KC / 16; ++ks) {
          uint32_t a[4];
          ldmatrix_x4(a, zs + (16 * pm + lm_row(lane)) * LDZ + 16 * ks +
                             lm_col(lane));
#pragma unroll
          for (int i = 0; i < NB; ++i) {
            const int cb = wn + 4 * i;
            if (cb < NBLK) {
              uint32_t bq[4];
              ldmatrix_x4_trans(bq, ws + (16 * ks + lm_row(lane)) * LDW +
                                        16 * cb + lm_col(lane));
              mma_bf16_16816(acc[i][0], a, bq[0], bq[1]);
              mma_bf16_16816(acc[i][1], a, bq[2], bq[3]);
            }
          }
        }
      } else {
#pragma unroll
        for (int ks = 0; ks < KC / 8; ++ks) {
          const SplitA a = load_split_a(reinterpret_cast<const float*>(zs),
                                        LDZ, 16 * pm + g, 8 * ks);
#pragma unroll
          for (int i = 0; i < NB; ++i) {
            const int cb = wn + 4 * i;
            if (cb < NBLK) {
              const PairB bb = load_pair_b(ws, LDW, 8 * ks, 16 * cb);
              mma_split<EXACT_W>(sacc[i][0], a, bb, 0);
              mma_split<EXACT_W>(sacc[i][1], a, bb, 1);
            }
          }
        }
      }
      __syncthreads();
    }
    cp_async_wait<0>();
    // Epilogue: each value (+ qkv_bias) to `put`.
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int cb = wn + 4 * i;
      if (cb >= NBLK) continue;
      const int part = p0 + 16 * cb / DP, c0 = 16 * cb - (part - p0) * DP;
      const WT* pb = qkv_bias ? qkv_bias + ((size_t)part * H + h) * Dh
                              : nullptr;
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = TC ? c0 + 8 * half + 2 * t + (e & 1)
                             : pair_col(c0, half, e);
          const int r = 16 * pm + g + 8 * (e >> 1);
          float v = TC ? acc[i][half][e] : split_value(sacc[i][half], e);
          if (pb && col < Dh) v += to_f(pb[col]);
          put(part, r, col, v);
        }
    }
  }
}

// Step 2: copy every cluster peer's K and V rows out of its shared memory
// (distributed shared memory) into this block's K and V buffers: the
// block's threads walk all peers' rows at once, GATHER 16-byte remote
// loads in flight a thread before their stores (a remote load takes
// hundreds of cycles).  Syncs the cluster before (the peers' rows are
// written) and after (no block leaves, or reuses its shared memory, while
// a peer still reads it).  VT is V's type.
template <typename VT, int DP>
__device__ __forceinline__ void msa_gather(unsigned char* smem,
                                           const MsaLayout& L) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int R = L.rows, C = L.cluster, NK = L.nk;
  constexpr int LDK = DP + 8, LDV = sizeof(VT) == 2 ? DP + 8 : DP + 4;
  const int tid = threadIdx.x;
  cluster.sync();
  {
    constexpr int CK = DP / 4, CV = DP * (int)sizeof(VT) / 16, GATHER = 8;
    const int per = R * (CK + CV);
    for (int i0 = tid; i0 < C * per; i0 += GATHER * MSA_THREADS) {
      uint4 v[GATHER];
      int o[GATHER];
#pragma unroll
      for (int u = 0; u < GATHER; ++u) {
        const int i = i0 + u * MSA_THREADS, p = i / per, q = i % per;
        const bool k = q < R * CK;
        const int row = k ? q / CK : (q - R * CK) / CV;
        o[u] = -1;
        if (i < C * per && p != rank && p * R + row < NK) {
          o[u] = k ? L.k_off + (p * R + row) * LDK * 4 + (q % CK) * 16
                   : L.v_off + (p * R + row) * LDV * (int)sizeof(VT) +
                         ((q - R * CK) % CV) * 16;
          v[u] = ld_cluster16(cluster_addr(smem + o[u], p));
        }
      }
#pragma unroll
      for (int u = 0; u < GATHER; ++u)
        if (o[u] >= 0) *reinterpret_cast<uint4*>(smem + o[u]) = v[u];
    }
  }
  cluster.sync();
}

// Step 3: attend rows [row0, row0 + 64) of image b, head h (Q in the Q
// buffer, K and V of all NK keys in theirs, rows past N zero), 32 a pass;
// out element (token n, column e) is out[b ob + n on + h oh + e].  Ends
// with a block barrier.  VT is V's and P's type (z's).
template <typename VT, int DP>
__device__ __forceinline__ void msa_attend(
    unsigned char* smem, const MsaLayout& L, const float* __restrict__ bias,
    const float* __restrict__ mask, int nW, VT* out, long long ob,
    long long on, long long oh, int N, int Dh, float scale, int h, int b,
    int row0) {
  constexpr bool TC = sizeof(VT) == 2;            // bf16 P and V
  constexpr int LDK = DP + 8, LDQ = DP + 8, LDV = TC ? DP + 8 : DP + 4;
  const int R = L.rows, NK = L.nk, LDS = L.lds;
  const int LDP = NK + 8;
  float* Ks = reinterpret_cast<float*>(smem + L.k_off);
  VT* Vs = reinterpret_cast<VT*>(smem + L.v_off);
  float* Qs = reinterpret_cast<float*>(smem + L.q_off);
  float* Ss = reinterpret_cast<float*>(smem + L.s_off);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + L.p_off);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4, wm = warp % 2;

  const float* bias_h = bias ? bias + (size_t)h * N * N : nullptr;
  const float* mask_w = mask ? mask + (size_t)(b % nW) * N * N : nullptr;
  const float ninf = __int_as_float(0xff800000);
  for (int sub = 0; sub < R; sub += MSA_SUB) {
    const int n0 = row0 + sub;         // token of this pass's row 0
    // S: warp (wm, ws) takes rows 16 wm.. and the key tiles (8 keys) ws,
    // ws + 8, ..., two at a time.
    const int ws = warp / 2;
    for (int nt0 = ws; nt0 < NK / 8; nt0 += 16) {
      SplitAcc sc[2];
      split_zero(sc[0]);
      split_zero(sc[1]);
      const bool two = nt0 + 8 < NK / 8;
#pragma unroll
      for (int ks = 0; ks < DP / 8; ++ks) {
        const SplitA qa = load_split_a(Qs + sub * LDQ, LDQ, 16 * wm + g,
                                       8 * ks);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (u == 1 && !two) break;
          const float2 kv = *reinterpret_cast<const float2*>(
              Ks + (8 * (nt0 + 8 * u) + g) * LDK + 8 * ks + 2 * t);
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(kv.x, bh0, bl0);
          split_tf32(kv.y, bh1, bl1);
          mma_split<false>(sc[u], qa, bh0, bh1, bl0, bl1);
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (u == 1 && !two) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 16 * wm + g + 8 * (e >> 1);
          const int j = 8 * (nt0 + 8 * u) + 2 * t + (e & 1);
          const int n = n0 + r;
          float v = ninf;
          if (j < N) {
            v = split_value(sc[u], e) * scale;
            if (bias_h && n < N)
              v = (v + bias_h[(size_t)n * N + j]) + mask_w[(size_t)n * N + j];
          }
          Ss[r * LDS + j] = v;
        }
      }
    }
    __syncthreads();
    // Exact softmax, one warp a row, a warp's RPW rows side by side; P
    // normalised by its row sum (times its reciprocal, rounded to nearest:
    // within an ulp of the quotient), then rounded to VT.
    {
      constexpr int RPW = MSA_SUB / MSA_WARPS;
      float mx[RPW], sum[RPW];
#pragma unroll
      for (int q = 0; q < RPW; ++q) {
        mx[q] = ninf;
        sum[q] = 0.f;
      }
      for (int j = lane; j < NK; j += 32)
#pragma unroll
        for (int q = 0; q < RPW; ++q)
          mx[q] = fmaxf(mx[q], Ss[(warp + MSA_WARPS * q) * LDS + j]);
#pragma unroll
      for (int q = 0; q < RPW; ++q) mx[q] = warp_max(mx[q]);
      for (int j = lane; j < NK; j += 32)
#pragma unroll
        for (int q = 0; q < RPW; ++q) {
          float* sp = Ss + (warp + MSA_WARPS * q) * LDS + j;
          const float p = expf(*sp - mx[q]);
          *sp = p;
          sum[q] += p;
        }
#pragma unroll
      for (int q = 0; q < RPW; ++q) sum[q] = __frcp_rn(warp_sum(sum[q]));
      for (int j = lane; j < NK; j += 32)
#pragma unroll
        for (int q = 0; q < RPW; ++q) {
          const int r = warp + MSA_WARPS * q;
          const float p = Ss[r * LDS + j] * sum[q];
          if constexpr (TC)
            Ps[r * LDP + j] = __float2bfloat16_rn(p);
          else
            Ss[r * LDS + j] = p;
        }
    }
    __syncthreads();
    // P . V: task (wm, cb) is rows 16 wm.. and columns 16 cb.. of DP; its
    // KS warps take every KS-th key step and add their sums in order.
    {
      constexpr int TASKS = 2 * (DP / 16), KS = MSA_WARPS / TASKS;
      const int task = warp % TASKS, kq = warp / TASKS;
      const int pm = task % 2, cb = task / 2;
      float o[2][4] = {};       // bf16 products
      SplitAcc so[2];           // split TF32 products
      split_zero(so[0]);
      split_zero(so[1]);
      if constexpr (TC) {
        for (int k0 = 16 * kq; k0 < NK; k0 += 16 * KS) {
          uint32_t a[4], bq[4];
          ldmatrix_x4(a, Ps + (16 * pm + lm_row(lane)) * LDP + k0 +
                             lm_col(lane));
          ldmatrix_x4_trans(bq, Vs + (k0 + lm_row(lane)) * LDV + 16 * cb +
                                    lm_col(lane));
          mma_bf16_16816(o[0], a, bq[0], bq[1]);
          mma_bf16_16816(o[1], a, bq[2], bq[3]);
        }
      } else {
        for (int k0 = 8 * kq; k0 < NK; k0 += 8 * KS) {
          const SplitA a = load_split_a(Ss, LDS, 16 * pm + g, k0);
          const PairB vb = load_pair_b(reinterpret_cast<const float*>(Vs),
                                       LDV, k0, 16 * cb);
          mma_split<false>(so[0], a, vb, 0);
          mma_split<false>(so[1], a, vb, 1);
        }
      }
      __syncthreads();                 // every read of S / P is done
      float* red = Ss;
      const int rt = task * 32 + lane;
      if (kq > 0) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          red[((kq - 1) * 8 + e) * (TASKS * 32) + rt] =
              TC ? o[e / 4][e % 4] : split_value(so[e / 4], e % 4);
      }
      __syncthreads();
      if (kq == 0) {
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = TC ? 16 * cb + 8 * half + 2 * t + (e & 1)
                               : pair_col(16 * cb, half, e);
            const int n = n0 + 16 * pm + g + 8 * (e >> 1);
            float v = TC ? o[half][e] : split_value(so[half], e);
#pragma unroll
            for (int w = 1; w < KS; ++w)
              v += red[((w - 1) * 8 + half * 4 + e) * (TASKS * 32) + rt];
            if (n < N && col < Dh)
              store_f(out, (long long)b * ob + (long long)n * on +
                               (long long)h * oh + col,
                      v, nullptr);
          }
      }
    }
    __syncthreads();
  }
}

// The whole tile for (image b, head h); every thread of a MSA_THREADS
// block of a cluster of L.cluster blocks along x calls it.  out element
// (token n, column e) is out[b ob + n on + h oh + e].
template <typename ZT, typename WT, int DP>
__device__ __forceinline__ void msa_tile(
    unsigned char* smem, const MsaLayout& L, const ZT* __restrict__ z,
    const WT* __restrict__ wq, const WT* __restrict__ wk,
    const WT* __restrict__ wv, const WT* __restrict__ qkv_bias,
    const float* __restrict__ bias, const float* __restrict__ mask, int nW,
    ZT* __restrict__ out, long long ob, long long on, long long oh, int N,
    int D, int H, int Dh, float scale, int vecs, int h, int b) {
  using VT = ZT;                                  // V in z's type
  constexpr int LDK = DP + 8, LDQ = DP + 8;
  constexpr int LDV = sizeof(VT) == 2 ? DP + 8 : DP + 4;
  const int rank = (int)cg::this_cluster().block_rank();
  const int R = L.rows;
  float* Ks = reinterpret_cast<float*>(smem + L.k_off);
  VT* Vs = reinterpret_cast<VT*>(smem + L.v_off);
  float* Qs = reinterpret_cast<float*>(smem + L.q_off);
  // 1. Project this block's 64 rows: Q to Qs, K and V to their rows of Ks
  // and Vs.
  msa_project<ZT, WT, DP>(
      smem, L, z, wq, wk, wv, qkv_bias, N, D, H, Dh, vecs, h, b, rank * R,
      [&](int part, int r, int col, float v) {
        const int kr = rank * R + r;
        if (part == 0)
          Qs[r * LDQ + col] = v;
        else if (part == 1)
          Ks[kr * LDK + col] = v;
        else
          Vs[kr * LDV + col] = from_f<VT>(v);
      });
  // 2. Every peer's K and V rows.
  msa_gather<VT, DP>(smem, L);
  // 3. Attend this block's rows.
  msa_attend<VT, DP>(smem, L, bias, mask, nW, out, ob, on, oh, N, Dh, scale,
                     h, b, rank * R);
}

}  // namespace repro_torch

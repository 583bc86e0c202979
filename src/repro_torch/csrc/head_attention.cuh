// The LM prefill attention tile of flash_attention.cu (decode_attention.cu,
// split over the cache, has its own), in the style of FlashAttention-2 on
// mma.sync: each group of 16 query rows of one query head, held by one
// warp or shared by several (`fa_part_bytes`), walks the keys of its block
// in tiles of BK, keeping S = Q.K^T, the running max and the running row
// sum in registers (no score buffer in shared memory) and accumulating
// O += P.V in fp32 registers.
//
// Numerics, as the TPU kernel (repro/kernels/head_attention.py): fp32
// scores and an online softmax; P rounded to V's dtype before P.V, the row
// sum taken from the unrounded p; a masked key has p = 0 exactly (its score
// is -inf, never a finite sentinel) and a row with no visible key gives 0;
// the output is rounded once to q's dtype.
//   * bf16: S and P.V on mma.sync m16n8k16 (bf16 operands, fp32
//     accumulators).  P's fragments are S's accumulators packed to bf16 in
//     place (the m16n8 accumulator of two key n-tiles is the A fragment of
//     one 16-key step).
//   * fp32: split TF32 on mma.sync m16n8k8 (tf32_split.cuh), three passes
//     a product, each 8-deep step summed in a fresh accumulator and added
//     to the running one by a rounded fp32 add (`mma_split3`).  The k slots
//     are permuted as in tf32_split.cuh (slot t holds k 2t, slot t + 4 holds
//     k 2t + 1), so S's accumulators of one 8-key n-tile are P's A fragment
//     of one 8-key step as they stand, and K is read as (2t, 2t + 1) pairs.
//
// Q is read from shared memory by ldmatrix (bf16) or 8-byte loads (fp32)
// at every key tile rather than held in registers: at Dh 256 the O
// accumulator alone is 128 fp32 registers a thread, and Q's fragments
// would add 64; Q's load is one per 16-deep step beside BK / 16 of K.
//
// Shared memory (kernels/head_attention.py::flash_plan lays it out and the
// launch checks it, `flash_layout_ok`): Q [rows][q_ld], then a two-stage
// ring of (K [BK][k_ld], V [BK][v_ld]), then, where warps share a row
// group, their partial scores (`fa_part_bytes`).  Head dims are padded to
// dp (a multiple of 16) with zeros, so any Dh <= 256 takes the tensor
// cores.
// Row strides keep the fragment loads on distinct banks: bf16 rows are an
// odd number of 16-byte chunks (ldmatrix, and ldmatrix.trans for V); fp32
// Q and K rows are dp + 8 floats (8-byte (2t, 2t + 1) loads of rows g),
// fp32 V rows dp + 4 (the column pairs of rows 2t, 2t + 1).
#pragma once

#include <cmath>

#include "async_copy.cuh"
#include "tf32_split.cuh"

namespace repro_torch {

constexpr int FA_WARP_ROWS = 16, FA_MAX_THREADS = 512;
constexpr int FA_SMEM_LIMIT = 232448;

// A block holds GROUPS row groups of 16 query rows and NW warps a group:
// warp w takes group w / NW and share w % NW of it, that is one NW-th of
// S's depth (the group's partial scores summed through shared memory in
// warp order) and of O's columns; the warps of a group run the same
// softmax on the same sums.  Sharing a group cuts a warp's O accumulators
// from Dh / 2 to Dh / 2 NW a thread and splits a short prompt's products
// over four warps (one warp alone issuing every copy and product of a
// short prompt was slower than the old CUDA-core tile there).
// Bytes of the warps' partial scores: BK / 8 n-tiles x 4 accumulators x
// 32 lanes, fp32, a warp (none where a warp has its group alone).
__host__ __device__ constexpr int fa_part_bytes(int groups, int nw, int bk) {
  return nw > 1 ? groups * nw * bk / 8 * 4 * 32 * 4 : 0;
}

// The plan's ints (kernels/head_attention.py::FlashPlan.launch_ints()):
// the head-dim class the kernel is built for, query rows a block, keys a
// tile, warps a row group, the padded head dim, the shared-memory row
// strides (bytes) of Q, K and V, one ring stage's bytes, the block's
// shared memory, and whether the rows are copied by 16-byte cp.async (1)
// or by plain loads (0).
struct FlashLayout {
  int dmax, rows, bk, nw, dp, q_ld, k_ld, v_ld, stage, smem, vec;
};

// N rows from r0 of a row-major (.., Dh) block into shared memory at dst
// (`ld` bytes a row, dp columns) by THREADS threads: zeros past Dh and at
// rows >= r_end.  With vec (Dh a whole number of 16-byte chunks, src
// 16-byte aligned) each chunk is a cp.async, walked over rows of DMAX
// columns so that a thread's chunks are compile-time offsets; otherwise
// plain loads into the same layout.
template <typename T, int DMAX, int N, int THREADS>
__device__ __forceinline__ void fa_load_rows(unsigned char* dst, int ld,
                                             const T* src, int Dh, int r0,
                                             int r_end, int dp, bool vec) {
  constexpr int V = 16 / (int)sizeof(T), CPR = DMAX / V, TOTAL = N * CPR;
  if (vec) {
#pragma unroll
    for (int u = 0; u < (TOTAL + THREADS - 1) / THREADS; ++u) {
      const int i = threadIdx.x + u * THREADS;
      if (TOTAL % THREADS != 0 && i >= TOTAL) break;
      const int r = i / CPR, c = (i % CPR) * V, row = r0 + r;
      if (c >= dp) continue;
      const bool ok = row < r_end && c < Dh;
      cp_async16(dst + r * ld + c * (int)sizeof(T),
                 ok ? src + (long long)row * Dh + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < N * dp; i += THREADS) {
      const int r = i / dp, c = i % dp, row = r0 + r;
      reinterpret_cast<T*>(dst + r * ld)[c] =
          row < r_end && c < Dh ? src[(long long)row * Dh + c]
                                : from_f<T>(0.f);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The key range a block of query tile `q0` (`rows` valid rows) walks, as
// kernels/head_attention.py::FlashPlan.walk: causal stops after the last
// row's position, a window starts at the first key the first row sees,
// rounded down to a whole tile, and a tile whose rows see no key walks
// nothing; tiles wholly outside are never loaded.
__device__ __forceinline__ void fa_walk(int q_offset, int q0, int rows,
                                        int nk, int causal, int window,
                                        int bk, int& k_begin, int& k_end) {
  const int p0 = q_offset + q0;
  const int first = window > 0 ? max(0, p0 - window + 1) : 0;
  k_end = causal ? min(nk, p0 + rows) : nk;
  k_begin = first / bk * bk;
  if (first >= k_end) k_end = k_begin;
}

// S of this warp's 16 rows against the BK keys of tile kt, over the
// k-steps part, part + NW, ... of the head dim: s[n-tile][e], element e
// at row g + 8 (e / 2), key 8 n-tile + 2t + e % 2.
template <typename T, int DMAX, int BK, int NW>
__device__ __forceinline__ void fa_scores(float (&s)[BK / 8][4],
                                          const unsigned char* qw, int q_ld,
                                          const unsigned char* kt, int k_ld,
                                          int dp, int part) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < DMAX / 16 / NW; ++i) {
      const int ks = part + NW * i;
      if (ks * 16 >= dp) break;
      uint32_t a[4];
      ldmatrix_x4(a, qw + lm_row(lane) * q_ld + (ks * 16 + lm_col(lane)) * 2);
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, kt + (16 * np + (lane % 8) + 8 * (lane / 16)) * k_ld +
                           (ks * 16 + 8 * ((lane / 8) % 2)) * 2);
        mma_bf16_16816(s[2 * np], a, b[0], b[1]);
        mma_bf16_16816(s[2 * np + 1], a, b[2], b[3]);
      }
    }
  } else {
    const float* qf = reinterpret_cast<const float*>(qw);
#pragma unroll 4
    for (int i = 0; i < DMAX / 8 / NW; ++i) {
      const int ks = part + NW * i;
      if (ks * 8 >= dp) break;
      const SplitA a = load_split_a(qf, q_ld / 4, g, ks * 8);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const float2 kv = *reinterpret_cast<const float2*>(
            kt + (8 * n + g) * k_ld + (ks * 8 + 2 * t) * 4);
        uint32_t h0, l0, h1, l1;
        split_tf32(kv.x, h0, l0);
        split_tf32(kv.y, h1, l1);
        mma_split3(s[n], a, h0, h1, l0, l1);
      }
    }
  }
}

// O += P.V for this warp's rows and its share `part` of NW of the
// columns: p holds P (fp32, unrounded) in S's layout; o[local n-tile][e],
// local tile j being tile part * DMAX / 8 / NW + j of `fa_col`.
template <typename T, int DMAX, int BK, int NW>
__device__ __forceinline__ void fa_pv(float (&o)[DMAX / 8 / NW][4],
                                      const float (&p)[BK / 8][4],
                                      const unsigned char* vt, int v_ld,
                                      int dp, int part) {
  constexpr int CB = DMAX / 16 / NW;  // 16-column blocks a warp
  const int lane = threadIdx.x % 32;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                             pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                             pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                             pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int i = 0; i < CB; ++i) {
        const int c = part * CB + i;
        if (c * 16 >= dp) break;
        uint32_t b[4];
        ldmatrix_x4_trans(b, vt + (16 * kk + lm_row(lane)) * v_ld +
                                 (16 * c + lm_col(lane)) * 2);
        mma_bf16_16816(o[2 * i], a, b[0], b[1]);
        mma_bf16_16816(o[2 * i + 1], a, b[2], b[3]);
      }
    }
  } else {
    const float* vf = reinterpret_cast<const float*>(vt);
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      SplitA a;  // slot t: key 2t (element 0 / 2), slot t + 4: key 2t + 1
      split_tf32(p[kk][0], a.hi[0], a.lo[0]);
      split_tf32(p[kk][2], a.hi[1], a.lo[1]);
      split_tf32(p[kk][1], a.hi[2], a.lo[2]);
      split_tf32(p[kk][3], a.hi[3], a.lo[3]);
#pragma unroll
      for (int i = 0; i < CB; ++i) {
        const int c = part * CB + i;
        if (c * 16 >= dp) break;
        const PairB b = load_pair_b(vf, v_ld / 4, 8 * kk, 16 * c);
        mma_split3(o[2 * i], a, b.hi[0][0], b.hi[0][1], b.lo[0][0],
                   b.lo[0][1]);
        mma_split3(o[2 * i + 1], a, b.hi[1][0], b.hi[1][1], b.lo[1][0],
                   b.lo[1][1]);
      }
    }
  }
}

// The head-dim column of accumulator element e of O's n-tile j: 8 columns
// a tile in bf16; in fp32 tiles 2c and 2c + 1 are the even and odd
// columns of 16-column block c (`pair_col`).
template <typename T>
__device__ __forceinline__ int fa_col(int j, int e) {
  const int t = threadIdx.x % 4;
  if constexpr (sizeof(T) == 2) return 8 * j + 2 * t + (e & 1);
  return 16 * (j / 2) + 4 * t + 2 * (e & 1) + (j & 1);
}

// Query tile q0 of head h of sequence b: q at its first row (row stride
// Dh), k and v at key 0 of its KV head, out like q.  Every thread of a
// block of GROUPS x NW warps calls it (p.rows = 16 GROUPS, p.nw = NW;
// `fa_part_bytes`).
template <typename T, int DMAX, int BK, int GROUPS, int NW>
__device__ __forceinline__ void flash_tile(
    const FlashLayout& p, const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int rows, int q0, int Nk,
    int Dh, float scale, int causal, int window, int q_offset,
    unsigned char* smem) {
  // The warp holds OT of O's n-tiles.
  constexpr int NT = BK / 8, OT = DMAX / 8 / NW;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, part = warp % NW;
  int k_begin, k_end;
  fa_walk(q_offset, q0, rows, Nk, causal, window, BK, k_begin, k_end);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  // This warp's rows: wr0 .. wr0 + wrows - 1 of the tile, at positions
  // wp0 .. wp1.
  const int wr0 = warp / NW * FA_WARP_ROWS;
  const int wrows = min(FA_WARP_ROWS, rows - wr0);
  const int wp0 = q_offset + q0 + wr0, wp1 = wp0 + max(wrows, 1) - 1;
  unsigned char* qs = smem;
  unsigned char* ring = smem + p.rows * p.q_ld;
  const int dp = p.dp;
  const bool vec = p.vec;

  constexpr int TH = 32 * GROUPS * NW, QR = FA_WARP_ROWS * GROUPS;
  if (n_tiles > 0) {  // Q travels with the first tile
    fa_load_rows<T, DMAX, QR, TH>(qs, p.q_ld, q, Dh, 0, rows, dp, vec);
    fa_load_rows<T, DMAX, BK, TH>(ring, p.k_ld, k, Dh, k_begin, k_end, dp,
                                  vec);
    fa_load_rows<T, DMAX, BK, TH>(ring + BK * p.k_ld, p.v_ld, v, Dh,
                                  k_begin, k_end, dp, vec);
    cp_async_commit();
  }
  float o[OT][4], m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * BK;
    const unsigned char* kt = ring + (it & 1) * p.stage;
    const unsigned char* vt = kt + BK * p.k_ld;
    // One barrier a tile: this tile has landed for every thread, and every
    // warp is done with the last one, whose stage the next tile's copies
    // then fill while this one's products run.
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_tiles) {
      unsigned char* nx = ring + ((it + 1) & 1) * p.stage;
      fa_load_rows<T, DMAX, BK, TH>(nx, p.k_ld, k, Dh, k0 + BK, k_end, dp,
                                    vec);
      fa_load_rows<T, DMAX, BK, TH>(nx + BK * p.k_ld, p.v_ld, v, Dh,
                                    k0 + BK, k_end, dp, vec);
      cp_async_commit();
    }
    // A warp whose rows see no key of the tile skips it; a tile across the
    // causal diagonal, the window's edge or the walk's end is masked
    // element by element, an interior tile takes no compare.
    const bool live = wrows > 0 && !(causal && k0 > wp1) &&
                      !(window > 0 && k0 + BK - 1 <= wp0 - window);
    const bool edge = k0 + BK > k_end || (causal && k0 + BK - 1 > wp0) ||
                      (window > 0 && k0 <= wp1 - window);
    float s[NT][4];
    if (live)
      fa_scores<T, DMAX, BK, NW>(s, qs + wr0 * p.q_ld, p.q_ld, kt, p.k_ld,
                                 dp, part);
    if constexpr (NW > 1) {
      // The group's partial scores, summed in warp order (the same sum in
      // each of its warps); the next tile's writes wait for the barrier
      // at its top.
      float* sp = reinterpret_cast<float*>(ring + 2 * p.stage);
      if (live) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sp[((warp * NT + n) * 4 + e) * 32 + lane] = s[n][e];
      }
      __syncthreads();
      if (live) {
        const int w0 = warp - part;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = 0.f;
#pragma unroll
            for (int w = 0; w < NW; ++w)
              x += sp[(((w0 + w) * NT + n) * 4 + e) * 32 + lane];
            s[n][e] = x;
          }
      }
    }
    if (live) {
      const int t = lane % 4;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale;
          if (edge) {
            const int kpos = k0 + 8 * n + 2 * t + (e & 1);
            const int qpos = wp0 + g + 8 * (e >> 1);
            bool ok = kpos < k_end;
            if (causal) ok = ok && kpos <= qpos;
            if (window > 0) ok = ok && kpos > qpos - window;
            if (!ok) x = -INFINITY;
          }
          s[n][e] = x;
        }
      // Online softmax of rows g (i = 0) and g + 8 (i = 1): the quad of
      // lanes sharing a row reduce its max; each lane keeps its own part
      // of the row sum (summed across the quad at the end).
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[i], mx);
        // No visible key yet: every p and alpha is exp(-inf) = 0.
        const float m_ref = m_new == -INFINITY ? 0.f : m_new;
        alpha[i] = expf(m_run[i] - m_ref);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 2 * i; e < 2 * i + 2; ++e) {
            s[n][e] = expf(s[n][e] - m_ref);
            sum += s[n][e];
          }
        l_run[i] = l_run[i] * alpha[i] + sum;
        m_run[i] = m_new;
      }
      // Once the rows' maxima settle, alpha is 1 and the rescale (128
      // multiplies a thread at Dh 256 in a wide tile) is skipped; x * 1 is
      // exact.
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int j = 0; j < OT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
      }
    }
    if (live) fa_pv<T, DMAX, BK, NW>(o, s, vt, p.v_ld, dp, part);
  }

  if (wrows <= 0) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = wr0 + g + 8 * i;
    if (r >= rows) continue;
    const float den = l > 0.f ? l : 1.f;  // no visible key: o = 0
    T* orow = out + (long long)r * Dh;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      if ((part * OT + j) * 8 >= dp) break;
#pragma unroll
      for (int e = 2 * i; e < 2 * i + 2; ++e) {
        const int c = fa_col<T>(part * OT + j, e);
        if (c < Dh) orow[c] = from_f<T>(o[j][e] / den);
      }
    }
  }
}

}  // namespace repro_torch

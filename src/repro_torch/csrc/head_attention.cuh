// The LM attention tile of flash_attention.cu (decode_attention.cu, split
// over the cache, has its own): up to 16 query rows of one KV head attend
// over a range of keys, streamed through shared memory in tiles of 64
// keys with an online softmax (float32 scores, running max and sum, float32
// accumulator).  As in the TPU kernels (repro/kernels/head_attention.py),
// the probabilities are rounded to V's type before P.V and the row sum is
// kept unrounded; a row with no valid key gives 0.  Masked keys get p = 0
// exactly (no finite sentinel), and key rows past the valid range are
// zero-filled so that nothing of the cache beyond it is read into a sum.
//
// Shared memory (dynamic, sized from Dh <= 256): Q [16][Dh] float, K
// [64][Dh + pad] and V [64][Dh] in T, scores and probabilities [16][65]
// float: 155 KiB at Dh 256 in fp32, 86 KiB in bf16, set with
// cudaFuncSetAttribute.  The K rows are padded (one float or two bf16) so
// that the 32 lanes of a warp, each on its own key, hit 32 banks.
//
// Threads: 256.  Scores: thread t computes key t % 64 for rows t / 64 + 4i
// (i < 4).  Softmax and P.V: warp w owns rows 2w and 2w + 1, keeps their
// running max and sum in registers, and accumulates columns lane + 32j
// (j < 8) of both rows.
#pragma once

#include <cmath>

#include "common.cuh"

namespace repro_torch {

constexpr int AT_THREADS = 256, AT_BQ = 16, AT_BK = 64, AT_DMAX = 256;
constexpr int AT_SST = AT_BK + 1;

template <typename T>
__host__ __device__ constexpr int at_kpad() {
  return sizeof(T) == 4 ? 1 : 2;
}

__host__ __device__ inline int at_align16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

template <typename T>
__host__ __device__ inline int at_smem_bytes(int Dh) {
  return at_align16(4 * AT_BQ * Dh) +
         at_align16((int)sizeof(T) * AT_BK * (Dh + at_kpad<T>())) +
         at_align16((int)sizeof(T) * AT_BK * Dh) + 2 * 4 * AT_BQ * AT_SST;
}

// q: the first of `rows` query rows (row stride Dh); k, v: key 0 of this
// KV head (row stride Dh); out: like q.  Keys [k_begin, k_end) are walked;
// key j is valid for row r where j < nk and, with causal, j <= qpos0 + r
// and, with window > 0, j > qpos0 + r - window.
template <typename T>
__device__ void attend_rows(const T* __restrict__ q, int rows,
                            const T* __restrict__ k, const T* __restrict__ v,
                            T* __restrict__ out, int Dh, int nk, int k_begin,
                            int k_end, float scale, int causal, int window,
                            int qpos0, unsigned char* smem) {
  const int KST = Dh + at_kpad<T>();
  float* Qs = reinterpret_cast<float*>(smem);
  T* Ks = reinterpret_cast<T*>(smem + at_align16(4 * AT_BQ * Dh));
  T* Vs = reinterpret_cast<T*>(
      smem + at_align16(4 * AT_BQ * Dh) +
      at_align16((int)sizeof(T) * AT_BK * KST));
  float* Ss = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(Vs) +
      at_align16((int)sizeof(T) * AT_BK * Dh));
  float* Ps = Ss + AT_BQ * AT_SST;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;

  for (int i = t; i < AT_BQ * Dh; i += AT_THREADS) {
    const int r = i / Dh;
    Qs[i] = r < rows ? to_f(q[i]) : 0.f;
  }
  float m_run[2], l_run[2], acc[2][8];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  const int kc = t % AT_BK, rq = t / AT_BK;

  for (int k0 = k_begin; k0 < k_end; k0 += AT_BK) {
    __syncthreads();  // the previous tile is done with Ks, Vs, Ss, Ps
    for (int i = t; i < AT_BK * Dh; i += AT_THREADS) {
      const int c = i / Dh, d = i % Dh;
      const bool in = k0 + c < nk;
      const long long o = (long long)(k0 + c) * Dh + d;
      Ks[c * KST + d] = in ? k[o] : from_f<T>(0.f);
      Vs[i] = in ? v[o] : from_f<T>(0.f);
    }
    __syncthreads();
    // Scores of key kc against rows rq + 4i.
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    const T* krow = Ks + kc * KST;
#pragma unroll 4
    for (int d = 0; d < Dh; ++d) {
      const float kv = to_f(krow[d]);
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] = fmaf(Qs[(rq + 4 * i) * Dh + d], kv, s[i]);
    }
    const int kpos = k0 + kc;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rq + 4 * i, qpos = qpos0 + r;
      bool ok = kpos < nk && kpos < k_end;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      Ss[r * AT_SST + kc] = ok ? s[i] * scale : -INFINITY;
    }
    __syncthreads();
    // Online softmax and P.V for this warp's two rows.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 2 * warp + i;
      const float s0 = Ss[r * AT_SST + lane], s1 = Ss[r * AT_SST + lane + 32];
      const float m_new = fmaxf(m_run[i], warp_max(fmaxf(s0, s1)));
      float p0 = 0.f, p1 = 0.f, alpha = 1.f;
      if (m_new != -INFINITY) {
        p0 = expf(s0 - m_new);  // exp(-inf) = 0 for masked keys
        p1 = expf(s1 - m_new);
        alpha = expf(m_run[i] - m_new);
      }
      l_run[i] = l_run[i] * alpha + warp_sum(p0 + p1);
      m_run[i] = m_new;
      Ps[r * AT_SST + lane] = round_to<T>(p0);
      Ps[r * AT_SST + lane + 32] = round_to<T>(p1);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
    }
    __syncwarp();
    const int kn = min(AT_BK, k_end - k0);
    for (int c = 0; c < kn; ++c) {
      const float p0 = Ps[(2 * warp) * AT_SST + c];
      const float p1 = Ps[(2 * warp + 1) * AT_SST + c];
      const T* vrow = Vs + c * Dh;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = lane + 32 * j;
        if (d < Dh) {
          const float vv = to_f(vrow[d]);
          acc[0][j] = fmaf(p0, vv, acc[0][j]);
          acc[1][j] = fmaf(p1, vv, acc[1][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 2 * warp + i;
    if (r >= rows) continue;
    const float l = l_run[i] > 0.f ? l_run[i] : 1.f;  // no valid key: acc = 0
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = lane + 32 * j;
      if (d < Dh) out[(long long)r * Dh + d] = from_f<T>(acc[i][j] / l);
    }
  }
}

}  // namespace repro_torch

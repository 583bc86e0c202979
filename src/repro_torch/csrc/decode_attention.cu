// LM decode attention: one query per sequence, q (B, Hq, Dh), over a KV
// cache (B, Hkv, S, Dh) of which the first lengths[b] slots are valid;
// float32 or bfloat16 in and out.  A sequence of length 0 gives 0.
//
// Replaces: repro/kernels/head_attention.py::decode_attention, a (batch,
// KV head, k-block) grid that takes the Hq/Hkv query group of one KV head
// as one (group, Dh) tile, walks the k-blocks in order with an online
// softmax (fp32 scores, running max and sum; p rounded to V's dtype before
// P.V, the row sum kept from the unrounded p), masks keys past lengths[b],
// and asserts that its block size divides S.
//
// Bound: bytes.  The cache has to be read once, 2 * sum(lengths) * Hkv *
// Dh elements; the (group x keys) products are a few flops a byte.  At
// RecurrentGemma-2B's batch 4 (one KV head of 256, 2048 slots) that is
// about 1 us of the H100's 3.35 TB/s; a block per (KV head, sequence)
// alone would give the card 4 blocks.
//
// Design (flash-decoding):
//   * A grid of (Hkv, B, splits): split z takes keys [z * per, (z + 1) *
//     per), per a multiple of the 32-key tile, so that the served shapes
//     give about a block per SM (`plan_splits`: from S and the SM count,
//     never more splits than tiles; two tiles a split at RecurrentGemma's
//     batch 4 over 2048 slots, where one tile a split measured slower for
//     its larger combine).  Each block reads lengths[b] on the device: a
//     split wholly past it loads nothing and writes an empty partial
//     (m = -inf, l = 0), so the host never syncs.
//   * The query rows (in q's type) and K and V tiles stream into shared
//     memory with 16-byte cp.async copies, a two-stage ring for K and V,
//     K and V of a tile as separate groups: the scores of tile i run
//     while V of tile i and all of tile i + 1 are in flight.  Slots past
//     the split's last valid key are zero-filled and never read.  Rows of
//     K are padded to an odd number of 16-byte chunks so that the 8 lanes
//     of a 16-byte shared load, each on its own key, hit distinct banks.
//     A Dh whose rows are not a multiple of 16 bytes (or an unaligned
//     tensor) is staged by plain loads into the same layout.
//   * bf16 with Dh a multiple of 16 (RecurrentGemma-2B's 256,
//     stablelm-3b's 80): `decode_split_mma_kernel`, the scores and P.V on
//     mma.sync m16n8k16 (the group's rows padded to 16; see its note).
//   * Otherwise (fp32, other Dh): 256 threads, warp w owns query rows w
//     and w + 8; lane j scores key j of the tile against both (a row past
//     the group is zeros) in four partial fp32 sums a row, so the online
//     softmax is warp shuffles; p goes through shared memory and each lane
//     accumulates its 16-byte column chunk(s) of V in fp32 registers.
//     The hot loops have no branch: with one, the loads could not run
//     ahead of the FMAs and a tile ran several times slower.
//   * splits > 1: each split writes its fp32 running max, row sum and
//     unnormalised (group x Dh) accumulator to `ws`, and a second kernel
//     combines them in split order (deterministic): M = max m_z, out =
//     sum_z acc_z e^(m_z - M) / sum_z l_z e^(m_z - M), rounded once to
//     q's type; a row with no valid key gives exactly 0.  splits == 1
//     writes acc / l directly, as the TPU kernel's last k-block does.
// Tolerance: each split takes its p against its own running max, so the
// bf16 rounding of p falls at other values than in one pass (still one
// bf16 ulp of p, relative), and the fp32 sums reassociate across splits
// and across the tensor cores' k-steps: within a bf16 ulp of each output
// row in bf16 and ~1e-6 of it in fp32, inside the checks' 2e-2 / 1e-4
// per-row bounds.
#include <algorithm>
#include <cmath>
#include <type_traits>

#include "async_copy.cuh"
#include "common.cuh"

namespace repro_torch {

constexpr int DA_WARPS = 8, DA_THREADS = 32 * DA_WARPS, DA_BK = 32;
constexpr int DA_RPW = 2, DA_STAGES = 2;  // query rows a warp (16 / 8)

template <typename T>
struct DecodeTile {
  static constexpr int VEC = 16 / (int)sizeof(T);  // elements per chunk
  static constexpr int NJ = 8 / VEC;  // a lane's column chunks (Dh <= 256)
  // Dh rounded up to whole 16-byte chunks.
  static __host__ __device__ int chunks(int Dh) { return (Dh + VEC - 1) / VEC; }
  // A tile row's stride in 16-byte chunks: odd, so that 8 lanes reading
  // 16 bytes each from 8 rows fall on distinct banks.
  static __host__ __device__ int stride16(int Dh) {
    const int n = chunks(Dh);
    return (n & 1) ? n : n + 1;
  }
  static __host__ __device__ int q_bytes(int Dh) {  // 16 rows
    return 16 * chunks(Dh) * 16;
  }
  static __host__ __device__ int tile_bytes(int Dh) {
    return DA_BK * stride16(Dh) * 16;
  }
  static constexpr int P_BYTES = 16 * DA_BK * 4;  // p of each query row
  static __host__ __device__ int smem_bytes(int Dh) {
    return q_bytes(Dh) + P_BYTES + DA_STAGES * 2 * tile_bytes(Dh);
  }
};

__device__ __forceinline__ void load_chunk(const unsigned char* p,
                                           float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}

__device__ __forceinline__ void load_chunk(const unsigned char* p,
                                           float (&f)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Rows [k0, k0 + rows) of a (.., Dh) row block into shared memory, `st`
// 16-byte chunks a row; rows at or past k_end are zeros.
template <typename T>
__device__ __forceinline__ void load_rows(unsigned char* dst,
                                          const T* __restrict__ src, int k0,
                                          int k_end, int rows, int st, int Dh,
                                          bool vec) {
  using G = DecodeTile<T>;
  const int n = G::chunks(Dh);
  if (vec) {
    for (int i = threadIdx.x; i < rows * n; i += DA_THREADS) {
      const int r = i / n, c = i % n, key = k0 + r;
      const bool ok = key < k_end;
      cp_async16(dst + (r * st + c) * 16,
                 src + (long long)(ok ? key : 0) * Dh + c * G::VEC, ok);
    }
  } else {
    const int dp = n * G::VEC;
    for (int i = threadIdx.x; i < rows * dp; i += DA_THREADS) {
      const int r = i / dp, d = i % dp, key = k0 + r;
      reinterpret_cast<T*>(dst + r * st * 16)[d] =
          key < k_end && d < Dh ? src[(long long)key * Dh + d]
                                : from_f<T>(0.f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(DA_THREADS)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int* __restrict__ lengths,
                    T* __restrict__ out, float* __restrict__ ws, int Hq,
                    int Hkv, int S, int Dh, float scale, int tiles_per_split,
                    int vec) {
  using G = DecodeTile<T>;
  constexpr int VEC = G::VEC, NJ = G::NJ;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kvh = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int splits = gridDim.z, group = Hq / Hkv;
  const int n = G::chunks(Dh), st = G::stride16(Dh);
  const int tb = G::tile_bytes(Dh);
  unsigned char* qs = smem;  // [16][n chunks] in T, zero past the group
  float* ps = reinterpret_cast<float*>(smem + G::q_bytes(Dh));
  unsigned char* ring = smem + G::q_bytes(Dh) + G::P_BYTES;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int nr =  // the warp's rows: warp + 8 i, i < nr
      group > warp ? (group - warp + DA_WARPS - 1) / DA_WARPS : 0;

  const int nk = min(max(lengths[b], 0), S);
  const int k_begin = z * tiles_per_split * DA_BK;
  const int k_end = min(nk, k_begin + tiles_per_split * DA_BK);
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + DA_BK - 1) / DA_BK : 0;
  const long long qo = ((long long)b * Hq + kvh * group) * Dh;
  const long long ko = (long long)(b * Hkv + kvh) * S * Dh;
  const T* kb = kc + ko;
  const T* vb = vc + ko;

  if (n_tiles > 0) {  // the query rows travel with K of the first tile
    load_rows<T>(qs, q + qo, 0, group, 16, n, Dh, vec);
    load_rows<T>(ring, kb, k_begin, k_end, DA_BK, st, Dh, vec);
    cp_async_commit();
    load_rows<T>(ring + tb, vb, k_begin, k_end, DA_BK, st, Dh, vec);
    cp_async_commit();
  }

  float m_run[DA_RPW], l_run[DA_RPW], acc[DA_RPW][8];
#pragma unroll
  for (int i = 0; i < DA_RPW; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * DA_BK;
    unsigned char* kt = ring + 2 * (it % DA_STAGES) * tb;
    unsigned char* vt = kt + tb;
    if (it + 1 < n_tiles) {
      unsigned char* nxt = ring + 2 * ((it + 1) % DA_STAGES) * tb;
      load_rows<T>(nxt, kb, k0 + DA_BK, k_end, DA_BK, st, Dh, vec);
      cp_async_commit();
      load_rows<T>(nxt + tb, vb, k0 + DA_BK, k_end, DA_BK, st, Dh, vec);
    } else {
      cp_async_commit();
    }
    cp_async_commit();
    cp_async_wait<3>();  // K of this tile has landed
    __syncthreads();

    // Scores of key k0 + lane against the warp's rows (both: a row past
    // the group is zeros), in four partial sums a row.  No branch in the
    // loop, so the shared loads of the next chunks run ahead.
    float s[DA_RPW][4] = {};
    const unsigned char* krow = kt + lane * st * 16;
#pragma unroll 2
    for (int c = 0; c < n; ++c) {
      float kv[VEC];
      load_chunk(krow + c * 16, kv);
#pragma unroll
      for (int i = 0; i < DA_RPW; ++i) {
        float qv[VEC];
        load_chunk(qs + ((warp + DA_WARPS * i) * n + c) * 16, qv);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          s[i][e % 4] = fmaf(qv[e], kv[e], s[i][e % 4]);
      }
    }
    const bool ok = k0 + lane < k_end;
#pragma unroll
    for (int i = 0; i < DA_RPW; ++i) {
      if (i >= nr) break;  // nr is the same for the whole warp
      const float dot = (s[i][0] + s[i][1]) + (s[i][2] + s[i][3]);
      const float sc = ok ? dot * scale : -INFINITY;
      const float m_new = fmaxf(m_run[i], warp_max(sc));
      float pi = 0.f, alpha = 1.f;
      if (m_new != -INFINITY) {
        pi = expf(sc - m_new);  // exp(-inf) = 0 for masked keys
        alpha = expf(m_run[i] - m_new);
      }
      l_run[i] = l_run[i] * alpha + warp_sum(pi);
      m_run[i] = m_new;
      ps[(warp + DA_WARPS * i) * DA_BK + lane] = round_to<T>(pi);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] *= alpha;
    }

    cp_async_wait<2>();  // V of this tile has landed
    __syncthreads();
    // P.V for both rows (a row past the group adds junk never stored);
    // lanes past the last column chunk read chunk 0 and store nothing.
    const int kn = min(DA_BK, k_end - k0);
#pragma unroll 4
    for (int c = 0; c < kn; ++c) {
      float pc[DA_RPW];
#pragma unroll
      for (int i = 0; i < DA_RPW; ++i)
        pc[i] = ps[(warp + DA_WARPS * i) * DA_BK + c];  // this warp's rows
      const unsigned char* vrow = vt + c * st * 16;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int ch = lane + 32 * j < n ? lane + 32 * j : 0;
        float vv[VEC];
        load_chunk(vrow + ch * 16, vv);
#pragma unroll
        for (int i = 0; i < DA_RPW; ++i) {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[i][j * VEC + e] = fmaf(pc[i], vv[e], acc[i][j * VEC + e]);
        }
      }
    }
    __syncthreads();  // the stage is free for the tile after next
  }
  cp_async_wait<0>();

  const long long rows_total = (long long)gridDim.y * Hkv * splits * group;
#pragma unroll
  for (int i = 0; i < DA_RPW; ++i) {
    if (i >= nr) break;
    const int r = warp + DA_WARPS * i;
    const long long pr =
        ((long long)(b * Hkv + kvh) * splits + z) * group + r;
    if (splits > 1 && lane == 0) {
      ws[2 * pr] = m_run[i];
      ws[2 * pr + 1] = l_run[i];
    }
    const float l = l_run[i] > 0.f ? l_run[i] : 1.f;  // no key: acc = 0
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int d = (lane + 32 * j) * VEC + e;
        if (d >= Dh) continue;
        if (splits > 1)
          ws[2 * rows_total + pr * Dh + d] = acc[i][j * VEC + e];
        else
          out[qo + (long long)r * Dh + d] =
              from_f<T>(acc[i][j * VEC + e] / l);
      }
  }
}

// The bf16 kernel for Dh a multiple of 16: the same split, ring and
// rounding points, the products on the tensor cores.  Scores: warp w
// takes the k-steps (16 of Dh) w, w + 8, .. of Q (16 rows, zero past the
// group) . K^T (32 keys) with mma.sync m16n8k16 and leaves its partial in
// shared memory; warp w then sums the 8 partials in order for rows 2w and
// 2w + 1 (lane = key), runs their online softmax and stores p, rounded to
// bf16, as the A operand of P.V; P.V gives warp w the 16-column pairs w
// and w + 8 of the (16 x Dh) accumulator, rescaled by each row's alpha.
constexpr int DA_PST = 40;  // P row stride in bf16 (80 bytes: ldmatrix)
constexpr int DA_SST = 33;  // partial score row stride in floats

__host__ __device__ inline int mma_smem_bytes(int Dh) {
  using G = DecodeTile<__nv_bfloat16>;
  return 16 * G::stride16(Dh) * 16 + DA_WARPS * 16 * DA_SST * 4 +
         16 * DA_PST * 2 + 3 * 16 * 4 + DA_STAGES * 2 * G::tile_bytes(Dh);
}

__global__ void __launch_bounds__(DA_THREADS)
decode_split_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ kc,
                        const __nv_bfloat16* __restrict__ vc,
                        const int* __restrict__ lengths,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ ws, int Hq, int Hkv, int S,
                        int Dh, float scale, int tiles_per_split, int vec) {
  using T = __nv_bfloat16;
  using G = DecodeTile<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kvh = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int splits = gridDim.z, group = Hq / Hkv;
  const int st = G::stride16(Dh), tb = G::tile_bytes(Dh);
  const int ksteps = Dh / 16, npairs = Dh / 16;
  unsigned char* qs = smem;                                  // [16][st]
  float* sp = reinterpret_cast<float*>(qs + 16 * st * 16);   // [8][16][33]
  T* pb = reinterpret_cast<T*>(sp + DA_WARPS * 16 * DA_SST);  // [16][40]
  float* alpha_s = reinterpret_cast<float*>(pb + 16 * DA_PST);  // [16]
  float* m_s = alpha_s + 16;                                  // [16]
  float* l_s = m_s + 16;                                      // [16]
  unsigned char* ring = reinterpret_cast<unsigned char*>(l_s + 16);
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int g = lane / 4, tq = lane % 4;

  const int nk = min(max(lengths[b], 0), S);
  const int k_begin = z * tiles_per_split * DA_BK;
  const int k_end = min(nk, k_begin + tiles_per_split * DA_BK);
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + DA_BK - 1) / DA_BK : 0;
  const long long qo = ((long long)b * Hq + kvh * group) * Dh;
  const long long ko = (long long)(b * Hkv + kvh) * S * Dh;
  const T* kb = kc + ko;
  const T* vb = vc + ko;

  if (n_tiles > 0) {  // the query rows travel with K of the first tile
    load_rows<T>(qs, q + qo, 0, group, 16, st, Dh, vec);
    load_rows<T>(ring, kb, k_begin, k_end, DA_BK, st, Dh, vec);
    cp_async_commit();
    load_rows<T>(ring + tb, vb, k_begin, k_end, DA_BK, st, Dh, vec);
    cp_async_commit();
  }
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float acc[2][2][4] = {};  // [pair j][n-tile][fragment]

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * DA_BK;
    unsigned char* kt = ring + 2 * (it % DA_STAGES) * tb;
    unsigned char* vt = kt + tb;
    if (it + 1 < n_tiles) {
      unsigned char* nxt = ring + 2 * ((it + 1) % DA_STAGES) * tb;
      load_rows<T>(nxt, kb, k0 + DA_BK, k_end, DA_BK, st, Dh, vec);
      cp_async_commit();
      load_rows<T>(nxt + tb, vb, k0 + DA_BK, k_end, DA_BK, st, Dh, vec);
    } else {
      cp_async_commit();
    }
    cp_async_commit();
    cp_async_wait<3>();  // Q and K of this tile have landed
    __syncthreads();

    float sacc[4][4] = {};
    for (int ks = warp; ks < ksteps; ks += DA_WARPS) {
      uint32_t a[4], bq[4];
      ldmatrix_x4(a, qs + lm_row(lane) * st * 16 + (ks * 16 + lm_col(lane)) * 2);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        ldmatrix_x4(bq, kt + (16 * np + (lane % 8) + 8 * (lane / 16)) * st *
                                 16 + (ks * 16 + 8 * ((lane / 8) % 2)) * 2);
        mma_bf16_16816(sacc[2 * np], a, bq[0], bq[1]);
        mma_bf16_16816(sacc[2 * np + 1], a, bq[2], bq[3]);
      }
    }
    float* spw = sp + warp * 16 * DA_SST;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        spw[(g + 8 * (i / 2)) * DA_SST + 8 * nt + 2 * tq + i % 2] =
            sacc[nt][i];
    __syncthreads();

    // Rows 2 warp and 2 warp + 1: the partials summed in order, then the
    // online softmax with key `lane`.
    const bool ok = k0 + lane < k_end;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 2 * warp + i;
      float dot = 0.f;
#pragma unroll
      for (int w = 0; w < DA_WARPS; ++w) dot += sp[(w * 16 + r) * DA_SST + lane];
      float pi = 0.f, alpha = 1.f;
      if (r < group) {
        const float sc = ok ? dot * scale : -INFINITY;
        const float m_new = fmaxf(m_run[i], warp_max(sc));
        if (m_new != -INFINITY) {
          pi = expf(sc - m_new);  // exp(-inf) = 0 for masked keys
          alpha = expf(m_run[i] - m_new);
        }
        l_run[i] = l_run[i] * alpha + warp_sum(pi);
        m_run[i] = m_new;
      }
      pb[r * DA_PST + lane] = __float2bfloat16_rn(pi);
      if (lane == 0) alpha_s[r] = alpha;
    }

    cp_async_wait<2>();  // V of this tile has landed
    __syncthreads();
    const float a0 = alpha_s[g], a1 = alpha_s[g + 8];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        acc[j][nt][0] *= a0;
        acc[j][nt][1] *= a0;
        acc[j][nt][2] *= a1;
        acc[j][nt][3] *= a1;
      }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t a[4], bv[4];
      ldmatrix_x4(a, pb + lm_row(lane) * DA_PST + ks * 16 + lm_col(lane));
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int pr = warp + DA_WARPS * j;
        if (pr >= npairs) break;
        ldmatrix_x4_trans(bv, vt + (ks * 16 + lm_row(lane)) * st * 16 +
                                  (16 * pr + lm_col(lane)) * 2);
        mma_bf16_16816(acc[j][0], a, bv[0], bv[1]);
        mma_bf16_16816(acc[j][1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // the stage, the partials and P are free again
  }
  cp_async_wait<0>();

  const long long rows_total = (long long)gridDim.y * Hkv * splits * group;
  const long long pr0 = ((long long)(b * Hkv + kvh) * splits + z) * group;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 2 * warp + i;
    if (lane == 0) {
      m_s[r] = m_run[i];
      l_s[r] = l_run[i];
      if (splits > 1 && r < group) {
        ws[2 * (pr0 + r)] = m_run[i];
        ws[2 * (pr0 + r) + 1] = l_run[i];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int pr = warp + DA_WARPS * j;
    if (pr >= npairs) break;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = g + 8 * (i / 2), d = 16 * pr + 8 * nt + 2 * tq + i % 2;
        if (r >= group) continue;
        if (splits > 1) {
          ws[2 * rows_total + (pr0 + r) * Dh + d] = acc[j][nt][i];
        } else {
          const float l = l_s[r] > 0.f ? l_s[r] : 1.f;  // no key: acc = 0
          out[qo + (long long)r * Dh + d] = from_f<T>(acc[j][nt][i] / l);
        }
      }
  }
}

// out[b, h] from the splits' partials, in split order: warp 0 finds the
// max, each split's weight e^(m_z - M) and l_z e^(m_z - M) (shared
// memory), thread 0 sums the latter in order, and each thread sums its
// columns' accumulators in order, 32 splits' loads in flight at a time.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ ws,
                                      T* __restrict__ out, int B, int Hq,
                                      int Hkv, int Dh, int splits) {
  extern __shared__ float wz[];  // [splits] weights, L, [splits] l w
  const int qh = blockIdx.x, b = blockIdx.y, group = Hq / Hkv;
  const long long rows_total = (long long)B * Hkv * splits * group;
  const long long base =
      (long long)(b * Hkv + qh / group) * splits * group + qh % group;
  if (threadIdx.x < 32) {
    float M = -INFINITY;
    for (int z = threadIdx.x; z < splits; z += 32)
      M = fmaxf(M, ws[2 * (base + z * group)]);
    M = warp_max(M);
    for (int z = threadIdx.x; z < splits; z += 32) {  // an empty split: 0
      const long long pr = base + z * group;
      wz[z] = M == -INFINITY ? 0.f : expf(ws[2 * pr] - M);
      wz[splits + 1 + z] = ws[2 * pr + 1] * wz[z];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float L = 0.f;
    for (int z = 0; z < splits; ++z) L += wz[splits + 1 + z];
    wz[splits] = L;
  }
  __syncthreads();
  const float L = wz[splits];
  const float* acc = ws + 2 * rows_total;
  for (int d = threadIdx.x; d < Dh; d += blockDim.x) {
    float A = 0.f;
    for (int z0 = 0; z0 < splits; z0 += 32) {
      float a[32];
#pragma unroll
      for (int u = 0; u < 32; ++u)
        a[u] = z0 + u < splits ? acc[(base + (z0 + u) * group) * Dh + d] : 0.f;
#pragma unroll
      for (int u = 0; u < 32; ++u)
        if (z0 + u < splits) A += a[u] * wz[z0 + u];
    }
    out[((long long)b * Hq + qh) * Dh + d] = from_f<T>(L > 0.f ? A / L : 0.f);
  }
}

// Splits that give B * Hkv * splits about one block per SM, at most one
// per 32-key tile of S, made even (every split the same number of tiles).
int plan_splits(int B, int Hkv, int S, int requested, int* splits) {
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  const int tiles = std::max(1, (S + DA_BK - 1) / DA_BK);
  const int pairs = std::max(1, B * Hkv);
  int s = requested > 0 ? requested : (sms + pairs - 1) / pairs;
  s = std::max(1, std::min(s, tiles));
  const int per = (tiles + s - 1) / s;
  *splits = (tiles + per - 1) / per;
  return (int)cudaSuccess;
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, const int* lengths,
           void* out, float* ws, int B, int Hq, int Hkv, int S, int Dh,
           float scale, int splits, cudaStream_t stream) {
  using G = DecodeTile<T>;
  int err = plan_splits(B, Hkv, S, splits, &splits);
  if (err != 0) return err;
  if (splits > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const int tiles = std::max(1, (S + DA_BK - 1) / DA_BK);
  const int tps = (tiles + splits - 1) / splits;
  const int vec =
      vec_ok<T>(q, Dh) && vec_ok<T>(kc, Dh) && vec_ok<T>(vc, Dh);
  cudaError_t e;
  const dim3 grid(Hkv, B, splits);
  if (std::is_same<T, __nv_bfloat16>::value && Dh % 16 == 0) {
    const int smem = mma_smem_bytes(Dh);
    e = cudaFuncSetAttribute(decode_split_mma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    decode_split_mma_kernel<<<grid, DA_THREADS, smem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)kc,
        (const __nv_bfloat16*)vc, lengths, (__nv_bfloat16*)out, ws, Hq, Hkv,
        S, Dh, scale, tps, vec);
  } else {
    const int smem = G::smem_bytes(Dh);
    e = cudaFuncSetAttribute(decode_split_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    decode_split_kernel<T><<<grid, DA_THREADS, smem, stream>>>(
        (const T*)q, (const T*)kc, (const T*)vc, lengths, (T*)out, ws, Hq,
        Hkv, S, Dh, scale, tps, vec);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  decode_combine_kernel<T>
      <<<dim3(Hq, B), std::min(256, (Dh + 31) / 32 * 32),
         (2 * splits + 1) * (int)sizeof(float), stream>>>(ws, (T*)out, B, Hq, Hkv,
                                                      Dh, splits);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// The splits the kernel plans for B sequences of Hkv KV heads over S
// slots (`requested` > 0 caps them instead): the caller sizes `ws` from
// them, B * Hkv * splits * (Hq / Hkv) * (Dh + 2) floats.
extern "C" int rt_decode_attention_splits(int B, int Hkv, int S,
                                          int requested, int* splits) {
  return repro_torch::plan_splits(B, Hkv, S, requested, splits);
}

// dtype: kF32 or kBF16 for q, the caches and out; lengths int32; ws the
// fp32 workspace for splits > 1 (`rt_decode_attention_splits`).
extern "C" int rt_decode_attention(const void* q, const void* k_cache,
                                   const void* v_cache, const int* lengths,
                                   void* out, float* ws, int B, int Hq,
                                   int Hkv, int S, int Dh, float scale,
                                   int splits, int dtype, void* stream) {
  using namespace repro_torch;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(q, k_cache, v_cache, lengths, out, ws, B,
                                 Hq, Hkv, S, Dh, scale, splits, s);
  return launch<float>(q, k_cache, v_cache, lengths, out, ws, B, Hq, Hkv, S,
                       Dh, scale, splits, s);
}

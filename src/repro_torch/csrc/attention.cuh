// The int8 chains' attention tile, `attention_tile`: one (image, head,
// 32-query slice) of exact softmax attention on fp32 Q, K and V, run by
// attention.cu (kernels 2 and 3) and by the int8 layer group's attention
// stage (vita_layer_group.cu, kernel 8), so the three compute it alike.
//
// Numerics as the TPU kernel's softmax_av with an fp32 output:
//   s_j = (q . k_j) * scale [+ (bias_j + mask_j)]
//   p_j = exp(s_j - max_j s_j) / sum_j exp(...)
//   out_e = sum_j p_j v_j[e]
// Both products run on mma.sync m16n8k8 in split TF32, three passes
// (tf32_split.cuh): Q, K, P and V are fp32 in the TPU kernel and are
// never rounded below fp32-accurate here.  The softmax is exact over all
// N keys: a slice's scores fit in shared memory, so no online rescaling.
// The windowed (Swin) mask holds -1e30; the max subtraction keeps the
// masked scores finite and exp() sends them to 0, never to NaN.
//
// Work split, 8 warps.  Q of the slice is split into its TF32 parts once,
// into Q_hi and Q_lo [32][DP + 8]; K and then V stream through a ring of
// 64-key pages (16-byte cp.async, 2-3 stages), so only the scores [32][NK
// + 8] (NK = N rounded up to a page) grow with N, and V's first pages
// arrive while the softmax runs.  A warp takes all 32 rows of its work, so
// each K and V value it loads is split once and feeds both row groups:
//   S: warp w the page's key tile w (8 keys); keys past N score -inf; each
//      row's maximum collects in shared memory (atomicMax on an ordered
//      int) as the scores are written.
//   softmax: one pass, a warp's 4 rows side by side: P = exp(S - max)
//      over the scores, and the row sum's reciprocal rounded to nearest.
//      P . V scales P by it as it reads P: P is normalised before the
//      product, as in the TPU kernel, within an ulp of P / sum.
//   P . V: warp w the 16 columns 16 (w % T).. of DP (T = DP / 16 column
//      blocks) over key group w / T: the page's 8-key steps w / T, w / T
//      + 8 / T, ...; the groups' fp32 sums are added in group order.
// The order of every sum depends on the tile alone, not on its caller.
//
// Widths: DP (Dh padded with zero columns) is 32, 64 or 128.  At DP 128
// the eight warps are the eight 16-column blocks of P . V, one key group.
// The float MSA (kernels 1, 5 and 7) runs this tile too where its own
// cluster tile cannot hold K and V (Dh past 64, N past 512, or K and V
// past a block's shared memory; kernels/vita_msa.py::msa_plan): with BF16
// (z in bf16, V rounded to bf16 by the projection) P is rounded to bf16
// after its normalisation and the output is written in bf16, as the TPU
// kernel rounds P and V to z's type before the product.  The rounded P
// and V are exact in TF32, so the split passes add only zeros.
#pragma once

#include "tf32_split.cuh"

namespace repro_torch {

constexpr int ATT_WARPS = 8, ATT_THREADS = 32 * ATT_WARPS, ATT_ROWS = 32,
              ATT_PAGE = 64, ATT_MAX_STAGES = 3, ATT_SMEM_LIMIT = 232448;

// Shared memory of one tile, byte offsets: Q_hi then Q_lo [rows][ldk]
// (TF32 bits) and each row's maximum and reciprocal sum [rows]; the scores
// [rows][lds] fp32 (at least the P . V key groups' partial sums); and the
// ring of `stages` slots of `stage` bytes, each a K page [64][ldk] or a V
// page [64][ldv].  ldk = DP + 8 and lds = NK + 8 put
// the rows of an 8-byte fragment load (rows g, columns 2t) on distinct
// banks, ldv = DP + 4 the rows of a B pair load (rows 2t, columns 2g).
// kernels/vita_msa.py::attention_plan computes the layout (the fields in
// this order) and the launch takes it as is; `att_layout_ok` checks only
// the limits the tile's code assumes.
struct AttLayout {
  int dp, rows, nk, lds, ldk, ldv, stage, stages;
  int q_off, s_off, ring_off, smem;
};
static_assert(sizeof(AttLayout) == 12 * sizeof(int), "plan is 12 ints");

// Floats of P . V's partial sums: each key group past the first holds 16
// values a lane of each column block.
__host__ __device__ constexpr int att_red_floats(int dp) {
  return (ATT_WARPS / (dp / 16) - 1) * 16 * (dp / 16) * 32;
}

inline bool att_layout_ok(const AttLayout& L, int N, int Dh) {
  if (L.dp != 32 && L.dp != 64 && L.dp != 128) return false;
  const int sfl = L.rows * L.lds > att_red_floats(L.dp)
                      ? L.rows * L.lds : att_red_floats(L.dp);
  return Dh >= 1 && Dh <= L.dp && N >= 1 &&
         L.rows == ATT_ROWS && L.nk >= N && L.nk % ATT_PAGE == 0 &&
         L.lds >= L.nk && L.lds % 2 == 0 && L.ldk == L.dp + 8 &&
         L.ldv == L.dp + 4 && L.stage >= ATT_PAGE * L.ldk * 4 &&
         L.stage % 16 == 0 && L.stages >= 1 &&
         L.stages <= ATT_MAX_STAGES && L.q_off >= 0 && L.q_off % 16 == 0 &&
         L.s_off % 16 == 0 && L.ring_off % 16 == 0 &&
         L.q_off + 2 * L.rows * (L.ldk + 1) * 4 <= L.s_off &&
         L.s_off + sfl * 4 <= L.ring_off &&
         L.ring_off + L.stages * L.stage <= L.smem &&
         L.smem <= ATT_SMEM_LIMIT;
}

// A float as an int with the same order (for atomicMax on a row maximum).
__device__ __forceinline__ int ordered_int(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float from_ordered_int(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// An A fragment (rows r, r + 8; k0..k0 + 7) of a tile already split into
// TF32 parts `hi` and `lo` (row stride ld): `load_split_a`'s fragment,
// read rather than computed.
__device__ __forceinline__ SplitA load_presplit_a(const uint32_t* hi,
                                                  const uint32_t* lo, int ld,
                                                  int r, int k0) {
  const int o = r * ld + k0 + 2 * (threadIdx.x % 4), o8 = o + 8 * ld;
  const uint2 uh = *reinterpret_cast<const uint2*>(hi + o);
  const uint2 wh = *reinterpret_cast<const uint2*>(hi + o8);
  const uint2 ul = *reinterpret_cast<const uint2*>(lo + o);
  const uint2 wl = *reinterpret_cast<const uint2*>(lo + o8);
  SplitA a;
  a.hi[0] = uh.x; a.hi[1] = wh.x; a.hi[2] = uh.y; a.hi[3] = wh.y;
  a.lo[0] = ul.x; a.lo[1] = wl.x; a.lo[2] = ul.y; a.lo[3] = wl.y;
  return a;
}

// Work item (image b, head h, query slice qt) for a block of ATT_THREADS
// threads, laid out by L (L.dp == DP).  q/k/v share one stride set:
// element e of token n, head h, image b is at base[b*sb + n*sn + h*sh + e];
// `vec`: the three are 16-byte aligned with sb, sn, sh and Dh multiples of
// 4 (the pages copy by cp.async, else by plain loads).  out uses (ob, on,
// oh) the same way and is float, or int8 quantised at *out_scale.  bias
// (H, N, N) and mask (nW, N, N) select the windowed mode (both null:
// global).  BF16: P rounded to bf16 and out bf16 (out_scale null).  Part:
// the threads that run the tile, the whole block of ATT_THREADS, or the
// first ATT_THREADS of a larger block (BlockPart<ATT_THREADS>, synced on
// a named barrier; the float layer group's blocks are twice as wide).
// Ends with a barrier of Part, so a persistent block may take its next
// item at once.  No pointer carries __restrict__: in the group kernels q,
// k, v and out are workspace that other blocks wrote earlier in the same
// launch, which must not be read through the read-only cache.
template <int DP, bool BF16 = false, typename Part = WholeBlock>
__device__ __forceinline__ void attention_tile(
    unsigned char* smem, const AttLayout& L, const float* q, const float* k,
    const float* v, long long sb, long long sn, long long sh, bool vec,
    void* out, long long ob, long long on, long long oh, int N, int Dh,
    float scale, const float* out_scale, const float* bias,
    const float* mask, int nW, int qt, int h, int b) {
  constexpr int LDK = DP + 8, LDV = DP + 4, PAGE = ATT_PAGE;
  constexpr int CB = DP / 16, KG = ATT_WARPS / CB;   // P . V
  constexpr int RPW = ATT_ROWS / ATT_WARPS;          // softmax rows a warp
  const int LDS = L.lds, S = L.stages;
  const int pages = (N + PAGE - 1) / PAGE, loads = 2 * pages;
  float* Qs = reinterpret_cast<float*>(smem + L.q_off);
  uint32_t* Qh = reinterpret_cast<uint32_t*>(Qs);
  uint32_t* Ql = Qh + ATT_ROWS * LDK;
  int* rmax = reinterpret_cast<int*>(Ql + ATT_ROWS * LDK);   // [rows]
  float* rinv = reinterpret_cast<float*>(rmax + ATT_ROWS);   // [rows]
  float* Ss = reinterpret_cast<float*>(smem + L.s_off);
  unsigned char* ring = smem + L.ring_off;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const long long base = (long long)b * sb + (long long)h * sh;
  const int q0 = qt * ATT_ROWS;
  const float ninf = __int_as_float(0xff800000);

  // Copy `i` of the stream: K page i, then V page i - pages, into ring
  // slot i % S; rows past N and columns past Dh are zeros.
  auto issue = [&](int i) {
    const bool kp = i < pages;
    const int row0 = (kp ? i : i - pages) * PAGE;
    const float* src = (kp ? k : v) + base;
    unsigned char* dst = ring + (i % S) * L.stage;
    const int ds = (kp ? LDK : LDV) * 4;
    if (vec)
      load_tile_fast<float, ATT_THREADS, PAGE, DP>(dst, ds, src, sn, row0, N,
                                                   0, Dh);
    else
      load_tile<float, ATT_THREADS>(dst, ds, src, sn, row0, N, 0, Dh, PAGE,
                                    DP, false);
  };
  // Step i of the stream: the copy S - 1 ahead goes out, copy i is waited
  // for; returns its ring slot.
  auto step = [&](int i) {
    if (i + S - 1 < loads) issue(i + S - 1);
    cp_async_commit();
    cp_async_wait_n(S - 1);
    Part::sync();
    return reinterpret_cast<const float*>(ring + (i % S) * L.stage);
  };
  // Q of the slice (fp32, into Q_hi's place) joins the first copy group.
  if (vec)
    load_tile_fast<float, ATT_THREADS, ATT_ROWS, DP>(
        reinterpret_cast<unsigned char*>(Qs), LDK * 4, q + base, sn, q0, N, 0,
        Dh);
  else
    load_tile<float, ATT_THREADS>(reinterpret_cast<unsigned char*>(Qs),
                                  LDK * 4, q + base, sn, q0, N, 0, Dh,
                                  ATT_ROWS, DP, false);
  for (int i = 0; i < S - 1; ++i) {
    if (i < loads) issue(i);
    cp_async_commit();
  }
  if (threadIdx.x < ATT_ROWS) rmax[threadIdx.x] = ordered_int(ninf);

  // S, a page at a time: warp w the page's key tile w (8 keys), both row
  // groups.  Each row's maximum collects in rmax as the scores are written.
  const float* bias_h = bias ? bias + (size_t)h * N * N : nullptr;
  const float* mask_w = mask ? mask + (size_t)(b % nW) * N * N : nullptr;
  for (int i = 0; i < pages; ++i) {
    const float* slot = step(i);
    if (i == 0) {
      // Q into its TF32 parts, once for the slice.
      for (int x = threadIdx.x; x < ATT_ROWS * DP; x += ATT_THREADS) {
        const int o = x / DP * LDK + x % DP;
        split_tf32(Qs[o], Qh[o], Ql[o]);
      }
      Part::sync();
    }
    const int j0 = i * PAGE + 8 * warp, j = j0 + 2 * t;
    if (j0 < N) {
      // Windowed: the 8 (bias + mask) terms of this lane's scores, loaded
      // first, so that their latency passes under the products.
      float bm[8] = {};
      if (bias_h) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int n = q0 + 16 * (e / 4) + g + 8 * ((e / 2) % 2);
          const int jc = j + e % 2;
          const size_t o = (size_t)n * N + jc;
          if (n < N && jc < N) bm[e] = bias_h[o] + mask_w[o];
        }
      }
      // Each 8-deep step: the high product into a fresh accumulator added
      // rounded to nearest (tf32_split.cuh), the two small ones into
      // accumulators of their own.
      float sv[2][4] = {}, sl[2][4] = {}, sm[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < DP / 8; ++ks) {
        const float2 kv = *reinterpret_cast<const float2*>(
            slot + (8 * warp + g) * LDK + 8 * ks + 2 * t);
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(kv.x, bh0, bl0);
        split_tf32(kv.y, bh1, bl1);
#pragma unroll
        for (int rg = 0; rg < 2; ++rg) {
          const SplitA a = load_presplit_a(Qh, Ql, LDK, 16 * rg + g, 8 * ks);
          float hi[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32_1688(hi, a.hi, bh0, bh1);
          mma_tf32_1688(sl[rg], a.lo, bh0, bh1);
          mma_tf32_1688(sm[rg], a.hi, bl0, bl1);
#pragma unroll
          for (int e = 0; e < 4; ++e) sv[rg][e] += hi[e];
        }
      }
#pragma unroll
      for (int e = 0; e < 8; e += 2) {              // rows g, g + 8 of each
        const int rg = e / 4, c2 = e % 4;           // row group
        const int r = 16 * rg + g + 8 * (c2 / 2), n = q0 + r;
        float s2[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float s = ninf;
          if (j + c < N) {
            s = (sv[rg][c2 + c] + (sl[rg][c2 + c] + sm[rg][c2 + c])) * scale;
            if (bias_h && n < N) s = s + bm[e + c];
          }
          s2[c] = s;
        }
        *reinterpret_cast<float2*>(Ss + r * LDS + j) =
            make_float2(s2[0], s2[1]);
        // The row's maximum over the tile's 8 keys (the 4 lanes of row r).
        float m = fmaxf(s2[0], s2[1]);
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        if (t == 0) atomicMax(rmax + r, ordered_int(m));
      }
    }
    Part::sync();
  }
  // Exact softmax over the keys up to N rounded to 8 (the rest of the
  // last key tile scored -inf, so its P is 0): P = exp(S - max), and the
  // reciprocal of the row sum, rounded to nearest, by which P . V scales P
  // as it reads it (within an ulp of P / sum).
  {
    const int nk8 = (N + 7) & ~7;
    float mx[RPW], sum[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      mx[r] = from_ordered_int(rmax[warp + ATT_WARPS * r]);
      sum[r] = 0.f;
    }
    for (int jj = lane; jj < nk8; jj += 32)
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        float* sp = Ss + (warp + ATT_WARPS * r) * LDS + jj;
        const float p = expf(*sp - mx[r]);
        *sp = p;
        sum[r] += p;
      }
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      sum[r] = warp_sum(sum[r]);
      if (lane == 0) rinv[warp + ATT_WARPS * r] = __frcp_rn(sum[r]);
    }
  }
  Part::sync();
  // P . V, a page at a time: warp w the 16 columns 16 (w % CB).. over key
  // group w / CB, the page's 8-key steps w / CB, w / CB + KG, ...; steps
  // past N would add products of zeros and are skipped.
  const int cb = warp % CB, kq = warp / CB;
  auto p_of = [](float p) {
    return BF16 ? round_to<__nv_bfloat16>(p) : p;
  };
  float ri[2][2];                                    // [row group][g, g+8]
#pragma unroll
  for (int e = 0; e < 4; ++e) ri[e / 2][e % 2] = rinv[8 * e + g];
  SplitAcc so[2][2];                                 // [row group][n-tile]
#pragma unroll
  for (int e = 0; e < 4; ++e) split_zero(so[e / 2][e % 2]);
  for (int i = pages; i < loads; ++i) {
    const float* slot = step(i);
    const int key0 = (i - pages) * PAGE;
#pragma unroll
    for (int ks = kq; ks < PAGE / 8; ks += KG) {
      const int k0 = key0 + 8 * ks;
      if (k0 >= N) break;
      const PairB vb = load_pair_b(slot, LDV, 8 * ks, 16 * cb);
#pragma unroll
      for (int rg = 0; rg < 2; ++rg) {
        const float* pr = Ss + (16 * rg + g) * LDS + k0 + 2 * t;
        const float2 u = *reinterpret_cast<const float2*>(pr);
        const float2 w = *reinterpret_cast<const float2*>(pr + 8 * LDS);
        SplitA a;
        split_tf32(p_of(u.x * ri[rg][0]), a.hi[0], a.lo[0]);
        split_tf32(p_of(w.x * ri[rg][1]), a.hi[1], a.lo[1]);
        split_tf32(p_of(u.y * ri[rg][0]), a.hi[2], a.lo[2]);
        split_tf32(p_of(w.y * ri[rg][1]), a.hi[3], a.lo[3]);
        mma_split<false>(so[rg][0], a, vb, 0);
        mma_split<false>(so[rg][1], a, vb, 1);
      }
    }
    Part::sync();
  }
  cp_async_wait<0>();
  // The key groups' sums, added in group order, to out; every read of the
  // scores is done (the loop's last barrier), so they carry the partials.
  // The int8 output's scale is read once, before any store.
  const float os = out_scale ? *out_scale : 0.f;
  float* red = Ss;
  const int rt = cb * 32 + lane;
  if (kq > 0) {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      red[((kq - 1) * 16 + e) * (CB * 32) + rt] =
          split_value(so[e / 8][(e / 4) % 2], e % 4);
  }
  Part::sync();
  if (kq == 0) {
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int rg = e / 8, half = (e / 4) % 2, c = e % 4;
      const int col = pair_col(16 * cb, half, c);
      const int n = q0 + 16 * rg + g + 8 * (c >> 1);
      float o = split_value(so[rg][half], c);
#pragma unroll
      for (int w = 1; w < KG; ++w)
        o += red[((w - 1) * 16 + e) * (CB * 32) + rt];
      if (n < N && col < Dh) {
        const long long i = (long long)b * ob + (long long)n * on +
                            (long long)h * oh + col;
        if constexpr (BF16)
          static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(o);
        else if (out_scale)
          static_cast<int8_t*>(out)[i] = quant_i8(o, os);
        else
          static_cast<float*>(out)[i] = o;
      }
    }
  }
  Part::sync();
}

}  // namespace repro_torch

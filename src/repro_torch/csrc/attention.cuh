// One query row of exact softmax attention, computed by one warp: the
// engine-2 core (repro/kernels/vita_msa.py::softmax_av) shared by
// attention.cu and vita_msa.cu; and `attention_tile`, one (image, head,
// 32-query tile) work item, shared by attention.cu and vita_layer_group.cu.
//
// K and V of the (image, head) sit in shared memory (K rows padded to
// ks = Dh + 1 floats so the lanes read distinct banks); the warp's scores
// live in a row buffer of N floats, so the softmax is exact over all N keys
// with no online rescaling.  Numerics as the reference:
//   s_j = (q . k_j) * scale [+ (bias_j + mask_j)]
//   p_j = exp(s_j - max_j s_j) / sum_j exp(...)
//   out_e = sum_j p_j v_j[e]
// The windowed (Swin) mask holds -1e30; the max subtraction keeps the
// masked scores finite and exp() sends them to 0, never to NaN.
#pragma once

#include "common.cuh"

namespace repro_torch {

// brow/mrow: this row's relative-position bias and region mask (N each),
// both null outside windowed mode.  V is VT: fp32, or bf16 for the bf16
// mode of vita_msa.cu, where P is rounded to bf16 too before the AV
// product (the TPU kernel's p.astype(z.dtype), v.astype(z.dtype)); the sum
// stays fp32.  out[o + e] is OT: float, bf16, or int8 quantised at
// *out_scale.
template <typename VT, typename OT>
__device__ __forceinline__ void attend_row(
    const float* qrow, const float* Ks, int ks, const VT* Vs, int N,
    int Dh, float scale, const float* brow, const float* mrow, float* prow,
    OT* out, long long o, const float* out_scale) {
  const int lane = threadIdx.x % 32;
  float mx = __int_as_float(0xff800000);  // -inf
  for (int j = lane; j < N; j += 32) {
    const float* kr = Ks + j * ks;
    float s = 0.f;
    for (int e = 0; e < Dh; ++e) s = fmaf(qrow[e], kr[e], s);
    s = s * scale;
    if (brow) s = s + (brow[j] + mrow[j]);
    prow[j] = s;
    mx = fmaxf(mx, s);
  }
  mx = warp_max(mx);
  float sum = 0.f;
  for (int j = lane; j < N; j += 32) {
    float p = expf(prow[j] - mx);
    prow[j] = p;
    sum += p;
  }
  sum = warp_sum(sum);
  for (int j = lane; j < N; j += 32) prow[j] = round_to<VT>(prow[j] / sum);
  __syncwarp();
  for (int e = lane; e < Dh; e += 32) {
    float a = 0.f;
    for (int j = 0; j < N; ++j) a = fmaf(prow[j], to_f(Vs[j * Dh + e]), a);
    store_f(out, o + e, a, out_scale);
  }
  __syncwarp();
}

constexpr int ATT_WARPS = 8, ATT_QTILE = 32;

// Dynamic shared memory of one `attention_tile` block, in floats:
// K [N][Dh+1], V [N][Dh], and per warp a query row [Dh] and a score row [N].
__host__ __device__ inline size_t attention_smem_floats(int N, int Dh) {
  return (size_t)N * (2 * Dh + 1) + (size_t)ATT_WARPS * (Dh + N);
}

// Work item (image b, head h, query tile qt) for a block of ATT_WARPS warps.
// The block loads the head's K and V into shared memory, then each warp
// attends its rows of the tile.  q/k/v share one stride set: element e of
// token n, head h, image b is at base[b*sb + n*sn + h*sh + e]; out uses
// (ob, on, oh) the same way and is float, or int8 quantised at *out_scale.
// bias (H, N, N) and mask (nW, N, N) select the windowed mode (both null:
// global).  Ends with a block barrier, so a persistent block may take its
// next item at once.  No pointer carries __restrict__: in the int8 group
// kernel q, k, v and out are workspace that other blocks wrote earlier in
// the same launch, which must not be read through the read-only cache.
__device__ __forceinline__ void attention_tile(
    float* smem, const float* q, const float* k, const float* v, long long sb,
    long long sn, long long sh, void* out, long long ob, long long on,
    long long oh, int N, int Dh, float scale, const float* out_scale,
    const float* bias, const float* mask, int nW, int qt, int h, int b) {
  const int ks = Dh + 1;                  // padded K row: lanes read distinct banks
  float* Ks = smem;                       // [N][Dh+1]
  float* Vs = Ks + (size_t)N * ks;        // [N][Dh]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qrow = Vs + (size_t)N * Dh + warp * (Dh + N);   // [Dh]
  float* prow = qrow + Dh;                               // [N]
  const long long base = (long long)b * sb + (long long)h * sh;
  for (int i = threadIdx.x; i < N * Dh; i += blockDim.x) {
    int n = i / Dh, e = i % Dh;
    long long g = base + (long long)n * sn + e;
    Ks[n * ks + e] = k[g];
    Vs[n * Dh + e] = v[g];
  }
  __syncthreads();
  const float* bias_h = bias ? bias + (size_t)h * N * N : nullptr;
  const float* mask_w = mask ? mask + (size_t)(b % nW) * N * N : nullptr;
  const int q0 = qt * ATT_QTILE;
  for (int r = warp; r < ATT_QTILE; r += ATT_WARPS) {
    const int n = q0 + r;
    if (n >= N) break;
    const long long g = base + (long long)n * sn;
    for (int e = lane; e < Dh; e += 32) qrow[e] = q[g + e];
    __syncwarp();
    const float* brow = bias_h ? bias_h + (size_t)n * N : nullptr;
    const float* mrow = mask_w ? mask_w + (size_t)n * N : nullptr;
    const long long o = (long long)b * ob + (long long)n * on + (long long)h * oh;
    if (out_scale)
      attend_row(qrow, Ks, ks, Vs, N, Dh, scale, brow, mrow, prow,
                 static_cast<int8_t*>(out), o, out_scale);
    else
      attend_row(qrow, Ks, ks, Vs, N, Dh, scale, brow, mrow, prow,
                 static_cast<float*>(out), o, nullptr);
  }
  __syncthreads();
}

}  // namespace repro_torch

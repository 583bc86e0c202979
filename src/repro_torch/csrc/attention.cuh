// One query row of exact softmax attention, computed by one warp: the
// engine-2 core (repro/kernels/vita_msa.py::softmax_av) shared by
// attention.cu and vita_msa.cu.
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
// both null outside windowed mode.  out[o + e] is float, or int8 quantised
// at *out_scale when out_scale is not null.
__device__ __forceinline__ void attend_row(
    const float* qrow, const float* Ks, int ks, const float* Vs, int N,
    int Dh, float scale, const float* brow, const float* mrow, float* prow,
    void* out, long long o, const float* out_scale) {
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
  for (int j = lane; j < N; j += 32) prow[j] = prow[j] / sum;
  __syncwarp();
  const float qs = out_scale ? *out_scale : 1.0f;
  for (int e = lane; e < Dh; e += 32) {
    float a = 0.f;
    for (int j = 0; j < N; ++j) a = fmaf(prow[j], Vs[j * Dh + e], a);
    if (out_scale)
      static_cast<int8_t*>(out)[o + e] = quant_i8(a, qs);
    else
      static_cast<float*>(out)[o + e] = a;
  }
  __syncwarp();
}

}  // namespace repro_torch

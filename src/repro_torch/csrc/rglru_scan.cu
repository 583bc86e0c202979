// RG-LRU linear recurrence: h_t = a_t * h_{t-1} + b_t along T of
// (B, T, W), h_{-1} = 0, h carried in float32; a and b float32 or
// bfloat16, the output in a's type.
//
// Replaces: repro/kernels/rglru_scan.py::rglru_scan, a (batch, T-chunk)
// grid whose chunk axis runs in order with h carried in VMEM, and a
// log-depth scan inside each chunk.  Results differ from it by fp32
// reassociation (and one fused multiply-add per step) only.
//
// Design: one thread per (sequence, channel) walks T with h in a register;
// neighbouring threads take neighbouring channels, so every step's loads
// and stores are coalesced.  64 threads per block spread the B x W
// threads over more SMs (40 blocks at W 2560, B 1).  The loads do not
// depend on h, so the unrolled loop keeps several steps' loads in flight.
// Bound: bytes (a and b read once, h written once).  A scan across T
// (chunks in parallel, then a carry pass) would use more of the card at
// B x W this small; it buys nothing until T is long.
#include "common.cuh"

namespace repro_torch {

template <typename T>
__global__ void __launch_bounds__(64)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ out, int B, int Tn, int W) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * W) return;
  const int bb = idx / W, w = idx % W;
  const long long base = (long long)bb * Tn * W + w;
  float h = 0.f;
#pragma unroll 8
  for (int t = 0; t < Tn; ++t) {
    const long long o = base + (long long)t * W;
    h = fmaf(to_f(a[o]), h, to_f(b[o]));
    out[o] = from_f<T>(h);
  }
}

template <typename T>
int launch(const void* a, const void* b, void* out, int B, int Tn, int W,
           cudaStream_t stream) {
  const int n = B * W;
  rglru_scan_kernel<T><<<(n + 63) / 64, 64, 0, stream>>>(
      (const T*)a, (const T*)b, (T*)out, B, Tn, W);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// dtype: kF32 or kBF16 for a, b and out.
extern "C" int rt_rglru_scan(const void* a, const void* b, void* out, int B,
                             int Tn, int W, int dtype, void* stream) {
  using namespace repro_torch;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(a, b, out, B, Tn, W, s);
  return launch<float>(a, b, out, B, Tn, W, s);
}

// LM decode attention: one query per sequence, q (B, Hq, Dh), over a KV
// cache (B, Hkv, S, Dh) of which the first lengths[b] slots are valid;
// float32 or bfloat16 in and out.  A sequence of length 0 gives 0.
//
// Replaces: repro/kernels/head_attention.py::decode_attention, a (batch,
// KV head, k-block) grid that takes the Hq/Hkv query group of one KV head
// as one (group, Dh) tile, masks keys past lengths[b], and asserts that
// its block size divides S.
//
// Design: one block per (KV head, sequence).  Its Hq/Hkv query rows (at
// most 16: 10 at RecurrentGemma's 10:1 GQA) attend over the cache through
// the shared tile of head_attention.cuh.  The block reads lengths[b] on
// the device and stops after the last valid tile, so the host never syncs
// and nothing past the length is read; any S is taken.
// Bound: bytes, 2 * lengths[b] * Hkv * Dh elements of the cache per
// sequence (plus q and out); the (query rows x keys) products are few.
// With B x Hkv blocks (4 at RecurrentGemma's batch 4) most SMs idle: a
// split over S (flash-decoding) is later work.
#include "head_attention.cuh"

namespace repro_torch {

template <typename T>
__global__ void __launch_bounds__(AT_THREADS)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int Hq, int Hkv, int S, int Dh, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kvh = blockIdx.x, b = blockIdx.y, group = Hq / Hkv;
  const int nk = min(max(lengths[b], 0), S);
  const long long qo = ((long long)b * Hq + kvh * group) * Dh;
  const long long ko = (long long)(b * Hkv + kvh) * S * Dh;
  attend_rows<T>(q + qo, group, kc + ko, vc + ko, out + qo, Dh, nk, 0, nk,
                 scale, 0, 0, 0, smem);
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, const int* lengths,
           void* out, int B, int Hq, int Hkv, int S, int Dh, float scale,
           cudaStream_t stream) {
  const int smem = at_smem_bytes<T>(Dh);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hkv, B);
  decode_attention_kernel<T><<<grid, AT_THREADS, smem, stream>>>(
      (const T*)q, (const T*)kc, (const T*)vc, lengths, (T*)out, Hq, Hkv, S,
      Dh, scale);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// dtype: kF32 or kBF16 for q, the caches and out; lengths int32.
extern "C" int rt_decode_attention(const void* q, const void* k_cache,
                                   const void* v_cache, const int* lengths,
                                   void* out, int B, int Hq, int Hkv, int S,
                                   int Dh, float scale, int dtype,
                                   void* stream) {
  using namespace repro_torch;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(q, k_cache, v_cache, lengths, out, B, Hq,
                                 Hkv, S, Dh, scale, s);
  return launch<float>(q, k_cache, v_cache, lengths, out, B, Hq, Hkv, S, Dh,
                       scale, s);
}

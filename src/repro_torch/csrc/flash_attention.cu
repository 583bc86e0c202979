// LM prefill attention: q (B, Hq, Nq, Dh) against k, v (B, Hkv, Nk, Dh),
// GQA (query head h reads KV head h / (Hq / Hkv)), causal and sliding-window
// masks with a query offset; float32 or bfloat16 in and out.
//
// Replaces: repro/kernels/head_attention.py::flash_attention, a (batch,
// head, q-block, k-block) grid whose last axis runs in order and carries
// the online softmax's max, sum and accumulator in VMEM; it asserts that
// the block sizes divide Nq and Nk.
//
// Design: one block per (16-query tile, query head, sequence); the K/V
// tiles stream through shared memory inside the block (head_attention.cuh)
// in place of the sequential grid axis.  Ragged Nq and Nk are masked.  A
// tile emptied wholly by the masks is never loaded: with causal the walk
// stops after the tile's last query position, with a window it starts at
// the first key the tile's first query can see (4,096 tokens, window 2048:
// at most 2,112 keys per query tile instead of 4,096).
// Bound: at RecurrentGemma's shapes (Dh 256, GQA 10:1) operations, 4 * Nq
// * (visible keys) * Dh * Hq flops, on CUDA cores here; for short prompts
// the bytes of q, k, v and out.  Every (query tile, head) block re-reads
// its KV head's tiles: 10x at GQA 10:1, from L2.  wgmma/TMA are later work.
#include "head_attention.cuh"

namespace repro_torch {

template <typename T>
__global__ void __launch_bounds__(AT_THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Hq,
                       int Hkv, int Nq, int Nk, int Dh, float scale,
                       int causal, int window, int q_offset) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int q0 = qt * AT_BQ, rows = min(AT_BQ, Nq - q0);
  const int qpos0 = q_offset + q0;
  int k_end = Nk;
  if (causal) k_end = min(Nk, qpos0 + rows);  // last query sees keys <= it
  int k_begin = 0;
  if (window > 0) k_begin = max(0, qpos0 - window + 1) / AT_BK * AT_BK;
  const long long qo = ((long long)(b * Hq + h) * Nq + q0) * Dh;
  const long long ko = (long long)(b * Hkv + kvh) * Nk * Dh;
  attend_rows<T>(q + qo, rows, k + ko, v + ko, out + qo, Dh, Nk, k_begin,
                 max(k_end, 0), scale, causal, window, qpos0, smem);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int Nq, int Nk, int Dh, float scale, int causal,
           int window, int q_offset, cudaStream_t stream) {
  const int smem = at_smem_bytes<T>(Dh);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Nq + AT_BQ - 1) / AT_BQ, Hq, B);
  flash_attention_kernel<T><<<grid, AT_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Hq, Hkv, Nq, Nk, Dh,
      scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// window <= 0: no sliding window.  dtype: kF32 or kBF16 for q, k, v, out.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  void* out, int B, int Hq, int Hkv, int Nq,
                                  int Nk, int Dh, float scale, int causal,
                                  int window, int q_offset, int dtype,
                                  void* stream) {
  using namespace repro_torch;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, Nq, Nk, Dh, scale,
                                 causal, window, q_offset, s);
  return launch<float>(q, k, v, out, B, Hq, Hkv, Nq, Nk, Dh, scale, causal,
                       window, q_offset, s);
}

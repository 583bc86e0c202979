// Exact per-head softmax attention on fp32 Q, K and V for ViT sequence
// lengths, global or windowed (Swin): the attention launch of the int8
// chains, and of the float MSA where its cluster tile cannot hold K and V
// (Dh past 64 or long N: kernels/vita_msa.py::launch_msa).
//
// Replaces: the engine-2 core (repro/kernels/vita_msa.py::softmax_av with
// an fp32 output) as used inside repro/kernels/vita_layer.py::
// vita_layer_int8 (kernel 2) and repro/kernels/vita_msa.py::vita_msa_int8
// (kernel 3).  The TPU ran one (image, head) per sequential grid step with
// the whole head's Q/K/V/S in VMEM.  Here each block of 8 warps takes one
// (image, head, 32-query slice) in parallel: `attention_tile`
// (attention.cuh), which the int8 layer group's attention stage runs too.
// Bound: operations, 4*N*N*Dh flops per head against 4*N*Dh*4 bytes in
// and out (at DeiT-T batch 8, 238 MFLOP of fp32-accurate products against
// 4.8 MB: about 1.5 us at the split-TF32 rate of 165 TFLOP/s).  What the
// design does about it: both products on the tensor cores in split TF32
// (fp32-accurate, as the TPU kernel's fp32 dots), Q split into its TF32
// parts once a slice and each K and V value split once a warp for all 32
// rows (the splits, not the products, are most of the instructions), and
// K and V streamed through a ring of 64-key pages by cp.async (V's first
// pages land while the softmax runs), so a block's shared memory is Q's
// parts, the slice's score rows and the ring (105 KB at DeiT-T: two
// blocks an SM).  K and V are re-read once per query slice (ceil(N/32)
// times per head), from L2.
//
// Windowed mode (Swin): the caller folds windows into the batch axis, so
// "image" b is window b % nW of an image, and passes the relative-position
// bias (H, N, N) and the region mask (nW, N, N); row n of head h in batch
// row b adds bias[h][n][:] + mask[b % nW][n][:] to its scores after the
// scale, as the TPU kernel adds its `extra` term.  Both null: global mode.
//
// q/k/v share one stride set: element e of token n, head h, image b is at
// base[b*sb + n*sn + h*sh + e].  out uses (ob, on, oh) the same way and is
// float, or int8 quantised at *out_scale when out_scale is not null, or
// bf16 (the float MSA's bf16 mode: P rounded to bf16 before P . V).  Dh
// up to 128 (DP 32, 64 or 128; one block an SM at 128).
#include <cstring>
#include <type_traits>

#include "attention.cuh"

namespace repro_torch {

// Two blocks an SM at DP 64 (the shared memory of N up to 448), three at
// DP 32, where Swin's short windows make many small blocks, one at DP 128.
// BF16: the float MSA's bf16 mode (P rounded, bf16 out).
template <int DP, bool BF16>
__global__ void __launch_bounds__(ATT_THREADS,
                                  DP == 32 ? 3 : DP == 64 ? 2 : 1)
attention_kernel(const __grid_constant__ AttLayout L,
                 const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 long long sb, long long sn, long long sh, int vec,
                 void* __restrict__ out, long long ob, long long on,
                 long long oh, int N, int Dh, float scale,
                 const float* __restrict__ out_scale,
                 const float* __restrict__ bias,
                 const float* __restrict__ mask, int nW) {
  extern __shared__ __align__(16) unsigned char att_smem[];
  attention_tile<DP, BF16>(att_smem, L, q, k, v, sb, sn, sh, vec != 0, out,
                           ob, on, oh, N, Dh, scale, out_scale, bias, mask,
                           nW, blockIdx.x, blockIdx.y, blockIdx.z);
}

// f(kernel) for the kernel of the layout's DP (32, 64 or 128) and output
// mode; cudaErrorInvalidValue for any other DP.
template <typename F>
int with_attention_kernel(int dp, bool bf16, F&& f) {
  auto pick = [&](auto kernel_dp) {
    constexpr int DP = decltype(kernel_dp)::value;
    return bf16 ? f(attention_kernel<DP, true>)
                : f(attention_kernel<DP, false>);
  };
  if (dp == 32) return pick(std::integral_constant<int, 32>{});
  if (dp == 64) return pick(std::integral_constant<int, 64>{});
  if (dp == 128) return pick(std::integral_constant<int, 128>{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro_torch

// plan: the 12 ints of kernels/vita_msa.py::attention_plan(N, Dh) (the
// tile's AttLayout), refused where it breaks a limit of the tile.  bf16:
// out is bf16 and P is rounded to bf16 before P . V (out_scale null).
extern "C" int rt_attention(const float* q, const float* k, const float* v,
                            long long sb, long long sn, long long sh, void* out,
                            long long ob, long long on, long long oh, int B,
                            int H, int N, int Dh, float scale,
                            const float* out_scale, const float* bias,
                            const float* mask, int nW, int bf16,
                            const int* plan, void* stream) {
  using namespace repro_torch;
  AttLayout L;
  std::memcpy(&L, plan, sizeof L);
  if (!att_layout_ok(L, N, Dh) || B < 1 || H < 1 || nW < 1 ||
      (bf16 && out_scale))
    return (int)cudaErrorInvalidValue;
  const int vec = Dh % 4 == 0 && sb % 4 == 0 && sh % 4 == 0 &&
                  vec_ok<float>(q, sn) && vec_ok<float>(k, sn) &&
                  vec_ok<float>(v, sn);
  return with_attention_kernel(L.dp, bf16 != 0, [&](auto kernel) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((N + L.rows - 1) / L.rows, H, B);
    kernel<<<grid, ATT_THREADS, L.smem, (cudaStream_t)stream>>>(
        L, q, k, v, sb, sn, sh, vec, out, ob, on, oh, N, Dh, scale,
        out_scale, bias, mask, nW);
    return (int)cudaGetLastError();
  });
}

// Blocks of the attention kernel for DP `dp` that fit on one SM with
// `smem` bytes of dynamic shared memory, into *per_sm.
extern "C" int rt_attention_blocks_per_sm(int dp, int smem, int* per_sm) {
  using namespace repro_torch;
  return with_attention_kernel(dp, false, [&](auto kernel) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, kernel, ATT_THREADS, smem);
  });
}

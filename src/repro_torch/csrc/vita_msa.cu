// Float per-head MSA: Q/K/V projection and exact softmax attention with Q,
// K, V and the scores kept on chip, one thread-block cluster per (image,
// head).
//
// Replaces: repro/kernels/vita_msa.py::vita_msa_batched (and its
// single-image wrapper vita_msa), the (B, H)-grid Pallas kernel of the
// unfused float executor, whose defining trait is that per (image, head)
// only that head's Q/K/V/S ever exist on chip and SA is the only tensor
// written.  The same tile also runs kernel 1's attention
// (repro/kernels/vita_layer.py::vita_layer, through kernels/vita_layer.py)
// on its fp32 LN1 output, writing SA merged as (B*N, H*Dh).
//
// Bound: operations, 6*N*D*Dh (projections) + 4*N*N*Dh (attention) per
// (image, head), with nothing recomputed: each block of the cluster
// projects its own rows once and takes its peers' K and V rows through
// distributed shared memory (msa_tile.cuh).  The projections stream z and
// the weights through a cp.async ring of 3 to 8 stages (as deep as the
// K, V and score buffers it overlays hold) into the tensor cores:
// mma.sync bf16 in the bf16 mode; split TF32 (three passes with fp32
// weights, two with bf16 ones: fp32-accurate, 165 / 248 TFLOP/s of peak
// against the CUDA cores' 67) where z is fp32.  Q.K^T runs split TF32 in
// every mode (Q and K stay fp32, as on the TPU), P.V bf16 mma in the bf16
// mode and split TF32 otherwise.  The split's error against the plain
// version, measured on an H100 at DeiT-T batch 8: 1.0e-6 of the output
// scale in fp32 and 1.1e-6 in the mixed mode, against bounds of 1e-4 and
// 1e-5 (chip_smoke.py's `[check]` lines).  A block copies its peers' K
// and V once rather than reading them in place inside the fragment loops
// (reading in place was not tried: every S and P.V fragment would wait on
// a remote load).
//
// Short sequences: where kernels/vita_msa.py::msa_packed_plan gives a
// layout (fp32 z, N and Dh at most 32), the wrapper launches
// `rt_vita_msa_packed` instead, the packed tile of msa_packed.cuh: one
// block per floor(64 / N) whole sequences and all their heads.
//
// Windowed mode (Swin) and qkv_bias as the TPU kernel: bias (H, N, N) +
// mask (nW, N, N) join the scores after the scale, the mask picked by
// b % nW; qkv_bias (3, H, Dh) is added to the projections.
//
// Shapes past the cluster: where K and V of all N rows do not fit a block
// beside Q and the scores (Dh 65-128, N past 8 slices of 64, or fp32 N
// past 256 at Dh 64), kernels/vita_msa.py::msa_plan gives a paged plan and
// the wrapper makes two launches: `rt_msa_project` (below: the same
// projection, one block per (image, head, 64-row slice), Q, K and V to
// device memory, V rounded to z's type) and the attention tile of
// attention.cu, which pages K and V through shared memory.  At DP 128 the
// projection takes the head's three weight slices one a pass.
//
// dtype modes (ref.PORTED_MODES): z ZT with weights WT, fp32 / fp32, fp32 /
// bf16 or bf16 / bf16; Q, K and the scores fp32; V and P rounded to ZT
// before the P.V product (softmax_av, out_dtype = z.dtype), the sum fp32,
// the output ZT.
#include <cstring>
#include <type_traits>

#include "msa_packed.cuh"
#include "msa_tile.cuh"

namespace repro_torch {

template <typename ZT, typename WT, int DP>
__global__ void __launch_bounds__(MSA_THREADS, 1)
vita_msa_kernel(const ZT* __restrict__ z, const WT* __restrict__ wq,
                const WT* __restrict__ wk, const WT* __restrict__ wv,
                const WT* __restrict__ qkv_bias,
                const float* __restrict__ bias, const float* __restrict__ mask,
                int nW, ZT* __restrict__ out, long long ob, long long on,
                long long oh, int N, int D, int H, int Dh, float scale,
                MsaLayout L, int vecs) {
  extern __shared__ __align__(16) unsigned char smem[];
  msa_tile<ZT, WT, DP>(smem, L, z, wq, wk, wv, qkv_bias, bias, mask, nW, out,
                       ob, on, oh, N, D, H, Dh, scale, vecs, blockIdx.y,
                       blockIdx.z);
}

// The projection of a paged plan: block (slice, head, image) writes Q, K
// and V of its 64 rows (fp32; V rounded to ZT) to q/k/v (B*N, H*Dh); at
// DP 128 block (3 slice + p, head, image) writes part p of the three (a
// wide head has few slices, and a slice a block would leave most SMs
// idle).
template <typename ZT, typename WT, int DP>
__global__ void __launch_bounds__(MSA_THREADS, 1)
msa_project_kernel(const ZT* __restrict__ z, const WT* __restrict__ wq,
                   const WT* __restrict__ wk, const WT* __restrict__ wv,
                   const WT* __restrict__ qkv_bias, float* __restrict__ q,
                   float* __restrict__ k, float* __restrict__ v, int N, int D,
                   int H, int Dh, MsaLayout L, int vecs) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int PARTS = DP > 64 ? 3 : 1;          // blocks a slice
  const int slice = blockIdx.x / PARTS, p = blockIdx.x % PARTS;
  const int row0 = slice * MSA_ROWS, h = blockIdx.y, b = blockIdx.z;
  const long long HD = (long long)H * Dh;
  float* const dst[3] = {q, k, v};
  msa_project<ZT, WT, DP>(
      smem, L, z, wq, wk, wv, qkv_bias, N, D, H, Dh, vecs, h, b, row0,
      [&](int part, int r, int col, float val) {
        const int n = row0 + r;
        if (n < N && col < Dh)
          dst[part][((long long)b * N + n) * HD + (long long)h * Dh + col] =
              part == 2 ? round_to<ZT>(val) : val;
      },
      PARTS == 3 ? p : 0, PARTS == 3 ? p + 1 : 3);
}

template <typename ZT, typename WT, int DP>
int launch_msa(const MsaLayout& L, const void* z, const void* wq,
               const void* wk, const void* wv, const void* qkv_bias,
               const float* bias, const float* mask, int nW, void* out,
               long long ob, long long on, long long oh, int B, int N, int D,
               int H, int Dh, float scale, int vecs, cudaStream_t stream) {
  auto kernel = vita_msa_kernel<ZT, WT, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(L.cluster, H, B);
  cfg.blockDim = dim3(MSA_THREADS);
  cfg.dynamicSmemBytes = L.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, (const ZT*)z, (const WT*)wq,
                           (const WT*)wk, (const WT*)wv, (const WT*)qkv_bias,
                           bias, mask, nW, (ZT*)out, ob, on, oh, N, D, H, Dh,
                           scale, L, vecs);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// zt / wt: the ElemCode of z (and out) and of the weights and qkv_bias.
// out element (image b, token n, head h, column e) is out[b ob + n on +
// h oh + e].  plan: the 15 ints of the wrapper's MsaLayout
// (kernels/vita_msa.py::msa_plan), a cluster plan, refused where it breaks
// a limit of the tile (`msa_layout_ok`).
extern "C" int rt_vita_msa(const void* z, const void* wq, const void* wk,
                           const void* wv, const void* qkv_bias,
                           const float* bias, const float* mask, int nW,
                           void* out, long long ob, long long on,
                           long long oh, int B, int N, int D, int H, int Dh,
                           float scale, int zt, int wt, const int* plan,
                           void* stream) {
  using namespace repro_torch;
  MsaLayout L;
  std::memcpy(&L, plan, sizeof L);
  if (L.paged || !msa_layout_ok(L, N, Dh)) return (int)cudaErrorInvalidValue;
  return dispatch_mode(zt, wt, [&](auto ztag, auto wtag) {
    using ZT = typename decltype(ztag)::type;
    using WT = typename decltype(wtag)::type;
    const int vecs = (vec_ok<ZT>(z, D) ? 1 : 0) |
                     (vec_ok<WT>(wq, Dh) && vec_ok<WT>(wk, Dh) &&
                              vec_ok<WT>(wv, Dh)
                          ? 2
                          : 0);
    auto go = [&](auto kernel_dp) {
      constexpr int DP = decltype(kernel_dp)::value;
      return launch_msa<ZT, WT, DP>(L, z, wq, wk, wv, qkv_bias, bias, mask,
                                    nW, out, ob, on, oh, B, N, D, H, Dh,
                                    scale, vecs, (cudaStream_t)stream);
    };
    return L.dp == 32 ? go(std::integral_constant<int, 32>{})
                      : go(std::integral_constant<int, 64>{});
  });
}

// The projection of a paged plan (the 15 ints of msa_plan with paged 1):
// Q, K and V of (B, N, H, Dh) into q, k and v, each (B*N, H*Dh) float32,
// V rounded to z's type.
extern "C" int rt_msa_project(const void* z, const void* wq, const void* wk,
                              const void* wv, const void* qkv_bias, float* q,
                              float* k, float* v, int B, int N, int D, int H,
                              int Dh, int zt, int wt, const int* plan,
                              void* stream) {
  using namespace repro_torch;
  MsaLayout L;
  std::memcpy(&L, plan, sizeof L);
  if (L.paged != 1 || !msa_layout_ok(L, N, Dh) || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  return dispatch_mode(zt, wt, [&](auto ztag, auto wtag) {
    using ZT = typename decltype(ztag)::type;
    using WT = typename decltype(wtag)::type;
    const int vecs = (vec_ok<ZT>(z, D) ? 1 : 0) |
                     (vec_ok<WT>(wq, Dh) && vec_ok<WT>(wk, Dh) &&
                              vec_ok<WT>(wv, Dh)
                          ? 2
                          : 0);
    auto go = [&](auto kernel_dp) {
      constexpr int DP = decltype(kernel_dp)::value;
      auto kernel = msa_project_kernel<ZT, WT, DP>;
      const int ring = L.stages * L.stage;           // at offset 0
      const int blocks = L.cluster * (DP > 64 ? 3 : 1);
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ring);
      if (err != cudaSuccess) return (int)err;
      kernel<<<dim3(blocks, H, B), MSA_THREADS, ring,
               (cudaStream_t)stream>>>((const ZT*)z, (const WT*)wq,
                                       (const WT*)wk, (const WT*)wv,
                                       (const WT*)qkv_bias, q, k, v, N, D, H,
                                       Dh, L, vecs);
      return (int)cudaGetLastError();
    };
    return L.dp == 64 ? go(std::integral_constant<int, 64>{})
                      : go(std::integral_constant<int, 128>{});
  });
}

// The packed tile (msa_packed.cuh): the arguments of rt_vita_msa, z
// float32 (zt kF32), plan the 12 ints of the wrapper's PackedLayout
// (kernels/vita_msa.py::msa_packed_plan), refused where it breaks a limit
// of the tile (`packed_layout_ok`).
extern "C" int rt_vita_msa_packed(const void* z, const void* wq,
                                  const void* wk, const void* wv,
                                  const void* qkv_bias, const float* bias,
                                  const float* mask, int nW, void* out,
                                  long long ob, long long on, long long oh,
                                  int B, int N, int D, int H, int Dh,
                                  float scale, int zt, int wt,
                                  const int* plan, void* stream) {
  using namespace repro_torch;
  PackedLayout L;
  std::memcpy(&L, plan, sizeof L);
  if (zt != kF32 || B < 1) return (int)cudaErrorInvalidValue;
  return dispatch_type(wt, [&](auto wtag) {
    using WT = typename decltype(wtag)::type;
    if (!packed_layout_ok(L, N, D, H, Dh, (int)sizeof(WT)))
      return (int)cudaErrorInvalidValue;
    auto words = [](const void* p) {
      return reinterpret_cast<uintptr_t>(p) % 4 == 0;
    };
    const int vecs = (vec_ok<float>(z, D) ? 1 : 0) |
                     ((sizeof(WT) == 4 || Dh % 2 == 0) && words(wq) &&
                              words(wk) && words(wv)
                          ? 2
                          : 0);
    auto go = [&](auto kernel_dp) {
      auto kernel = msa_packed_kernel<WT, decltype(kernel_dp)::value>;
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.smem);
      if (err != cudaSuccess) return (int)err;
      const int blocks = (B + L.seqs - 1) / L.seqs;
      kernel<<<blocks, PK_THREADS, L.smem, (cudaStream_t)stream>>>(
          (const float*)z, (const WT*)wq, (const WT*)wk, (const WT*)wv,
          (const WT*)qkv_bias, bias, mask, nW, (float*)out, ob, on, oh, B,
          N, D, H, Dh, scale, L, vecs);
      return (int)cudaGetLastError();
    };
    switch (L.dp) {
      case 8: return go(std::integral_constant<int, 8>{});
      case 16: return go(std::integral_constant<int, 16>{});
      case 24: return go(std::integral_constant<int, 24>{});
      default: return go(std::integral_constant<int, 32>{});
    }
  });
}

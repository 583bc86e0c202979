// Layer groups: L fused encoder layers, float or int8, in ONE persistent
// cooperative launch per group call.
//
// Replaces: repro/kernels/vita_layer.py::vita_layer_group and
// ::vita_layer_group_int8 (kernels 7 and 8).  The TPU kernel runs a
// sequential (B, L, H) grid with the (N, D) activation resident in VMEM for
// all L*H steps, so a layer boundary costs one grid step, not a launch, and
// layer l+1's weights stream in during layer l's MLP tail.
//
// What does not carry over: nothing persists between Hopper blocks, and at
// DeiT-T widths one image's y, z and accumulator are 147 KiB each against
// 227 KB of shared memory a block.  What does: one launch for the whole
// group.  Each block of a grid sized to fit on the card at once
// (occupancy x SMs, capped at the widest stage's work) walks every stage's
// tiles, `for (t = blockIdx.x; t < n; t += gridDim.x)`, and a grid-wide
// barrier separates the seven stages of each layer:
//
//   1. LN1(y) -> z                      (int8: quantised at act[l][0])
//   2. Q, K, V = z . wq/wk/wv[l]        (the (L, H, D, Dh) stacks read in place)
//   3. SA = attention per (image, head, 32-query tile)
//                                       (+ bias[l][h] + mask[i % nW] windowed;
//                                        int8: quantised at act[l][1])
//   4. h1 = y + SA . w_msa[l]           (w_msa[l] has H*Dh rows, not D, when
//                                        the group is head-pruned)
//   5. LN2(h1) -> z                     (int8: quantised at act[l][2])
//   6. hid = gelu(z . w_up[l] + b_up[l])
//                                       (int8: quantised at act[l][3]); layer
//                                        l+1's wq/wk/wv/w_msa are prefetched
//                                        into L2 meanwhile
//   7. y = h1 + hid . w_down[l] + b_down[l]
//
// x is read once (layer 0's y); an fp32 `carry` holds y between layers,
// and the last layer's stage 7 writes `out` in x's type: the activation is
// rounded once, at the end, as the TPU kernel carries y in an fp32 scratch
// and casts at its last step.  (In bf16 a group is therefore not L calls of
// the per-layer chain, each of which rounds its output; in fp32 and with
// fp32 x it is, bit for bit.)  The wrapper allocates the workspace z, q, k,
// v, sa, h1, hid, carry and the barrier counter in one buffer; at DeiT-T
// batch 8 it is ~13 MB and stays in L2.
//
// Types: x and out are XT (float or bf16); the float kernel's weight
// stacks, LN vectors and biases WT (float or bf16, read into fp32 as
// staged), the int8 kernel's LN vectors and biases WT beside int8 weights;
// every workspace buffer is fp32 (or int8), so all math is fp32 as in the
// TPU kernel.  The relative-position bias and the mask are fp32.
// The tiles are the per-layer chain's own device code (gemm_f32.cuh,
// gemm_i8.cuh, layer_norm.cuh, attention.cuh) at the same tile shapes,
// which is what makes a group with fp32 x equal to L calls of the chain.
//
// Barrier: a counter in device memory that each block's thread 0 bumps
// after a __threadfence and then waits on; valid because the cooperative
// launch guarantees every block is resident.  Every block reaches every
// barrier: no thread leaves the kernel early.  The workspace is read with
// plain loads (no __restrict__, no read-only cache): other blocks wrote it
// earlier in the same launch.
// Bound: operations, L x the per-layer bound, on CUDA cores (fp32 FMA and
// __dp4a); wgmma/TMA are a later PR's work.
#include <algorithm>
#include <type_traits>

#include "attention.cuh"
#include "gemm_f32.cuh"
#include "gemm_i8.cuh"
#include "layer_norm.cuh"

namespace repro_torch {

constexpr int LG_THREADS = 256;

struct LayerGroupArgs {
  const void* x;                  // (R, D) in XT
  void* out;                      // (R, D) in XT
  // (L, ...) stacks: WT in the float kernel, int8 in the int8 kernel.
  const void *wq, *wk, *wv, *wmsa, *wup, *wdown;
  // int8 only: act (L, 4) and the weight scales (L, H*Dh) / (L, D) / (L, M).
  const float *act, *wq_s, *wk_s, *wv_s, *wmsa_s, *wup_s, *wdown_s;
  const void *ln1w, *ln1b, *ln2w, *ln2b, *bup, *bdown;   // WT
  const float *bias, *mask;       // (L, H, N, N) and (nW, N, N), or null
  // workspace; z, sa and hid are int8 in the int8 kernel
  void* z;
  float *q, *k, *v;
  void* sa;
  float* h1;
  void* hid;
  float* carry;                   // y between layers, fp32
  unsigned int* bar;
  int B, N, D, H, Dh, M, L, nW;
  float scale, eps;
};

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ void grid_barrier(unsigned int* bar,
                                             unsigned int& target) {
  target += gridDim.x;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    while (*reinterpret_cast<volatile unsigned int*>(bar) < target) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ void prefetch_l2(const void* p, size_t bytes) {
  const char* c = static_cast<const char*>(p);
  const size_t step = (size_t)gridDim.x * blockDim.x * 128;
  for (size_t off = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 128;
       off < bytes; off += step)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(c + off));
}

// Stage 4 of layer l, tile t: h1 = y + SA . w_msa[l], with y of type YT
// (x's type at layer 0, the fp32 carry after it).
template <bool I8, typename WT, typename W, typename YT>
__device__ __forceinline__ void concat_tile(const LayerGroupArgs& a,
                                            unsigned char* smem, int t, int nt,
                                            const W* wmsa, const YT* y,
                                            const float* act, int l) {
  const int R = a.B * a.N, HD = a.H * a.Dh, D = a.D;
  if constexpr (I8)
    gemm_i8_tile(*reinterpret_cast<GemmI8Smem*>(smem), t / nt, t % nt,
                 static_cast<const int8_t*>(a.sa), HD, wmsa, D, D, 0, a.h1, D, 1,
                 R, D, HD, act + 1, a.wmsa_s + (size_t)l * D,
                 static_cast<const WT*>(nullptr), y, D, 0, nullptr);
  else
    gemm_f32_tile(*reinterpret_cast<GemmF32Smem*>(smem), t / nt, t % nt,
                  static_cast<const float*>(a.sa), HD, wmsa, D, D, 0, a.h1, D,
                  R, D, HD, static_cast<const WT*>(nullptr), y, D, 0);
}

// Stage 7 of layer l, tile t: y' = h1 + hid . w_down[l] + b_down[l] into
// `dst` of type OT (the fp32 carry, or out in x's type at the last layer).
template <bool I8, typename WT, typename W, typename OT>
__device__ __forceinline__ void down_tile(const LayerGroupArgs& a,
                                          unsigned char* smem, int t, int nt,
                                          const W* wdown, OT* dst,
                                          const float* act, int l) {
  const int R = a.B * a.N, D = a.D, M = a.M;
  const WT* bdown = static_cast<const WT*>(a.bdown) + (size_t)l * D;
  if constexpr (I8)
    gemm_i8_tile(*reinterpret_cast<GemmI8Smem*>(smem), t / nt, t % nt,
                 static_cast<const int8_t*>(a.hid), M, wdown, D, D, 0, dst, D, 1,
                 R, D, M, act + 3, a.wdown_s + (size_t)l * D, bdown, a.h1, D, 0,
                 nullptr);
  else
    gemm_f32_tile(*reinterpret_cast<GemmF32Smem*>(smem), t / nt, t % nt,
                  static_cast<const float*>(a.hid), M, wdown, D, D, 0, dst, D,
                  R, D, M, bdown, a.h1, D, 0);
}

template <bool I8, typename XT, typename WT>
__device__ __forceinline__ void layer_group_body(const LayerGroupArgs& a,
                                                 unsigned char* smem) {
  using W = typename std::conditional<I8, int8_t, WT>::type;
  GemmF32Smem& gf = *reinterpret_cast<GemmF32Smem*>(smem);
  GemmI8Smem& gi = *reinterpret_cast<GemmI8Smem*>(smem);
  const int R = a.B * a.N, HD = a.H * a.Dh, D = a.D, M = a.M, N = a.N;
  const int warps = blockDim.x / 32;
  const int gwarp = blockIdx.x * warps + threadIdx.x / 32;
  const int nwarps = gridDim.x * warps;
  const int mt = cdiv(R, GF_BM);  // GF_BM == GI_BM
  const size_t qkv_sz = (size_t)a.H * D * a.Dh, msa_sz = (size_t)HD * D,
               mlp_sz = (size_t)D * M;
  const XT* x = static_cast<const XT*>(a.x);
  const WT* ln1w = static_cast<const WT*>(a.ln1w);
  const WT* ln1b = static_cast<const WT*>(a.ln1b);
  const WT* ln2w = static_cast<const WT*>(a.ln2w);
  const WT* ln2b = static_cast<const WT*>(a.ln2b);
  const WT* bup = static_cast<const WT*>(a.bup);
  unsigned int target = 0;
  for (int l = 0; l < a.L; ++l) {
    const W* wq = static_cast<const W*>(a.wq) + l * qkv_sz;
    const W* wk = static_cast<const W*>(a.wk) + l * qkv_sz;
    const W* wv = static_cast<const W*>(a.wv) + l * qkv_sz;
    const W* wmsa = static_cast<const W*>(a.wmsa) + l * msa_sz;
    const W* wup = static_cast<const W*>(a.wup) + l * mlp_sz;
    const W* wdown = static_cast<const W*>(a.wdown) + l * mlp_sz;
    const float* act = I8 ? a.act + 4 * l : nullptr;
    const float* bias = a.bias ? a.bias + (size_t)l * a.H * N * N : nullptr;

    // 1. LN1(y) -> z, y = x at layer 0, else the carry
    for (int r = gwarp; r < R; r += nwarps) {
      if (l == 0)
        layer_norm_row(x, ln1w + l * D, ln1b + l * D, a.z, r, D, a.eps,
                       I8 ? act : nullptr);
      else
        layer_norm_row(static_cast<const float*>(a.carry), ln1w + l * D,
                       ln1b + l * D, a.z, r, D, a.eps, I8 ? act : nullptr);
    }
    grid_barrier(a.bar, target);

    // 2. Q, K, V
    {
      const int nt = cdiv(HD, GF_BN), per = mt * nt;
      for (int t = blockIdx.x; t < 3 * per; t += gridDim.x) {
        const int which = t / per, r = t % per;
        const W* w = which == 0 ? wq : which == 1 ? wk : wv;
        float* o = which == 0 ? a.q : which == 1 ? a.k : a.v;
        if constexpr (I8) {
          const float* ws = (which == 0 ? a.wq_s : which == 1 ? a.wk_s : a.wv_s) +
                            (size_t)l * HD;
          gemm_i8_tile(gi, r / nt, r % nt, static_cast<const int8_t*>(a.z), D, w,
                       a.Dh, a.Dh, (long long)D * a.Dh, o, HD, 1, R, HD, D, act,
                       ws, static_cast<const WT*>(nullptr), nullptr, HD, 0,
                       nullptr);
        } else {
          gemm_f32_tile(gf, r / nt, r % nt, static_cast<const float*>(a.z), D, w,
                        a.Dh, a.Dh, (long long)D * a.Dh, o, HD, R, HD, D,
                        static_cast<const WT*>(nullptr),
                        static_cast<const float*>(nullptr), HD, 0);
        }
      }
    }
    grid_barrier(a.bar, target);

    // 3. attention per (image, head, query tile)
    {
      const int qt = cdiv(N, ATT_QTILE), items = a.B * a.H * qt;
      const long long sb = (long long)N * HD;
      for (int t = blockIdx.x; t < items; t += gridDim.x) {
        const int b = t / (a.H * qt), h = (t / qt) % a.H, qi = t % qt;
        attention_tile(reinterpret_cast<float*>(smem), a.q, a.k, a.v, sb, HD,
                       a.Dh, a.sa, sb, HD, a.Dh, N, a.Dh, a.scale,
                       I8 ? act + 1 : nullptr, bias, a.mask, a.nW, qi, h, b);
      }
    }
    grid_barrier(a.bar, target);

    // 4. h1 = y + SA . w_msa[l]
    {
      const int nt = cdiv(D, GF_BN);
      for (int t = blockIdx.x; t < mt * nt; t += gridDim.x) {
        if (l == 0)
          concat_tile<I8, WT>(a, smem, t, nt, wmsa, x, act, l);
        else
          concat_tile<I8, WT>(a, smem, t, nt, wmsa,
                              static_cast<const float*>(a.carry), act, l);
      }
    }
    grid_barrier(a.bar, target);

    // 5. LN2(h1) -> z
    for (int r = gwarp; r < R; r += nwarps)
      layer_norm_row(static_cast<const float*>(a.h1), ln2w + l * D,
                     ln2b + l * D, a.z, r, D, a.eps, I8 ? act + 2 : nullptr);
    grid_barrier(a.bar, target);

    // 6. hid = gelu(z . w_up[l] + b_up[l]), next layer's weights into L2
    if (l + 1 < a.L) {
      prefetch_l2(wq + qkv_sz, qkv_sz * sizeof(W));
      prefetch_l2(wk + qkv_sz, qkv_sz * sizeof(W));
      prefetch_l2(wv + qkv_sz, qkv_sz * sizeof(W));
      prefetch_l2(wmsa + msa_sz, msa_sz * sizeof(W));
    }
    {
      const int nt = cdiv(M, GF_BN);
      for (int t = blockIdx.x; t < mt * nt; t += gridDim.x) {
        if constexpr (I8)
          gemm_i8_tile(gi, t / nt, t % nt, static_cast<const int8_t*>(a.z), D,
                       wup, M, M, 0, a.hid, M, 2, R, M, D, act + 2,
                       a.wup_s + (size_t)l * M, bup + (size_t)l * M, nullptr, M,
                       1, act + 3);
        else
          gemm_f32_tile(gf, t / nt, t % nt, static_cast<const float*>(a.z), D,
                        wup, M, M, 0, static_cast<float*>(a.hid), M, R, M, D,
                        bup + (size_t)l * M, static_cast<const float*>(nullptr),
                        M, 1);
      }
    }
    grid_barrier(a.bar, target);

    // 7. y = h1 + hid . w_down[l] + b_down[l]: into the carry, or rounded
    //    once into out at the last layer
    {
      const int nt = cdiv(D, GF_BN);
      for (int t = blockIdx.x; t < mt * nt; t += gridDim.x) {
        if (l + 1 < a.L)
          down_tile<I8, WT>(a, smem, t, nt, wdown, a.carry, act, l);
        else
          down_tile<I8, WT>(a, smem, t, nt, wdown, static_cast<XT*>(a.out),
                            act, l);
      }
    }
    if (l + 1 < a.L) grid_barrier(a.bar, target);
  }
}

template <typename XT, typename WT>
__global__ void __launch_bounds__(LG_THREADS)
vita_layer_group_kernel(LayerGroupArgs a) {
  extern __shared__ __align__(16) unsigned char lg_smem[];
  layer_group_body<false, XT, WT>(a, lg_smem);
}

template <typename VT>
__global__ void __launch_bounds__(LG_THREADS)
vita_layer_group_int8_kernel(LayerGroupArgs a) {
  extern __shared__ __align__(16) unsigned char lg_smem[];
  layer_group_body<true, float, VT>(a, lg_smem);
}

// Grid: as many blocks as fit on the card at once with this shared memory,
// and no more than the widest stage has work items.
static int launch_group(const void* kernel, LayerGroupArgs& a, bool i8,
                        cudaStream_t stream) {
  const size_t tile = i8 ? sizeof(GemmI8Smem) : sizeof(GemmF32Smem);
  const size_t att = sizeof(float) * attention_smem_floats(a.N, a.Dh);
  const size_t smem = tile > att ? tile : att;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, LG_THREADS,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int R = a.B * a.N, mt = (R + GF_BM - 1) / GF_BM, HD = a.H * a.Dh;
  int work = 3 * mt * ((HD + GF_BN - 1) / GF_BN);
  work = std::max(work, a.B * a.H * ((a.N + ATT_QTILE - 1) / ATT_QTILE));
  work = std::max(work, mt * ((a.M + GF_BN - 1) / GF_BN));
  work = std::max(work, mt * ((a.D + GF_BN - 1) / GF_BN));
  work = std::max(work, (R + LG_THREADS / 32 - 1) / (LG_THREADS / 32));
  const int blocks = std::min(per_sm * sms, work);
  err = cudaMemsetAsync(a.bar, 0, sizeof(unsigned int), stream);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(LG_THREADS), args,
                                    smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// Float group: x and out in xt, the weights (L, ...), LN vectors and
// biases in wt (ElemCodes; `dispatch_mode`); ws_* are the workspace views
// z (R, D), q/k/v/sa (R, H*Dh), h1 (R, D), hid (R, M), carry (R, D)
// float32 with R = B*N, and bar one uint32.
extern "C" int rt_vita_layer_group(
    const void* x, const void* wq, const void* wk, const void* wv,
    const void* wmsa, const void* ln1w, const void* ln1b, const void* ln2w,
    const void* ln2b, const void* wup, const void* bup, const void* wdown,
    const void* bdown, const float* bias, const float* mask, void* out,
    void* z, float* q, float* k, float* v, void* sa, float* h1, void* hid,
    float* carry, unsigned int* bar, int B, int N, int D, int H, int Dh, int M,
    int L, int nW, float scale, float eps, int xt, int wt, void* stream) {
  using namespace repro_torch;
  LayerGroupArgs a{x, out, wq, wk, wv, wmsa, wup, wdown,
                   nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                   ln1w, ln1b, ln2w, ln2b, bup, bdown, bias, mask,
                   z, q, k, v, sa, h1, hid, carry, bar, B, N, D, H, Dh, M, L, nW,
                   scale, eps};
  return dispatch_mode(xt, wt, [&](auto xtag, auto wtag) {
    using XT = typename decltype(xtag)::type;
    using WT = typename decltype(wtag)::type;
    return launch_group((const void*)vita_layer_group_kernel<XT, WT>, a, false,
                        (cudaStream_t)stream);
  });
}

// int8 group: x and out float32; weights (L, ...) int8; act (L, 4); weight
// scales (L, H*Dh) for Q/K/V, (L, D) for w_msa and w_down, (L, M) for
// w_up; LN vectors and biases in vt (float32 or bf16).  Workspace as above
// but z (R, D), sa (R, H*Dh) and hid (R, M) int8.
extern "C" int rt_vita_layer_group_int8(
    const float* x, const int8_t* wq, const int8_t* wk, const int8_t* wv,
    const int8_t* wmsa, const int8_t* wup, const int8_t* wdown, const float* act,
    const float* wq_s, const float* wk_s, const float* wv_s, const float* wmsa_s,
    const float* wup_s, const float* wdown_s, const void* ln1w, const void* ln1b,
    const void* ln2w, const void* ln2b, const void* bup, const void* bdown,
    const float* bias, const float* mask, float* out, void* z, float* q, float* k,
    float* v, void* sa, float* h1, void* hid, float* carry, unsigned int* bar,
    int B, int N, int D, int H, int Dh, int M, int L, int nW, float scale,
    float eps, int vt, void* stream) {
  using namespace repro_torch;
  LayerGroupArgs a{x, out, wq, wk, wv, wmsa, wup, wdown,
                   act, wq_s, wk_s, wv_s, wmsa_s, wup_s, wdown_s,
                   ln1w, ln1b, ln2w, ln2b, bup, bdown, bias, mask,
                   z, q, k, v, sa, h1, hid, carry, bar, B, N, D, H, Dh, M, L, nW,
                   scale, eps};
  return dispatch_type(vt, [&](auto vtag) {
    using VT = typename decltype(vtag)::type;
    return launch_group((const void*)vita_layer_group_int8_kernel<VT>, a, true,
                        (cudaStream_t)stream);
  });
}

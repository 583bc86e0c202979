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
//   3. SA = attention per (image, head, query tile)
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
// the per-layer kernels, each of which rounds its output; with fp32 x it
// is, bit for bit.)  The wrapper allocates the workspace z, q, k, v, sa,
// h1, hid, carry and the barrier counter in one buffer; at DeiT-T batch 8
// it is ~13 MB and stays in L2.
//
// The float kernel (kernel 7) runs kernel 1's own tiles in kernel 1's
// order, on the tensor cores, 512 threads a block: stages 2 and 3 are the
// MSA tile's projection and attention (msa_tile.cuh) per (image, head,
// 64-row slice), the projection writing Q, K and V (fp32, as LN1's z) to
// the workspace and the attention staging K and V of all N rows back by
// 16-byte cp.async into the buffers the tile's plan lays out (no cluster:
// each K and V row was projected once, in stage 2, and a cooperative
// launch with a cluster dimension is not needed); stages 4, 6 and 7 are
// mma_gemm.cuh's split-TF32 tile at kernel 1's 32 x 64 shape with kernel
// 1's epilogues.  So with fp32 x a float group equals L calls of
// `vita_layer` bit for bit.  The stage-2-to-3 round trip of Q, K and V
// through the workspace (L2-resident) is what the group pays for having no
// cluster; kernels/vita_layer_group.py::group_plan gives the grid, the
// shared memory (the MSA tile's layout, which the GEMM ring fits inside)
// and each stage's tiles and waves.  The weights and LN vectors are WT
// (float or bf16: bf16 weights enter the products exactly, in two TF32
// passes); every workspace buffer is fp32.  Where the MSA plan is paged
// (Dh 65-128, or N whose K and V pass a block's shared memory), kernel 1
// projects and then runs the attention tile of attention.cuh, and so does
// stage 3 here: one (image, head, 32-query slice) an item, on the block's
// first 256 threads (the tile is 8 warps; the other half waits), K and V
// paged from the workspace.  Every paged plan runs on a kernel of its
// own (DP = LG_PAGED), with its DP 128 projection and its attention items
// out of line, so the cluster plans' kernels are what they were.
//
// The int8 kernel (kernel 8) runs the per-layer int8 chain's tiles, 256
// threads a block: its four GEMM stages are kernel 4's int8 tensor-core
// tile (mma_gemm_i8.cuh, `i8_epilogue`), its attention stage attention.cuh's
// `attention_tile` (split TF32 on the tensor cores) at the same layout, as
// kernels 2 and 3 run them, so an int8 group equals L calls of
// `vita_layer_int8` bit for bit (the int32 sums are exact in any order, and
// the attention tile's order is the tile's own).  A GEMM stage runs one KG
// = 2 tile a block (all eight warps, the 4-stage ring) where its tiles fit
// the grid in one round, else two KG = 1 tiles a block, one on each half of
// the warps, each on a 2-stage ring of its own and a named barrier: either
// way the ring set is 68 KB, so the block's shared memory is the larger of
// that and the attention tile's layout (105 KB at DeiT-T: two blocks an
// SM).
// kernels/vita_layer_group.py::int8_group_plan gives the grid, the shared
// memory, each stage's tiles, k groups, copy widths and waves, and the
// attention tile's layout (`vita_msa.attention_plan`).
//
// Barrier: a counter in device memory that each block's thread 0 bumps
// after a __threadfence and then waits on; valid because the cooperative
// launch guarantees every block is resident.  Every block reaches every
// barrier: no thread leaves the kernel early.  The workspace is read with
// plain loads or cp.async (no __restrict__, no read-only cache): other
// blocks wrote it earlier in the same launch.
// Bound: operations, L x the per-layer bound (split-TF32 mma.sync in the
// float kernel; int8 mma.sync for the products and split-TF32 mma.sync
// for the attention in the int8 one); wgmma/TMA are a later PR's work.
#include <algorithm>
#include <cstring>
#include <type_traits>

#include "attention.cuh"
#include "layer_norm.cuh"
#include "mma_gemm.cuh"
#include "mma_gemm_i8.cuh"
#include "msa_tile.cuh"

namespace repro_torch {

static_assert(MSA_THREADS == MG_THREADS, "the float group's block runs both");
constexpr int LG_THREADS = MSA_THREADS, LG_I8_THREADS = 256;

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

// The float kernel's launch plan, field for field
// kernels/vita_layer_group.py::GroupPlan.launch_ints(): the MSA tile's
// layout (on fp32 z), the attention tile's (read where the MSA layout is
// paged), the grid and the dynamic shared memory a block.
struct GroupLayout {
  MsaLayout msa;
  AttLayout att;
  int grid, smem;
};
static_assert(sizeof(GroupLayout) == 29 * sizeof(int), "plan is 29 ints");

// The float kernel's parameters: the operands, the plan, and per stage
// whether its operands' rows are 16-byte aligned (`vecs` of msa_project
// and mma_gemm_tile; `att`: Q, K and V rows in the workspace).
struct FloatGroupArgs {
  LayerGroupArgs a;
  GroupLayout p;
  int v_proj, v_att, v_concat, v_up, v_down;
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

// ---------------------------------------------------------------------------
// Kernel 7: the float group on kernel 1's tensor-core tiles
// ---------------------------------------------------------------------------

// Stage 2's tile t of layer l: Q, K and V of (image, head, 64-row slice)
// by the MSA tile's projection, written to the workspace.
template <typename WT, int DP>
__device__ __forceinline__ void float_project_slice(
    unsigned char* smem, int t, int l, const FloatGroupArgs& f) {
  const LayerGroupArgs& a = f.a;
  const int N = a.N, D = a.D, H = a.H, Dh = a.Dh, C = f.p.msa.cluster;
  const long long HD = (long long)H * Dh;
  const size_t qkv_sz = (size_t)H * D * Dh;
  const int b = t / (H * C), h = (t / C) % H, row0 = (t % C) * MSA_ROWS;
  float* const qkv[3] = {a.q, a.k, a.v};
  msa_project<float, WT, DP>(
      smem, f.p.msa, static_cast<const float*>(a.z),
      static_cast<const WT*>(a.wq) + l * qkv_sz,
      static_cast<const WT*>(a.wk) + l * qkv_sz,
      static_cast<const WT*>(a.wv) + l * qkv_sz,
      static_cast<const WT*>(nullptr), N, D, H, Dh, f.v_proj, h, b, row0,
      [&](int part, int r, int col, float v) {
        const int n = row0 + r;
        if (n < N && col < Dh)
          qkv[part][((long long)b * N + n) * HD + h * Dh + col] = v;
      });
}

// The DP 128 projection of a paged plan, out of line.
template <typename WT>
__device__ __noinline__ void float_project_wide(unsigned char* smem, int t,
                                                int l,
                                                const FloatGroupArgs* f) {
  float_project_slice<WT, 128>(smem, t, l, *f);
}

// Stage 3's item t of layer l under a paged plan: the attention tile (as
// kernel 1's attention launch runs it) per (image, head, 32-query slice)
// on Q, K and V of the workspace, run by the block's first ATT_THREADS
// threads.  Out of line, as kernel 8's.
template <int DP>
__device__ __noinline__ void float_attention_item(unsigned char* smem, int t,
                                                  int l,
                                                  const FloatGroupArgs* f) {
  const LayerGroupArgs& a = f->a;
  const int N = a.N, HD = a.H * a.Dh, qt = cdiv(N, ATT_ROWS);
  const long long sb = (long long)N * HD;
  const float* bias = a.bias ? a.bias + (size_t)l * a.H * N * N : nullptr;
  attention_tile<DP, false, BlockPart<ATT_THREADS>>(
      smem, f->p.att, a.q, a.k, a.v, sb, HD, a.Dh, f->v_att != 0, a.sa, sb,
      HD, a.Dh, N, a.Dh, a.scale, nullptr, bias, a.mask, a.nW, t % qt,
      (t / qt) % a.H, t / (a.H * qt));
}

// The kernel DP that stands for every paged plan (its stages take the
// plan's DP at run time).
constexpr int LG_PAGED = 0;

template <typename XT, typename WT, int DP>
__device__ __forceinline__ void float_group_body(const FloatGroupArgs& f,
                                                 unsigned char* smem) {
  const LayerGroupArgs& a = f.a;
  const MsaLayout& L = f.p.msa;
  const int R = a.B * a.N, HD = a.H * a.Dh, D = a.D, M = a.M, N = a.N;
  const int H = a.H, Dh = a.Dh;
  const int warps = blockDim.x / 32;
  const int gwarp = blockIdx.x * warps + threadIdx.x / 32;
  const int nwarps = gridDim.x * warps;
  const int C = L.cluster, slices = a.B * H * C;   // (image, head, 64 rows)
  // Paged plans (kernel DP LG_PAGED) run the projection, then the
  // attention tile, as kernel 1 does for them.
  constexpr bool PAGED = DP == LG_PAGED;
  const int mt = cdiv(R, MG_BM), ntd = cdiv(D, MG_BN), ntm = cdiv(M, MG_BN);
  const size_t qkv_sz = (size_t)H * D * Dh, msa_sz = (size_t)HD * D,
               mlp_sz = (size_t)D * M;
  const XT* x = static_cast<const XT*>(a.x);
  const WT* ln1w = static_cast<const WT*>(a.ln1w);
  const WT* ln1b = static_cast<const WT*>(a.ln1b);
  const WT* ln2w = static_cast<const WT*>(a.ln2w);
  const WT* ln2b = static_cast<const WT*>(a.ln2b);
  const WT* bup = static_cast<const WT*>(a.bup);
  const WT* bdown = static_cast<const WT*>(a.bdown);
  float* z = static_cast<float*>(a.z);
  float* sa = static_cast<float*>(a.sa);
  float* hid = static_cast<float*>(a.hid);
  unsigned int target = 0;
  for (int l = 0; l < a.L; ++l) {
    const WT* wq = static_cast<const WT*>(a.wq) + l * qkv_sz;
    const WT* wk = static_cast<const WT*>(a.wk) + l * qkv_sz;
    const WT* wv = static_cast<const WT*>(a.wv) + l * qkv_sz;
    const WT* wmsa = static_cast<const WT*>(a.wmsa) + l * msa_sz;
    const WT* wup = static_cast<const WT*>(a.wup) + l * mlp_sz;
    const WT* wdown = static_cast<const WT*>(a.wdown) + l * mlp_sz;
    const float* bias = a.bias ? a.bias + (size_t)l * H * N * N : nullptr;

    // 1. LN1(y) -> z, y = x at layer 0, else the carry
    for (int r = gwarp; r < R; r += nwarps) {
      if (l == 0)
        layer_norm_row(x, ln1w + l * D, ln1b + l * D, z, r, D, a.eps,
                       nullptr);
      else
        layer_norm_row(static_cast<const float*>(a.carry), ln1w + l * D,
                       ln1b + l * D, z, r, D, a.eps, nullptr);
    }
    grid_barrier(a.bar, target);

    // 2. Q, K, V of each (image, head, 64-row slice): the MSA tile's
    //    projection, its rows written to the workspace
    for (int t = blockIdx.x; t < slices; t += gridDim.x) {
      if constexpr (PAGED) {
        if (L.dp == 128)
          float_project_wide<WT>(smem, t, l, &f);
        else
          float_project_slice<WT, 64>(smem, t, l, f);
      } else {
        float_project_slice<WT, DP>(smem, t, l, f);
      }
    }
    grid_barrier(a.bar, target);

    // 3. SA.  Paged plan: the attention tile per (image, head, 32-query
    //    slice), paging K and V from the workspace.  Cluster plan: per
    //    (image, head, 64-row slice), Q of the slice and K, V of all N rows
    //    (zero past N and Dh) into the tile's buffers, then the MSA tile's
    //    attention.
    if constexpr (PAGED) {
      const int items = a.B * H * cdiv(N, ATT_ROWS), adp = f.p.att.dp;
      for (int t = blockIdx.x; t < items; t += gridDim.x) {
        if (threadIdx.x < ATT_THREADS) {
          if (adp == 32)
            float_attention_item<32>(smem, t, l, &f);
          else if (adp == 64)
            float_attention_item<64>(smem, t, l, &f);
          else
            float_attention_item<128>(smem, t, l, &f);
        }
        __syncthreads();
      }
    } else {
      for (int t = blockIdx.x; t < slices; t += gridDim.x) {
        const int b = t / (H * C), h = (t / C) % H,
                  row0 = (t % C) * MSA_ROWS;
        const long long base = (long long)b * N * HD + (long long)h * Dh;
        const bool vec = f.v_att;
        load_tile<float, LG_THREADS>(smem + L.q_off, (DP + 8) * 4,
                                     a.q + base, HD, row0, N, 0, Dh,
                                     MSA_ROWS, DP, vec);
        load_tile<float, LG_THREADS>(smem + L.k_off, (DP + 8) * 4,
                                     a.k + base, HD, 0, N, 0, Dh, L.nk, DP,
                                     vec);
        load_tile<float, LG_THREADS>(smem + L.v_off, (DP + 4) * 4,
                                     a.v + base, HD, 0, N, 0, Dh, L.nk, DP,
                                     vec);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        msa_attend<float, DP>(smem, L, bias, a.mask, a.nW, sa,
                              (long long)N * HD, HD, Dh, N, Dh, a.scale, h,
                              b, row0);
      }
    }
    grid_barrier(a.bar, target);

    // 4. h1 = y + SA . w_msa[l]
    for (int t = blockIdx.x; t < mt * ntd; t += gridDim.x) {
      if (l == 0)
        mma_gemm_tile<WT, XT, float>(smem, t / ntd, t % ntd, sa, HD, wmsa, D,
                                     a.h1, D, R, D, HD,
                                     static_cast<const WT*>(nullptr), x, D,
                                     0, f.v_concat);
      else
        mma_gemm_tile<WT, float, float>(
            smem, t / ntd, t % ntd, sa, HD, wmsa, D, a.h1, D, R, D, HD,
            static_cast<const WT*>(nullptr), a.carry, D, 0, f.v_concat);
      __syncthreads();
    }
    grid_barrier(a.bar, target);

    // 5. LN2(h1) -> z
    for (int r = gwarp; r < R; r += nwarps)
      layer_norm_row(static_cast<const float*>(a.h1), ln2w + l * D,
                     ln2b + l * D, z, r, D, a.eps, nullptr);
    grid_barrier(a.bar, target);

    // 6. hid = gelu(z . w_up[l] + b_up[l]), next layer's weights into L2
    if (l + 1 < a.L) {
      prefetch_l2(wq + qkv_sz, qkv_sz * sizeof(WT));
      prefetch_l2(wk + qkv_sz, qkv_sz * sizeof(WT));
      prefetch_l2(wv + qkv_sz, qkv_sz * sizeof(WT));
      prefetch_l2(wmsa + msa_sz, msa_sz * sizeof(WT));
    }
    for (int t = blockIdx.x; t < mt * ntm; t += gridDim.x) {
      mma_gemm_tile<WT, float, float>(smem, t / ntm, t % ntm, z, D, wup, M,
                                      hid, M, R, M, D, bup + (size_t)l * M,
                                      static_cast<const float*>(nullptr), M,
                                      1, f.v_up);
      __syncthreads();
    }
    grid_barrier(a.bar, target);

    // 7. y = h1 + hid . w_down[l] + b_down[l]: into the carry, or rounded
    //    once into out at the last layer
    for (int t = blockIdx.x; t < mt * ntd; t += gridDim.x) {
      if (l + 1 < a.L)
        mma_gemm_tile<WT, float, float>(smem, t / ntd, t % ntd, hid, M, wdown,
                                        D, a.carry, D, R, D, M,
                                        bdown + (size_t)l * D, a.h1, D, 0,
                                        f.v_down);
      else
        mma_gemm_tile<WT, float, XT>(smem, t / ntd, t % ntd, hid, M, wdown, D,
                                     static_cast<XT*>(a.out), D, R, D, M,
                                     bdown + (size_t)l * D, a.h1, D, 0,
                                     f.v_down);
      __syncthreads();
    }
    if (l + 1 < a.L) grid_barrier(a.bar, target);
  }
}

template <typename XT, typename WT, int DP>
__global__ void __launch_bounds__(LG_THREADS, 1)
vita_layer_group_kernel(const __grid_constant__ FloatGroupArgs f) {
  extern __shared__ __align__(16) unsigned char lg_smem[];
  float_group_body<XT, WT, DP>(f, lg_smem);
}

// ---------------------------------------------------------------------------
// Kernel 8: the int8 group on the int8 chain's tiles
// ---------------------------------------------------------------------------

constexpr int LG_I8_HALF = LG_I8_THREADS / 2, LG_I8_HALF_STAGES = 2;
static_assert(MiTile<2>::THREADS == LG_I8_THREADS &&
                  MiTile<1>::THREADS == LG_I8_HALF,
              "a KG = 2 tile takes the block, a KG = 1 tile half of it");
constexpr int LG_I8_RING =
    MiTile<2>::SMEM > 2 * MiTile<1, LG_I8_HALF_STAGES>::SMEM
        ? MiTile<2>::SMEM
        : 2 * MiTile<1, LG_I8_HALF_STAGES>::SMEM;

// The int8 kernel's launch plan, field for field
// kernels/vita_layer_group.py::Int8GroupPlan.launch_ints(): the grid, the
// dynamic shared memory a block, per GEMM stage (Q/K/V, concat, up, down)
// its k groups (2: one KG = 2 tile a block; 1: two KG = 1 tiles a block)
// and A's and B's copy widths in bytes.
// Then the attention tile's layout.
struct I8GroupLayout {
  int grid, smem;
  int st[4][3];
  AttLayout att;
};
static_assert(sizeof(I8GroupLayout) == 26 * sizeof(int), "plan is 26 ints");

// The int8 kernel's parameters: the operands, the plan, and whether Q, K
// and V rows in the workspace take the attention tile's cp.async copies.
struct Int8GroupArgs {
  LayerGroupArgs a;
  I8GroupLayout p;
  int v_att;
};

// Tile t of GEMM stage GI of layer l (0: Q/K/V, the (L, H, D, Dh) stacks
// read in place; 1: h1 = y + SA . w_msa[l]; 2: hid = gelu(z . w_up[l] +
// b_up[l]) in int8; 3: y = h1 + hid . w_down[l] + b_down[l], into the
// carry, or into out at the last layer) on Part's threads.  One function
// per (stage, k groups), out of line: each folds its stage's epilogue
// and reads its operands from the kernel's argument (grid constant) when
// it needs them, so it holds the registers of one tile, and the kernel is
// eight such functions rather than one function of eight inlined tiles
// (a build several minutes long).
template <int GI, int KG, int STAGES, typename Part, typename VT>
__device__ __noinline__ void i8_gemm_tile(unsigned char* smem, int t, int l,
                                          const Int8GroupArgs* ga) {
  const LayerGroupArgs& a = ga->a;
  const int R = a.B * a.N, HD = a.H * a.Dh, D = a.D, M = a.M;
  const int aw = ga->p.st[GI][1], bw = ga->p.st[GI][2];
  constexpr int BN = MiTile<KG>::BN;
  const float* act = a.act + 4 * l;
  const VT* no_bias = nullptr;
  if constexpr (GI == 0) {
    const int nt_q = cdiv(HD, BN), per = cdiv(R, MiTile<KG>::BM) * nt_q;
    const int which = t / per, r = t % per;
    const void* w = which == 0 ? a.wq : which == 1 ? a.wk : a.wv;
    const float* ws = which == 0 ? a.wq_s : which == 1 ? a.wk_s : a.wv_s;
    mma_gemm_i8_tile<KG, STAGES, Part>(
        smem, r / nt_q, r % nt_q, static_cast<const int8_t*>(a.z), D,
        static_cast<const int8_t*>(w) + (size_t)l * a.H * D * a.Dh, a.Dh,
        a.Dh, (long long)D * a.Dh, which == 0 ? a.q : which == 1 ? a.k : a.v,
        HD, 1, R, HD, D, act, ws + (size_t)l * HD, no_bias, nullptr, HD, 0,
        nullptr, aw, bw);
  } else if constexpr (GI == 1) {
    const int nt_d = cdiv(D, BN);
    mma_gemm_i8_tile<KG, STAGES, Part>(
        smem, t / nt_d, t % nt_d, static_cast<const int8_t*>(a.sa), HD,
        static_cast<const int8_t*>(a.wmsa) + (size_t)l * HD * D, D, D, 0,
        a.h1, D, 1, R, D, HD, act + 1, a.wmsa_s + (size_t)l * D, no_bias,
        l == 0 ? static_cast<const float*>(a.x) : a.carry, D, 0, nullptr, aw,
        bw);
  } else if constexpr (GI == 2) {
    const int nt_m = cdiv(M, BN);
    mma_gemm_i8_tile<KG, STAGES, Part>(
        smem, t / nt_m, t % nt_m, static_cast<const int8_t*>(a.z), D,
        static_cast<const int8_t*>(a.wup) + (size_t)l * D * M, M, M, 0,
        a.hid, M, 2, R, M, D, act + 2, a.wup_s + (size_t)l * M,
        static_cast<const VT*>(a.bup) + (size_t)l * M,
        static_cast<const float*>(nullptr), M, 1, act + 3, aw, bw);
  } else {
    const int nt_d = cdiv(D, BN);
    mma_gemm_i8_tile<KG, STAGES, Part>(
        smem, t / nt_d, t % nt_d, static_cast<const int8_t*>(a.hid), M,
        static_cast<const int8_t*>(a.wdown) + (size_t)l * M * D, D, D, 0,
        l + 1 < a.L ? a.carry : static_cast<float*>(a.out), D, 1, R, D, M,
        act + 3, a.wdown_s + (size_t)l * D,
        static_cast<const VT*>(a.bdown) + (size_t)l * D, a.h1, D, 0, nullptr,
        aw, bw);
  }
}

// Attention work item t (image, head, 32-query slice) of layer l: the
// attention tile on Q, K and V of the workspace, SA quantised at
// act[l][1].  Out of line, as the GEMM tiles.
template <int DP>
__device__ __noinline__ void i8_attention_item(unsigned char* smem, int t,
                                               int l,
                                               const Int8GroupArgs* ga) {
  const LayerGroupArgs& a = ga->a;
  const int N = a.N, HD = a.H * a.Dh, qt = cdiv(N, ATT_ROWS);
  const long long sb = (long long)N * HD;
  const float* bias = a.bias ? a.bias + (size_t)l * a.H * N * N : nullptr;
  attention_tile<DP>(smem, ga->p.att, a.q, a.k, a.v, sb, HD, a.Dh,
                     ga->v_att != 0, a.sa, sb, HD, a.Dh, N, a.Dh, a.scale,
                     a.act + 4 * l + 1, bias, a.mask, a.nW, t % qt,
                     (t / qt) % a.H, t / (a.H * qt));
}

// The `count` tiles of GEMM stage GI, walked by the grid: with the plan's
// k groups 2 one tile a block a round, else one a half-block a round
// (tiles 2 blockIdx.x and 2 blockIdx.x + 1 first).  The part syncs after
// each tile, so its ring is free for the next.
template <int GI, typename VT>
__device__ __forceinline__ void i8_stage(unsigned char* smem, int count,
                                         int l, const Int8GroupArgs* ga) {
  if (ga->p.st[GI][0] == 2) {
    for (int t = blockIdx.x; t < count; t += gridDim.x) {
      i8_gemm_tile<GI, 2, MI_STAGES, WholeBlock, VT>(smem, t, l, ga);
      __syncthreads();
    }
  } else {
    using Half = BlockPart<LG_I8_HALF>;
    const int half = threadIdx.x / LG_I8_HALF;
    unsigned char* hs = smem + half * MiTile<1, LG_I8_HALF_STAGES>::SMEM;
    for (int t = 2 * blockIdx.x + half; t < count; t += 2 * gridDim.x) {
      i8_gemm_tile<GI, 1, LG_I8_HALF_STAGES, Half, VT>(hs, t, l, ga);
      Half::sync();
    }
  }
}

template <typename VT>
__device__ __forceinline__ void int8_group_body(const Int8GroupArgs* ga,
                                                unsigned char* smem) {
  const LayerGroupArgs& a = ga->a;
  const int R = a.B * a.N, HD = a.H * a.Dh, D = a.D, M = a.M, N = a.N;
  const int warps = blockDim.x / 32;
  const int gwarp = blockIdx.x * warps + threadIdx.x / 32;
  const int nwarps = gridDim.x * warps;
  constexpr int BM = MiTile<1>::BM, BN = MiTile<1>::BN;
  const int mt_r = cdiv(R, BM), nt_d = cdiv(D, BN);
  const size_t qkv_sz = (size_t)a.H * D * a.Dh, msa_sz = (size_t)HD * D;
  const float* x = static_cast<const float*>(a.x);
  const VT* ln1w = static_cast<const VT*>(a.ln1w);
  const VT* ln1b = static_cast<const VT*>(a.ln1b);
  const VT* ln2w = static_cast<const VT*>(a.ln2w);
  const VT* ln2b = static_cast<const VT*>(a.ln2b);
  unsigned int target = 0;
  for (int l = 0; l < a.L; ++l) {
    const float* act = a.act + 4 * l;

    // 1. LN1(y) -> z, y = x at layer 0, else the carry
    for (int r = gwarp; r < R; r += nwarps)
      layer_norm_row(l == 0 ? x : a.carry, ln1w + l * D, ln1b + l * D, a.z,
                     r, D, a.eps, act);
    grid_barrier(a.bar, target);

    // 2. Q, K, V
    i8_stage<0, VT>(smem, 3 * mt_r * cdiv(HD, BN), l, ga);
    grid_barrier(a.bar, target);

    // 3. attention per (image, head, query slice)
    for (int t = blockIdx.x, items = a.B * a.H * cdiv(N, ATT_ROWS);
         t < items; t += gridDim.x) {
      if (ga->p.att.dp == 32)
        i8_attention_item<32>(smem, t, l, ga);
      else if (ga->p.att.dp == 64)
        i8_attention_item<64>(smem, t, l, ga);
      else
        i8_attention_item<128>(smem, t, l, ga);
    }
    grid_barrier(a.bar, target);

    // 4. h1 = y + SA . w_msa[l]
    i8_stage<1, VT>(smem, mt_r * nt_d, l, ga);
    grid_barrier(a.bar, target);

    // 5. LN2(h1) -> z
    for (int r = gwarp; r < R; r += nwarps)
      layer_norm_row(static_cast<const float*>(a.h1), ln2w + l * D,
                     ln2b + l * D, a.z, r, D, a.eps, act + 2);
    grid_barrier(a.bar, target);

    // 6. hid = gelu(z . w_up[l] + b_up[l]), next layer's weights into L2
    if (l + 1 < a.L) {
      const int8_t* const w[4] = {static_cast<const int8_t*>(a.wq),
                                  static_cast<const int8_t*>(a.wk),
                                  static_cast<const int8_t*>(a.wv),
                                  static_cast<const int8_t*>(a.wmsa)};
      for (int i = 0; i < 3; ++i) prefetch_l2(w[i] + (l + 1) * qkv_sz, qkv_sz);
      prefetch_l2(w[3] + (l + 1) * msa_sz, msa_sz);
    }
    i8_stage<2, VT>(smem, mt_r * cdiv(M, BN), l, ga);
    grid_barrier(a.bar, target);

    // 7. y = h1 + hid . w_down[l] + b_down[l]
    i8_stage<3, VT>(smem, mt_r * nt_d, l, ga);
    if (l + 1 < a.L) grid_barrier(a.bar, target);
  }
}

// Two blocks an SM need at most 128 registers a thread.
template <typename VT>
__global__ void __launch_bounds__(LG_I8_THREADS, 2)
vita_layer_group_int8_kernel(const __grid_constant__ Int8GroupArgs a) {
  extern __shared__ __align__(16) unsigned char lg_smem[];
  int8_group_body<VT>(&a, lg_smem);
}

// Blocks of `kernel` that fit on one SM at `threads` and `smem` bytes.
static int blocks_per_sm(const void* kernel, int threads, size_t smem,
                         int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                            threads, smem);
}

// A cooperative launch of `grid` blocks, refused where they do not all fit
// on the card at once.
static int launch_cooperative(const void* kernel, void* args, int grid,
                              int threads, size_t smem, unsigned int* bar,
                              cudaStream_t stream) {
  int per_sm = 0, sms = 0;
  int err = blocks_per_sm(kernel, threads, smem, &per_sm);
  if (err != 0) return err;
  if ((err = sm_count(&sms)) != 0) return err;
  if (grid < 1 || grid > per_sm * sms)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaError_t e = cudaMemsetAsync(bar, 0, sizeof(unsigned int), stream);
  if (e != cudaSuccess) return (int)e;
  void* argv[] = {args};
  e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(threads), argv,
                                  smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The DP of the float kernel that runs MSA layout L: its own for a
// cluster plan, LG_PAGED for every paged plan.
inline int group_kernel_dp(const MsaLayout& L) {
  return L.paged ? LG_PAGED : L.dp;
}

// The float kernel for (xt, wt) (`dispatch_mode`) and the kernel's DP.
template <typename F>
int dispatch_float_group(int xt, int wt, int dp, F&& f) {
  return dispatch_mode(xt, wt, [&](auto xtag, auto wtag) {
    using XT = typename decltype(xtag)::type;
    using WT = typename decltype(wtag)::type;
    if (dp == 32)
      return f((const void*)vita_layer_group_kernel<XT, WT, 32>, wtag);
    if (dp == 64)
      return f((const void*)vita_layer_group_kernel<XT, WT, 64>, wtag);
    if (dp == LG_PAGED)
      return f((const void*)vita_layer_group_kernel<XT, WT, LG_PAGED>,
               wtag);
    return (int)cudaErrorInvalidValue;
  });
}

}  // namespace repro_torch

// Blocks of the float group kernel for (xt, wt, dp) that fit on one SM
// with `smem` bytes of dynamic shared memory, into *per_sm: what
// kernels/vita_layer_group.py sizes the grid by (dp: `group_kernel_dp`).
extern "C" int rt_vita_layer_group_blocks_per_sm(int xt, int wt, int dp,
                                                 int smem, int* per_sm) {
  using namespace repro_torch;
  return dispatch_float_group(xt, wt, dp, [&](const void* kernel, auto) {
    return blocks_per_sm(kernel, LG_THREADS, (size_t)smem, per_sm);
  });
}

// Float group: x and out in xt, the weights (L, ...), LN vectors and
// biases in wt (ElemCodes; `dispatch_mode`); ws_* are the workspace views
// z (R, D), q/k/v/sa (R, H*Dh), h1 (R, D), hid (R, M), carry (R, D)
// float32 with R = B*N, and bar one uint32.  plan: the 29 ints of the
// wrapper's GroupPlan (kernels/vita_layer_group.py::group_plan), refused
// where its MSA layout (or, paged, its attention layout) breaks a limit of
// the tile or its shared memory holds less than the tiles need.
extern "C" int rt_vita_layer_group(
    const void* x, const void* wq, const void* wk, const void* wv,
    const void* wmsa, const void* ln1w, const void* ln1b, const void* ln2w,
    const void* ln2b, const void* wup, const void* bup, const void* wdown,
    const void* bdown, const float* bias, const float* mask, void* out,
    void* z, float* q, float* k, float* v, void* sa, float* h1, void* hid,
    float* carry, unsigned int* bar, int B, int N, int D, int H, int Dh, int M,
    int L, int nW, float scale, float eps, int xt, int wt, const int* plan,
    void* stream) {
  using namespace repro_torch;
  FloatGroupArgs f;
  f.a = LayerGroupArgs{x, out, wq, wk, wv, wmsa, wup, wdown,
                       nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                       nullptr, ln1w, ln1b, ln2w, ln2b, bup, bdown, bias,
                       mask, z, q, k, v, sa, h1, hid, carry, bar, B, N, D, H,
                       Dh, M, L, nW, scale, eps};
  std::memcpy(&f.p, plan, sizeof f.p);
  const MsaLayout& ml = f.p.msa;
  if (!msa_layout_ok(ml, N, Dh) || f.p.smem < ml.smem ||
      f.p.smem > MSA_SMEM_LIMIT ||
      (ml.paged && (!att_layout_ok(f.p.att, N, Dh) ||
                    f.p.smem < f.p.att.smem ||
                    ml.stages * ml.stage > f.p.smem)))
    return (int)cudaErrorInvalidValue;
  const int HD = H * Dh;
  return dispatch_float_group(xt, wt, group_kernel_dp(ml), [&](
                                  const void* kernel, auto wtag) {
    using WT = typename decltype(wtag)::type;
    if (f.p.smem < MgSmem<WT>::BYTES) return (int)cudaErrorInvalidValue;
    constexpr int WV = 16 / (int)sizeof(WT);
    // Rows of whole 16-byte chunks take the tiles' cp.async fast paths.
    f.v_proj = (vec_ok<float>(z, D) ? 1 : 0) |
               (vec_ok<WT>(wq, Dh) && vec_ok<WT>(wk, Dh) && vec_ok<WT>(wv, Dh)
                    ? 2 : 0);
    f.v_att = Dh % 4 == 0 && vec_ok<float>(q, HD) && vec_ok<float>(k, HD) &&
              vec_ok<float>(v, HD);
    f.v_concat = (vec_ok<float>(sa, HD) && HD % 4 == 0 ? 1 : 0) |
                 (vec_ok<WT>(wmsa, D) && D % WV == 0 ? 2 : 0);
    f.v_up = (vec_ok<float>(z, D) && D % 4 == 0 ? 1 : 0) |
             (vec_ok<WT>(wup, M) && M % WV == 0 ? 2 : 0);
    f.v_down = (vec_ok<float>(hid, M) && M % 4 == 0 ? 1 : 0) |
               (vec_ok<WT>(wdown, D) && D % WV == 0 ? 2 : 0);
    return launch_cooperative(kernel, &f, f.p.grid, LG_THREADS,
                              (size_t)f.p.smem, bar, (cudaStream_t)stream);
  });
}

// Blocks of the int8 group kernel with vector type vt (ElemCode) that fit
// on one SM with `smem` bytes of dynamic shared memory, into *per_sm: what
// kernels/vita_layer_group.py sizes the int8 grid by.
extern "C" int rt_vita_layer_group_int8_blocks_per_sm(int vt, int smem,
                                                      int* per_sm) {
  using namespace repro_torch;
  return dispatch_type(vt, [&](auto vtag) {
    using VT = typename decltype(vtag)::type;
    return blocks_per_sm((const void*)vita_layer_group_int8_kernel<VT>,
                         LG_I8_THREADS, (size_t)smem, per_sm);
  });
}

// int8 group: x and out float32; weights (L, ...) int8; act (L, 4); weight
// scales (L, H*Dh) for Q/K/V, (L, D) for w_msa and w_down, (L, M) for
// w_up; LN vectors and biases in vt (float32 or bf16).  Workspace as above
// but z (R, D), sa (R, H*Dh) and hid (R, M) int8.  plan: the 26 ints of
// the wrapper's Int8GroupPlan (kernels/vita_layer_group.py::
// int8_group_plan), refused where its attention layout breaks a limit of
// the tile, its shared memory holds less than the rings or that layout
// need, a stage's k groups are not built, or a copy width would cross a
// row, a head, a layer's stack or an alignment.
extern "C" int rt_vita_layer_group_int8(
    const float* x, const int8_t* wq, const int8_t* wk, const int8_t* wv,
    const int8_t* wmsa, const int8_t* wup, const int8_t* wdown, const float* act,
    const float* wq_s, const float* wk_s, const float* wv_s, const float* wmsa_s,
    const float* wup_s, const float* wdown_s, const void* ln1w, const void* ln1b,
    const void* ln2w, const void* ln2b, const void* bup, const void* bdown,
    const float* bias, const float* mask, float* out, void* z, float* q, float* k,
    float* v, void* sa, float* h1, void* hid, float* carry, unsigned int* bar,
    int B, int N, int D, int H, int Dh, int M, int L, int nW, float scale,
    float eps, int vt, const int* plan, void* stream) {
  using namespace repro_torch;
  Int8GroupArgs ga;
  ga.a = LayerGroupArgs{x, out, wq, wk, wv, wmsa, wup, wdown,
                        act, wq_s, wk_s, wv_s, wmsa_s, wup_s, wdown_s,
                        ln1w, ln1b, ln2w, ln2b, bup, bdown, bias, mask,
                        z, q, k, v, sa, h1, hid, carry, bar, B, N, D, H, Dh,
                        M, L, nW, scale, eps};
  std::memcpy(&ga.p, plan, sizeof ga.p);
  const I8GroupLayout& p = ga.p;
  const long long HD = (long long)H * Dh;
  bool ok = att_layout_ok(p.att, N, Dh) && p.smem >= LG_I8_RING &&
            p.smem >= p.att.smem && p.smem <= MSA_SMEM_LIMIT;
  for (int s = 0; s < 4; ++s) ok = ok && (p.st[s][0] == 1 || p.st[s][0] == 2);
  // A: z (K = D), sa (H*Dh), z, hid (M); B: the per-head stacks, w_msa,
  // w_up, w_down, each layer's slice at its offset in the (L, ...) stack.
  ok = ok && width_ok(p.st[0][1], D, D, 0, 0, z) &&
       width_ok(p.st[0][2], Dh, Dh, (long long)D * Dh, HD, wq) &&
       width_ok(p.st[0][2], HD * D, 0, 0, 0, wk) &&
       width_ok(p.st[0][2], 0, 0, 0, 0, wv) &&
       width_ok(p.st[1][1], HD, HD, 0, 0, sa) &&
       width_ok(p.st[1][2], D, D, HD * D, 0, wmsa) &&
       width_ok(p.st[2][1], D, D, 0, 0, z) &&
       width_ok(p.st[2][2], M, M, (long long)D * M, 0, wup) &&
       width_ok(p.st[3][1], M, M, 0, 0, hid) &&
       width_ok(p.st[3][2], D, D, (long long)M * D, 0, wdown);
  if (!ok) return (int)cudaErrorInvalidValue;
  ga.v_att = Dh % 4 == 0 && vec_ok<float>(q, HD) && vec_ok<float>(k, HD) &&
             vec_ok<float>(v, HD);
  return dispatch_type(vt, [&](auto vtag) {
    using VT = typename decltype(vtag)::type;
    return launch_cooperative((const void*)vita_layer_group_int8_kernel<VT>,
                              &ga, p.grid, LG_I8_THREADS, (size_t)p.smem,
                              bar, (cudaStream_t)stream);
  });
}

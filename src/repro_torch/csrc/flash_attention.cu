// LM prefill attention: q (B, Hq, Nq, Dh) against k, v (B, Hkv, Nk, Dh),
// GQA (query head h reads KV head h / (Hq / Hkv)), causal and sliding-window
// masks with a query offset; float32 or bfloat16 in and out, Dh <= 256.
//
// Replaces: repro/kernels/head_attention.py::flash_attention, a (batch,
// head, q-block, k-block) grid whose last axis runs in order and carries
// the online softmax's max, sum and accumulator in VMEM; it asserts that
// the block sizes divide Nq and Nk.
//
// Bound: operations at RecurrentGemma-2B's long prefill (4 * Hq * Dh *
// visible pairs: 64.5 GFLOP at 4,096 tokens, window 2048, Dh 256, 10 query
// heads), bytes for a short prompt.
//
// Design (the tile: head_attention.cuh): one block per (query head, query
// tile, sequence), warps of 16 query rows each, S and P.V on mma.sync
// (bf16, or split TF32 in fp32), K/V tiles in a two-stage cp.async ring
// with one block barrier a tile: the next tile's copies run during this
// tile's products.  The block walks only the key tiles its rows can see
// (`fa_walk`: 4,096 tokens, window 2048: at most 2,176 keys per 128-row
// tile instead of 4,096), a warp skips a tile its own rows cannot see, and
// only tiles across the causal diagonal, the window's edge or the walk's
// end are masked element by element.  The grid runs the query heads
// fastest (the heads of one KV head reuse its tiles from L2) and the query
// tiles from the last (the longest walks) to the first, so the short ones
// fill the tail.
// Tiles (kernels/head_attention.py::FLASH_TILES, the fastest of the
// shapes that fit, timed on an H100; chip_smoke.py times each served
// shape at both tiles the plan chooses between): at Dh 256, 128
// query rows over 64-key tiles in bf16 (eight warps, one block an SM),
// which halves the K/V bytes each query row pulls from L2 and shared
// memory against 64-row tiles, and in fp32 over 16-key tiles with two
// warps a row group (sixteen warps: the split-TF32 O accumulators and
// temporaries of a whole group did not leave one warp the registers to
// overlap its products); at Dh <= 128, 64 rows (four warps) over 64 keys
// (bf16) or 32 (fp32); where Nq <= 16 (a short prompt), 16 rows shared by
// four warps over 16-key tiles, which a 13-token prompt fills to 13 / 16.
// Warps that share a row group each take a share of S's depth and of O's
// columns (`fa_part_bytes`).
// The plan chooses the tile and lays out the shared memory; the launch
// checks it and takes it as is.  Dh is padded with zeros to a multiple of
// 16, and a Dh whose rows are not whole 16-byte chunks (or an unaligned
// tensor) is staged by plain loads into the same layout, so every shape
// runs on the tensor cores.
#include <cstring>

#include "head_attention.cuh"

namespace repro_torch {

template <typename T, int D, int K, int G, int W>
struct fa_tag {
  using type = T;
  static constexpr int dmax = D, bk = K, groups = G, nw = W;
};

struct FlashArgs {
  const void *q, *k, *v;
  void* out;
  int Hq, Hkv, Nq, Nk, Dh;
  float scale;
  int causal, window, q_offset;
  FlashLayout p;
};

template <typename T, int DMAX, int BK, int GROUPS, int NW>
__global__ void __launch_bounds__(32 * GROUPS * NW)
flash_attention_kernel(const FlashArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.Hq / a.Hkv);
  const int q0 = qt * a.p.rows, rows = min(a.p.rows, a.Nq - q0);
  const long long qo = ((long long)(b * a.Hq + h) * a.Nq + q0) * a.Dh;
  const long long ko = (long long)(b * a.Hkv + kvh) * a.Nk * a.Dh;
  flash_tile<T, DMAX, BK, GROUPS, NW>(
      a.p, static_cast<const T*>(a.q) + qo, static_cast<const T*>(a.k) + ko,
      static_cast<const T*>(a.v) + ko, static_cast<T*>(a.out) + qo, rows, q0,
      a.Nk, a.Dh, a.scale, a.causal, a.window, a.q_offset, smem);
}

// The layout `flash_plan` gives for element size es: the strides the
// tile's fragment addressing assumes, the ring in the block's shared
// memory.
inline bool flash_layout_ok(const FlashLayout& p, int es, int Dh) {
  if (p.rows % FA_WARP_ROWS || p.rows < FA_WARP_ROWS || p.nw < 1 ||
      p.rows / FA_WARP_ROWS * p.nw * 32 > FA_MAX_THREADS)
    return false;
  if (p.dp % 16 || p.dp < Dh || p.dp > p.dmax) return false;
  const int ld = es == 2 ? 2 * p.dp + 16 : (p.dp + 8) * 4;
  const int v_ld = es == 2 ? ld : (p.dp + 4) * 4;
  return p.q_ld == ld && p.k_ld == ld && p.v_ld == v_ld &&
         p.stage == p.bk * (p.k_ld + p.v_ld) &&
         p.smem == p.rows * p.q_ld + 2 * p.stage +
                       fa_part_bytes(p.rows / FA_WARP_ROWS, p.nw, p.bk) &&
         p.smem <= FA_SMEM_LIMIT && (p.vec == 0 || p.vec == 1);
}

// Shared memory of the kernel's largest layout (dp = DMAX), set once as
// its dynamic shared-memory limit.
template <typename T, int DMAX, int BK, int GROUPS, int NW>
constexpr int fa_max_smem() {
  constexpr int ld = sizeof(T) == 2 ? 2 * DMAX + 16 : (DMAX + 8) * 4;
  constexpr int v_ld = sizeof(T) == 2 ? ld : (DMAX + 4) * 4;
  return FA_WARP_ROWS * GROUPS * ld + 2 * BK * (ld + v_ld) +
         fa_part_bytes(GROUPS, NW, BK);
}

template <typename T, int DMAX, int BK, int GROUPS, int NW>
int launch(const FlashArgs& a, int B, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, DMAX, BK, GROUPS, NW>;
  constexpr int MAX = fa_max_smem<T, DMAX, BK, GROUPS, NW>();
  static_assert(MAX <= FA_SMEM_LIMIT, "the layout fits one block");
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(a.Hq, (a.Nq + a.p.rows - 1) / a.p.rows, B);
  kernel<<<grid, 32 * GROUPS * NW, a.p.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The instantiation for (dtype, dmax, bk, row groups, warps a group): the
// tiles of kernels/head_attention.py::FLASH_TILES.
template <typename F>
int dispatch_flash(int dtype, const FlashLayout& p, F&& f) {
  using BF = __nv_bfloat16;
  const int g = p.rows / FA_WARP_ROWS;
#define FA_CASE(T, D, K, G, W)                                 \
  if (p.dmax == D && p.bk == K && g == G && p.nw == W)         \
    return f(fa_tag<T, D, K, G, W>{});
  if (dtype == kBF16) {
    FA_CASE(BF, 128, 16, 1, 4) FA_CASE(BF, 128, 64, 4, 1)
    FA_CASE(BF, 256, 16, 1, 4) FA_CASE(BF, 256, 64, 8, 1)
  } else if (dtype == kF32) {
    FA_CASE(float, 128, 16, 1, 4) FA_CASE(float, 128, 32, 4, 1)
    FA_CASE(float, 256, 16, 1, 4) FA_CASE(float, 256, 16, 8, 2)
  }
#undef FA_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro_torch

// window <= 0: no sliding window.  dtype: kF32 or kBF16 for q, k, v, out.
// plan: the 11 ints of the wrapper's FlashPlan (kernels/head_attention.py
// ::flash_plan), refused where its layout is not the one the tile
// addresses, its (head-dim class, key tile) is not built, or it asks for
// 16-byte copies of rows that are not whole, aligned chunks.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  void* out, int B, int Hq, int Hkv, int Nq,
                                  int Nk, int Dh, float scale, int causal,
                                  int window, int q_offset, int dtype,
                                  const int* plan, void* stream) {
  using namespace repro_torch;
  FlashArgs a{q, k, v, out, Hq, Hkv, Nq, Nk, Dh, scale, causal, window,
              q_offset, {}};
  std::memcpy(&a.p, plan, sizeof a.p);
  const int es = dtype == kBF16 ? 2 : 4;
  const bool aligned = (Dh * es) % 16 == 0 && vec_ok<char>(q, 16) &&
                       vec_ok<char>(k, 16) && vec_ok<char>(v, 16);
  if ((dtype != kF32 && dtype != kBF16) || !flash_layout_ok(a.p, es, Dh) ||
      (a.p.vec && !aligned))
    return (int)cudaErrorInvalidValue;
  return dispatch_flash(dtype, a.p, [&](auto tag) {
    using G = decltype(tag);
    return launch<typename G::type, G::dmax, G::bk, G::groups, G::nw>(
        a, B, (cudaStream_t)stream);
  });
}

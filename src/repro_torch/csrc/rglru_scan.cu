// RG-LRU linear recurrence: h_t = a_t * h_{t-1} + b_t along T of
// (B, T, W), h_{-1} = 0, h carried in float32; a and b float32 or
// bfloat16, the output in a's type.
//
// Replaces: repro/kernels/rglru_scan.py::rglru_scan, a (batch, T-chunk)
// grid whose chunk axis runs in order with h carried in VMEM, and a
// log-depth scan inside each chunk.  Results differ from it by fp32
// reassociation (and one fused multiply-add per step) only.
//
// Bound: bytes (a and b read once, h written once: at B 1, T 4,096, W
// 2,560 in fp32, 126 MB, 37.6 us at 3.35 TB/s).  One thread per (sequence,
// channel) walking all of T, the first design, keeps 2,560 threads busy
// at B 1 (40 blocks on 132 SMs) and reached 4-8% of that bound at T 4,096.
// So T is cut into chunks, as the TPU kernel does, and the chunks run in
// parallel with the carry passed between them by decoupled look-back,
// reading a and b once:
//   1. Block i takes chunk i / runs (16 KB of a and of b: 32 steps in
//      fp32, 64 in bf16) of run i % runs (SCAN_CHANNELS channels of one
//      sequence), so every chunk before its own was handed to a block
//      before it; it stages the chunk's a and b
//      in shared memory by 16-byte cp.async (neighbouring threads on
//      neighbouring channels), holding few registers, so that many blocks
//      share an SM and keep loads in flight while others look back.
//   2. Each thread scans its channel's chunk from h = 0 and publishes the
//      chunk's aggregate, (A, H) = (prod a, h at the chunk's end), with
//      status 1 in the run's flag for the chunk.
//   3. It looks back: one warp reads the flags of the 32 chunks before its
//      own at once, waits until each has at least its aggregate, and finds
//      the nearest with its inclusive value (status 2, the true h at that
//      chunk's end); every thread folds the aggregates after it into the
//      carry h_in of its channel (32 further back where none of the 32 has
//      status 2; before chunk 0, h = 0).
//   4. It publishes its own inclusive value A h_in + H (status 2), then
//      walks the chunk again from h_in out of shared memory, writing h.
// A flag is stored by thread 0 with release semantics after a block
// barrier, and read by warp 0 with acquire semantics before one, which
// orders every thread's values around it.  Chunk 0 publishes status 2 at
// once.  Two buffers of the wrapper's: the flag buffer (kept across
// launches on a stream, zeroed when it is made, used for nothing else)
// holds a count of finished blocks and one flag per (chunk, run); the
// value buffer (sized by `rglru_scan.scan_plan`) A, H and the inclusive
// values, read and written past L1 (other blocks wrote them).  The last
// block to finish, when no block reads a flag any more, sets the flags
// and the count back to zero for the next launch (so no clearing launch,
// and a captured graph replays it as it is).  With T at most one chunk
// (the served prompts, decode folded) one launch of the walk below does
// it all (the plan may also ask for the walk at any T, to time the two
// designs side by side).
#include "async_copy.cuh"

namespace repro_torch {

// A chunk is 16 KB of a and of b a block: 32 steps of fp32, 64 of bf16.
constexpr int SCAN_CHANNELS = 128, WALK_THREADS = 64;
template <typename T>
__host__ __device__ constexpr int scan_chunk() { return 128 / (int)sizeof(T); }

// T up to one chunk: one thread per (sequence, channel) walks T with h in
// a register; the loads do not depend on h, so the unrolled loop keeps
// several steps' loads in flight.
template <typename T>
__global__ void __launch_bounds__(WALK_THREADS)
rglru_walk_kernel(const T* __restrict__ a, const T* __restrict__ b,
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

__device__ __forceinline__ int load_flag(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ void store_flag(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v));
}

// The chunked scan; state: the count of finished blocks, then the flags
// [chunks][runs]; agg_a, agg_h and incl [chunks][B * W] floats at `vals`.
template <typename T>
__global__ void __launch_bounds__(SCAN_CHANNELS)
rglru_chunk_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   T* __restrict__ out, int B, int Tn, int W, int runs,
                   int vec, int* state, float* vals) {
  constexpr int SCAN_CHUNK = scan_chunk<T>();
  __shared__ __align__(16) T sa[SCAN_CHUNK * SCAN_CHANNELS];
  __shared__ __align__(16) T sb[SCAN_CHUNK * SCAN_CHANNELS];
  __shared__ int s_k, s_last;
  int* flags = state + 1;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = blockIdx.x / runs, r = blockIdx.x % runs;
  const int rw = (W + SCAN_CHANNELS - 1) / SCAN_CHANNELS;
  const int bb = r / rw, w0 = (r % rw) * SCAN_CHANNELS,
            w = w0 + threadIdx.x;
  const bool on = w < W;
  const long long bw = (long long)B * W, ch = (long long)bb * W + w;
  const long long per = (long long)((Tn + SCAN_CHUNK - 1) / SCAN_CHUNK) * bw;
  float* agg_a = vals;
  float* agg_h = agg_a + per;
  float* incl = agg_h + per;
  const int t0 = c * SCAN_CHUNK, steps = min(SCAN_CHUNK, Tn - t0);
  const long long seq = (long long)bb * Tn * W;

  // 1. The chunk's a and b into shared memory (zeros past T and W).
  load_tile<T, SCAN_CHANNELS>(reinterpret_cast<unsigned char*>(sa),
                              SCAN_CHANNELS * sizeof(T), a + seq, W, t0, Tn,
                              w0, W, SCAN_CHUNK, SCAN_CHANNELS, vec != 0);
  load_tile<T, SCAN_CHANNELS>(reinterpret_cast<unsigned char*>(sb),
                              SCAN_CHANNELS * sizeof(T), b + seq, W, t0, Tn,
                              w0, W, SCAN_CHUNK, SCAN_CHANNELS, vec != 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const T* ca = sa + threadIdx.x;
  const T* cb = sb + threadIdx.x;
  // 2. The aggregate.
  float pa = 1.f, ph = 0.f;
#pragma unroll 8
  for (int i = 0; i < steps; ++i) {
    const float ai = to_f(ca[i * SCAN_CHANNELS]);
    ph = fmaf(ai, ph, to_f(cb[i * SCAN_CHANNELS]));
    pa *= ai;
  }
  const long long o = (long long)c * bw + ch;
  int* flag = flags + (long long)c * runs + r;
  float h_in = 0.f;
  if (c > 0) {
    if (on) {
      __stcg(agg_a + o, pa);
      __stcg(agg_h + o, ph);
    }
    __syncthreads();   // the block's stores before thread 0's release
    if (threadIdx.x == 0) store_flag(flag, 1);
    // 3. Look back, 32 chunks at a time: h_in = gA * (inclusive value) +
    //    gH, the aggregates after it folded in.
    float gA = 1.f, gH = 0.f;
    for (int j = c - 1;; j -= 32) {
      if (warp == 0) {
        const int idx = j - lane;
        int st = 2;                       // before chunk 0: h = 0
        if (idx >= 0)
          do {
            st = load_flag(flags + (long long)idx * runs + r);
          } while (st == 0);
        const unsigned found = __ballot_sync(0xffffffffu, st == 2);
        if (lane == 0) s_k = found ? __ffs(found) - 1 : 32;
      }
      __syncthreads();   // warp 0's acquires before the block's loads
      const int k = s_k;
      __syncthreads();                    // s_k is rewritten next round
      if (on) {
#pragma unroll 8
        for (int i = 0; i < k; ++i) {
          const long long oi = (long long)(j - i) * bw + ch;
          const float A = __ldcg(agg_a + oi), Hh = __ldcg(agg_h + oi);
          gH = fmaf(gA, Hh, gH);
          gA *= A;
        }
        if (k < 32) {
          const int idx = j - k;
          h_in = fmaf(gA, idx >= 0 ? __ldcg(incl + (long long)idx * bw + ch)
                                   : 0.f, gH);
        }
      }
      if (k < 32) break;
    }
  }
  // 4. The inclusive value for the chunks after this one, then h.
  if (on) __stcg(incl + o, fmaf(pa, h_in, ph));
  __syncthreads();
  if (threadIdx.x == 0) {
    store_flag(flag, 2);
    s_last = atomicAdd(state, 1) == (int)gridDim.x - 1;
  }
  if (on) {
    float h = h_in;
    T* co = out + seq + (long long)t0 * W + w;
#pragma unroll 8
    for (int i = 0; i < steps; ++i) {
      h = fmaf(to_f(ca[i * SCAN_CHANNELS]), h, to_f(cb[i * SCAN_CHANNELS]));
      co[(long long)i * W] = from_f<T>(h);
    }
  }
  // 5. The last block: every other block has counted itself, after its
  //    last flag read or write, so the flags are free to clear.
  __syncthreads();
  if (s_last) {
    for (int i = threadIdx.x; i < (int)gridDim.x; i += SCAN_CHANNELS)
      flags[i] = 0;
    if (threadIdx.x == 0) *state = 0;
  }
}

// plan: the 5 ints of kernels/rglru_scan.py::scan_plan, (chunk, channels,
// chunks, runs, value bytes).
template <typename T>
int launch(const void* a, const void* b, void* out, int B, int Tn, int W,
           const int* plan, int* state, void* vals, cudaStream_t stream) {
  const int chunk = plan[0], channels = plan[1], chunks = plan[2],
            runs = plan[3], bytes = plan[4];
  if (chunks == 1) {                      // the walk
    if (chunk != Tn || channels != WALK_THREADS ||
        (long long)runs * WALK_THREADS < (long long)B * W)
      return (int)cudaErrorInvalidValue;
    rglru_walk_kernel<T><<<runs, WALK_THREADS, 0, stream>>>(
        (const T*)a, (const T*)b, (T*)out, B, Tn, W);
    return (int)cudaGetLastError();
  }
  const int rw = (W + SCAN_CHANNELS - 1) / SCAN_CHANNELS;
  constexpr int SCAN_CHUNK = scan_chunk<T>();
  if (chunk != SCAN_CHUNK || channels != SCAN_CHANNELS ||
      chunks != (Tn + SCAN_CHUNK - 1) / SCAN_CHUNK || runs != B * rw ||
      !state || !vals ||
      bytes < 3LL * chunks * B * W * (long long)sizeof(float))
    return (int)cudaErrorInvalidValue;
  const int vec = vec_ok<T>(a, W) && vec_ok<T>(b, W);
  rglru_chunk_kernel<T><<<chunks * runs, SCAN_CHANNELS, 0, stream>>>(
      (const T*)a, (const T*)b, (T*)out, B, Tn, W, runs, vec, state,
      static_cast<float*>(vals));
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// dtype: kF32 or kBF16 for a, b and out.  plan: the 5 ints of the
// wrapper's ScanPlan.  state: 1 + chunks * runs ints, all zero (the
// wrapper keeps one such buffer a stream, zeroed when it is made; each
// launch leaves it zero); vals: the plan's value bytes.  Both null for
// the walk.
extern "C" int rt_rglru_scan(const void* a, const void* b, void* out, int B,
                             int Tn, int W, int dtype, const int* plan,
                             int* state, void* vals, void* stream) {
  using namespace repro_torch;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(a, b, out, B, Tn, W, plan, state, vals, s);
  if (dtype == kF32)
    return launch<float>(a, b, out, B, Tn, W, plan, state, vals, s);
  return (int)cudaErrorInvalidValue;
}

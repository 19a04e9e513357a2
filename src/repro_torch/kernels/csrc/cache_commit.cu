// Step-boundary commit of the async cached tier, in place: dirty-victim
// writeback (cache -> capacity), then install of the fetched shadow rows
// (shadow -> cache).
//
// Replaces the TPU kernel src/repro/kernels/cache_ops.py::
// cache_commit_kernel (body _commit_kernel). Worklist entry i touches cache
// slot slots[i] (-1 = skip) and, in this order:
//   1. if evict_rows[i] >= 0, writes the slot's row and accumulator back
//      to capacity row evict_rows[i];
//   2. if fetch_rows[i] >= 0, overwrites the slot and its accumulator with
//      shadow row src_pos[i] (src_pos == nullptr means row i); fetch -1 is
//      a pure writeback that keeps the slot.
// The caller guarantees distinct slots (each capacity row lives in at most
// one slot, so the writeback rows are distinct too) and src_pos inside the
// slab. No entry reads the capacity tier, and the shadow slab is read only.
// So no entry reads what another writes, and entries may be taken in any
// order and in parallel without racing. The one ordering the contract needs
// is "read cache[s] before overwriting it", within one entry: here the same
// thread reads those columns (and lane 0 of the entry's lanes the
// accumulator) before it writes them, so program order gives it.
//
// Bound on the H100: bytes. A writeback reads one D*4-byte cache row (256 B
// at D=64) and writes it to a random place of a capacity tier of up to
// 43.6 GB; an install reads a shadow row and writes a cache row. There is
// no arithmetic. The TPU kernel stages each row through VMEM; here the
// lanes move it through registers.
//
// What held it back in the first design (one warp an entry; chip_smoke.py
// phase 5b, one batch's 50,955 misses: 0.0249-0.0270 ms of device time
// against a 0.01095 ms bound; NVIDIA H100 80GB HBM3, 700 W): each entry was
// a chain of dependent round trips (the worklist fields, then the slot's
// row, then the shadow row), 16 of the 32 lanes idle at D = 64, and nothing
// of the next entry in flight. About 6,400 blocks ran in six waves of such
// chains: latency, not bandwidth. This design takes 0.0148 ms there
// (1.35x the bound, same card), and 3.8-5.7 us less in each step commit of
// chip_smoke.py's cached training runs.
//
// Design:
//   * A persistent grid over the worklist: kWaves times the blocks the card
//     holds at once, never more warps than rounds of kRound = 8 entries.
//     Warp w takes rounds w, w + W, ... (W warps in the grid); in a round,
//     lane j < 8 reads entry 8 c + j's four int32 fields (one 32-byte
//     sector a field), and the warp __ballot_sync's the live ones (a slot,
//     and a writeback or an install). The next round's fields load while
//     this one moves. Rounds of 8 and not 32 entries: a warp walks its
//     live entries one step after another, so the more warps share a
//     worklist the shorter that walk. The step commits of cached training
//     hold a few thousand to tens of thousands of entries (over an 88,064-
//     slot cache that sits in L2), where 32-entry rounds left a few hundred
//     warps and lost to one warp an entry; 8-entry rounds win from 8,000 to
//     4M entries in kernel-only trials, rings of 2 to 6 steps beside them.
//   * The register bodies (D = 64 and D = 128, tensors on a 16-byte
//     boundary): a step moves P = 128 / D entries, 32 / P lanes each, one
//     float4 of each row a lane: at D = 64 lanes 0-15 take one 256-byte
//     row and lanes 16-31 the next. A step issues all of its entries' loads
//     (the slot's row and accumulator when it writes back, the shadow row
//     and accumulator when it installs) before any store, into registers.
//     kAhead = 3 steps sit in a ring: a step's loads are issued two steps
//     before it stores, so the next steps' loads are in flight while one
//     stores (deeper rings cost registers, and with them resident warps).
//     The stream of live entries runs on across rounds, so a round's edge
//     does not drain the ring.
//   * Any other D, or a tensor off a 16-byte boundary: one entry at a time
//     for the whole warp, columns lane-strided in VEC = 4, 2 or 1 floats,
//     each chunk's loads before its stores.
// Offsets are 64-bit (row * D * 4 passes 2^35 bytes at full width). Values
// are copied, never computed: the result is bit-equal to the plain version
// (repro_torch/kernels/ref.py::cache_commit_ref), pads and pure writebacks
// included.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kWaves = 4;         // the persistent grid: resident blocks x 4
constexpr int kAhead = 3;         // steps in the register bodies' ring
constexpr int kRound = 8;         // worklist entries a warp reads a round
constexpr unsigned kFull = 0xffffffffu;

template <int VEC>
struct Vec;
template <>
struct Vec<1> { using T = float; };
template <>
struct Vec<2> { using T = float2; };
template <>
struct Vec<4> { using T = float4; };

struct Worklist {
  const int32_t* __restrict__ slots;
  const int32_t* __restrict__ evict_rows;
  const int32_t* __restrict__ fetch_rows;
  const int32_t* __restrict__ src_pos;    // nullptr: entry i reads row i
  int64_t n;
};

// One worklist entry's fields, in the lane that reads it.
struct Fields {
  int32_t s = -1, ev = -1, ft = -1, sp = 0;
};

__device__ __forceinline__ Fields read_fields(const Worklist& wl,
                                              int64_t round, int lane) {
  Fields f;
  const int64_t e = round * kRound + lane;
  if (lane < kRound && e < wl.n) {
    f.s = wl.slots[e];
    f.ev = wl.evict_rows[e];
    f.ft = wl.fetch_rows[e];
    f.sp = wl.src_pos != nullptr ? wl.src_pos[e] : (int32_t)e;
  }
  return f;
}

__device__ __forceinline__ bool is_live(const Fields& f) {
  return f.s >= 0 && (f.ev >= 0 || f.ft >= 0);
}

// The warp's stream of live entries: rounds w, w + W, ... of kRound
// entries, lane j < kRound holding entry kRound c + j of the current round;
// the next round's fields are read one round ahead. Warp-uniform but for
// the fields.
struct Stream {
  Fields cur, nxt;
  unsigned live;    // the current round's live lanes not yet taken
  int64_t c, W, rounds;
  int lane;

  __device__ __forceinline__ Stream(const Worklist& wl, int64_t w,
                                    int64_t W_, int lane_)
      : c(w), W(W_), rounds((wl.n + kRound - 1) / kRound), lane(lane_) {
    cur = read_fields(wl, c, lane);
    nxt = read_fields(wl, c + W, lane);
    live = __ballot_sync(kFull, is_live(cur));
  }

  // Moves on to the next round with a live entry; false past the last.
  __device__ __forceinline__ bool fill(const Worklist& wl) {
    while (live == 0) {
      c += W;
      if (c >= rounds) return false;
      cur = nxt;
      nxt = read_fields(wl, c + W, lane);
      live = __ballot_sync(kFull, is_live(cur));
    }
    return true;
  }

  // Takes the next live entry of the current round (fill() was true):
  // its lane.
  __device__ __forceinline__ int pop() {
    const int k = __ffs(live) - 1;
    live &= live - 1;
    return k;
  }
};

// One entry as the lanes of its group hold it in a register body: the
// fields (s < 0: the group has no entry this step), this lane's VEC floats
// of the slot's row and of the shadow row, and (group leader) the two
// accumulators.
template <int VEC>
struct Move {
  using T = typename Vec<VEC>::T;
  int32_t s, ev, ft, sp;
  T slot_row, shadow_row;
  float slot_acc, shadow_acc;
};

// Takes the next step's up to P entries into m (lane group q = lane / G of
// G = 32 / P lanes takes the q-th); false when the warp's stream is done.
template <int VEC, int P>
__device__ __forceinline__ bool take(Move<VEC>& m, Stream& st,
                                     const Worklist& wl) {
  constexpr int G = 32 / P;
  if (!st.fill(wl)) return false;
  int mine = -1;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int k = st.live ? st.pop() : -1;
    if (st.lane / G == q) mine = k;
  }
  const int src = mine >= 0 ? mine : 0;
  m.s = __shfl_sync(kFull, st.cur.s, src);
  m.ev = __shfl_sync(kFull, st.cur.ev, src);
  m.ft = __shfl_sync(kFull, st.cur.ft, src);
  m.sp = __shfl_sync(kFull, st.cur.sp, src);
  if (mine < 0) m.s = -1;
  return true;
}

// Every load of the step: rows and accumulators into registers.
template <int VEC, int P>
__device__ __forceinline__ void load(Move<VEC>& m, const float* cache,
                                     const float* cache_accum,
                                     const float* __restrict__ shadow,
                                     const float* __restrict__ shadow_accum,
                                     int lane) {
  using T = typename Vec<VEC>::T;
  constexpr int G = 32 / P;
  constexpr int D = G * VEC;
  const int col = (lane % G) * VEC;
  const bool leader = lane % G == 0;
  if (m.s < 0) return;
  if (m.ev >= 0) {
    m.slot_row =
        *reinterpret_cast<const T*>(cache + (int64_t)m.s * D + col);
    if (leader) m.slot_acc = cache_accum[m.s];
  }
  if (m.ft >= 0) {
    m.shadow_row =
        *reinterpret_cast<const T*>(shadow + (int64_t)m.sp * D + col);
    if (leader) m.shadow_acc = shadow_accum[m.sp];
  }
}

// Every store of the step, from registers.
template <int VEC, int P>
__device__ __forceinline__ void store(const Move<VEC>& m, float* capacity,
                                      float* cache, float* cap_accum,
                                      float* cache_accum, int lane) {
  using T = typename Vec<VEC>::T;
  constexpr int G = 32 / P;
  constexpr int D = G * VEC;
  const int col = (lane % G) * VEC;
  const bool leader = lane % G == 0;
  if (m.s < 0) return;
  if (m.ev >= 0) {
    *reinterpret_cast<T*>(capacity + (int64_t)m.ev * D + col) = m.slot_row;
    if (leader) cap_accum[m.ev] = m.slot_acc;
  }
  if (m.ft >= 0) {
    *reinterpret_cast<T*>(cache + (int64_t)m.s * D + col) = m.shadow_row;
    if (leader) cache_accum[m.s] = m.shadow_acc;
  }
}

// The column-loop body (P = 0): one live entry for the whole warp.
template <int VEC>
__device__ __forceinline__ void move_entry(
    float* capacity, float* cache, float* cap_accum, float* cache_accum,
    const float* __restrict__ shadow, const float* __restrict__ shadow_accum,
    int32_t s, int32_t ev, int32_t ft, int32_t sp, int64_t D, int lane) {
  using T = typename Vec<VEC>::T;
  float* slot_row = cache + (int64_t)s * D;
  float* cap_row = capacity + (int64_t)ev * D;
  const float* sh_row = shadow + (int64_t)sp * D;
  float slot_acc = 0.f, shadow_acc = 0.f;
  if (lane == 0) {
    if (ev >= 0) slot_acc = cache_accum[s];
    if (ft >= 0) shadow_acc = shadow_accum[sp];
  }
  for (int64_t c = (int64_t)lane * VEC; c < D; c += 32 * VEC) {
    T a, b;
    if (ev >= 0) a = *reinterpret_cast<const T*>(slot_row + c);
    if (ft >= 0) b = *reinterpret_cast<const T*>(sh_row + c);
    if (ev >= 0) *reinterpret_cast<T*>(cap_row + c) = a;
    if (ft >= 0) *reinterpret_cast<T*>(slot_row + c) = b;
  }
  if (lane == 0) {
    if (ev >= 0) cap_accum[ev] = slot_acc;
    if (ft >= 0) cache_accum[s] = shadow_acc;
  }
}

// P > 0: the register body at D = 32 * VEC / P; P = 0: the column loop.
template <int VEC, int P>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
cache_commit_kernel(float* capacity, float* cache, float* cap_accum,
                    float* cache_accum, const float* __restrict__ shadow,
                    const float* __restrict__ shadow_accum, Worklist wl,
                    int64_t D) {
  const int lane = threadIdx.x & 31;
  const int64_t W = (int64_t)gridDim.x * kWarpsPerBlock;
  const int64_t w = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  Stream st(wl, w, W, lane);
  if constexpr (P == 0) {
    while (st.fill(wl)) {
      const int k = st.pop();
      move_entry<VEC>(capacity, cache, cap_accum, cache_accum, shadow,
                      shadow_accum, __shfl_sync(kFull, st.cur.s, k),
                      __shfl_sync(kFull, st.cur.ev, k),
                      __shfl_sync(kFull, st.cur.ft, k),
                      __shfl_sync(kFull, st.cur.sp, k), D, lane);
    }
  } else {
    // the ring: step i's loads were issued kAhead - 1 steps before its
    // stores; a step that finds the stream done ends the walk, every step
    // taken before it having stored by then
    Move<VEC> ring[kAhead];
    bool full[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      full[i] = take<VEC, P>(ring[i], st, wl);
      if (full[i])
        load<VEC, P>(ring[i], cache, cache_accum, shadow, shadow_accum, lane);
    }
    for (;;) {
#pragma unroll
      for (int i = 0; i < kAhead; ++i) {
        if (!full[i]) return;
        store<VEC, P>(ring[i], capacity, cache, cap_accum, cache_accum, lane);
        full[i] = take<VEC, P>(ring[i], st, wl);
        if (full[i])
          load<VEC, P>(ring[i], cache, cache_accum, shadow, shadow_accum,
                       lane);
      }
    }
  }
}

// The persistent grid for `entries` worklist entries: kWaves times the
// blocks the card holds at once (the occupancy limit on every SM, read once
// per device), at most one warp per round of kRound entries.
template <typename Kern>
int64_t grid_blocks(Kern kernel, int64_t entries, int (&cache)[64]) {
  int dev = 0;
  cudaGetDevice(&dev);
  int& n = cache[dev & 63];
  if (n == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                  kWarpsPerBlock * 32, 0);
    n = kWaves * (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  const int64_t rounds = (entries + kRound - 1) / kRound;
  const int64_t want = (rounds + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return want < n ? want : n;
}

template <int VEC, int P>
cudaError_t launch(float* cap, float* cch, float* ca, float* cc,
                   const float* sh, const float* sa, const Worklist& wl,
                   int64_t D, cudaStream_t stream) {
  static int cache[64] = {0};
  const int64_t blocks = grid_blocks(cache_commit_kernel<VEC, P>, wl.n,
                                     cache);
  cache_commit_kernel<VEC, P><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                                stream>>>(cap, cch, ca, cc, sh, sa, wl, D);
  return cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

}  // namespace

extern "C" int cache_commit_launch(void* capacity, void* cache,
                                   void* cap_accum, void* cache_accum,
                                   const void* shadow, const void* shadow_accum,
                                   const void* slots, const void* evict_rows,
                                   const void* fetch_rows, const void* src_pos,
                                   int64_t n, int64_t D, void* stream) {
  if (n == 0) return 0;
  // an entry's index is its default shadow row, an int32 like src_pos
  if (n > INT32_MAX) return (int)cudaErrorInvalidValue;
  float* cap = static_cast<float*>(capacity);
  float* cch = static_cast<float*>(cache);
  float* ca = static_cast<float*>(cap_accum);
  float* cc = static_cast<float*>(cache_accum);
  const float* sh = static_cast<const float*>(shadow);
  const float* sa = static_cast<const float*>(shadow_accum);
  const Worklist wl{static_cast<const int32_t*>(slots),
                    static_cast<const int32_t*>(evict_rows),
                    static_cast<const int32_t*>(fetch_rows),
                    static_cast<const int32_t*>(src_pos), n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 4 == 0 && aligned(cap, 16) && aligned(cch, 16) && aligned(sh, 16)) {
    if (D == 64) return (int)launch<4, 2>(cap, cch, ca, cc, sh, sa, wl, D, s);
    if (D == 128) return (int)launch<4, 1>(cap, cch, ca, cc, sh, sa, wl, D, s);
    return (int)launch<4, 0>(cap, cch, ca, cc, sh, sa, wl, D, s);
  }
  if (D % 2 == 0 && aligned(cap, 8) && aligned(cch, 8) && aligned(sh, 8))
    return (int)launch<2, 0>(cap, cch, ca, cc, sh, sa, wl, D, s);
  return (int)launch<1, 0>(cap, cch, ca, cc, sh, sa, wl, D, s);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Batched capacity <-> cache row exchange, in place.
//
// Replaces the TPU kernel src/repro/kernels/cache_ops.py::
// cache_exchange_kernel:114 (body _exchange_kernel). Worklist entry i
// touches cache slot slots[i] (-1 = skip) and, in this order:
//   1. if evict_rows[i] >= 0, writes the slot's row and accumulator back
//      to capacity row evict_rows[i] (dirty-victim writeback);
//   2. if fetch_rows[i] >= 0, copies capacity row fetch_rows[i] and its
//      accumulator into the slot and sets freq[slot] = counts[i].
// The caller guarantees distinct slots and disjoint evict and fetch row
// sets (`kernels/cache_ops.py::check_worklist`). So no entry reads what
// another writes: a capacity row is either read (fetched) or written
// (written back) and a slot belongs to one entry. The one ordering the
// contract needs is "read the slot before overwriting it", within one
// entry, and the same thread does both (the row's columns, and the
// accumulator), so program order gives it. Every load of an entry may
// therefore be issued before any of its stores, and entries taken in any
// order and in parallel.
//
// Bound on the H100: bytes. A writeback reads one D*4-byte cache row (256 B
// at D=64) and its accumulator and writes them to a random place of a
// capacity tier of up to 43.6 GB; a fetch moves a capacity row and its
// accumulator the other way and writes one LFU seed. There is no
// arithmetic. The capacity tier is in HBM or in page-locked host memory
// that the card reaches over PCIe through the same pointers (UVA), where
// the bound is the link's measured rate each way.
//
// What held the first design back (one warp an entry, lane 0 moving the
// accumulators; chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W):
//   * On the card (phase 3, serving's 15,360 entries): 0.005306 device ms
//     against a 0.003322 ms bound. Each entry was a chain: the slot's row
//     read and stored, lane 0 moving the accumulator, and only then the
//     capacity row read, its accumulator in a second round trip; no tier
//     pointer was __restrict__, so nothing lifted the reads above the
//     stores. One warp an entry left lanes idle and nothing of the next
//     entry in flight.
//   * Over the host tier (phase 11a, dlrm-m1's 50,955-entry worklist:
//     25,532 writebacks, 42,848 installs): 1.406 ms against 0.2200 ms
//     (16%). Phase 11a's attribution (host_mover_variants) split it: the
//     writebacks alone 0.994 ms, the installs alone 0.594 ms, so reads and
//     writes barely overlapped; with cap_accum on the card 0.605 and
//     0.458 ms.
// The first redesign (below, with one grid and a ring of 3 steps for both
// placements) fixed the card (0.004432 device ms at phase 3) but not the
// host tier: 1.432 ms against the first design's 1.399. Its grid, kWaves
// times the blocks the card holds at once, put nearly the whole worklist
// in flight together: tens of thousands of row reads and row writes at
// random places of a 43.6 GB range of host memory. The same writes took
// 0.129 ms packed into one run against 0.589 ms at their rows, which first
// read as the cost of a random place; a grid of 4 blocks an SM takes them
// in 0.1602 ms at the same rows: the cost was how many were in flight at
// once.
//
// Design (cache_commit.cu's schedule, with the accumulators a round at a
// time):
//   * A persistent grid over the worklist, never more warps than rounds of
//     kRound = 8 entries: in HBM kWaves times the blocks the card holds at
//     once; over the host tier kHostBlocksPerSM = 4 blocks an SM (2,112
//     warps), so that a few thousand rows, not the whole worklist, wait on
//     the link at a time. Warp w takes rounds w, w + W, ...; in a round,
//     lane j < 8 reads entry 8 c + j's four fields one round ahead, and
//     the warp __ballot_sync's the live ones.
//   * The accumulators and the LFU seed go a round at a time, one entry a
//     lane: when the warp enters a round, lane j issues its entry's
//     accumulator loads (cache_accum[s] for a writeback, cap_accum[ft] for
//     a fetch), and when it leaves the round, lane j stores them
//     (cap_accum[ev], cache_accum[s], freq[s]). The rows of the round move
//     in between, so the loads are long done when they are needed.
//   * The register bodies (D = 64 and D = 128, tiers on a 16-byte
//     boundary): a step moves P = 128 / D entries, 32 / P lanes each, one
//     float4 of each row a lane: at D = 64 lanes 0-15 take one 256-byte
//     row and lanes 16-31 the next. A step issues both of its rows' loads
//     (the slot's row for the writeback, the capacity row for the fetch)
//     before either store. A ring holds them: a step's loads are issued
//     AHEAD - 1 steps before it stores, AHEAD = kAheadCard = 2 in HBM and
//     kAheadHost = 1 over the host tier, where more steps in flight
//     only lengthen the queue at the link (the wrapper passes the
//     placement; one body, two instantiations).
//   * Any other D, or a tier off a 16-byte boundary: one entry at a time
//     for the whole warp, columns lane-strided in VEC = 4, 2 or 1 floats,
//     each chunk's loads before its stores, on the same grid and rounds.
// Times (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W, the first
// design in the same call): phase 3, in HBM, 0.004351 device ms against
// 0.005360 (bound 0.003322), and 0.006707 against 0.008297 with the L2
// emptied before each launch. Phase 11a, over the host tier (45.91 / 55.16
// GB/s): 1.199 ms against 1.373 (bound 0.2427); its writebacks alone
// 0.6068 against 0.9668, its installs alone 0.6371 against 0.6593, and
// the two as two kernels on two streams at once 1.223 ms: the card's
// reads and writes to host memory do not overlap, so no schedule brings
// the whole under the sum of its halves. On a second H100 machine (55.3
// GB/s each way) the installs alone took 0.2821 ms and the writebacks
// 0.6185, yet the whole 1.204, and 0.3333 with cap_accum on the card:
// there cap_accum's scattered 4-byte writes into host memory hold it
// (0.46 ms of the writebacks'), and no kernel can make them full-line;
// the fix is a placement, cap_accum on the card.
//
// Offsets are 64-bit (row * D * 4 passes 2^35 bytes at full width). Values
// are copied, never computed: the result is bit-equal to the plain version
// (repro_torch/kernels/ref.py::cache_exchange_ref), pads and pure
// writebacks included.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kWaves = 4;         // the persistent grid: resident blocks x 4
constexpr int kRound = 8;         // worklist entries a warp reads a round
constexpr int kAheadCard = 2;     // the ring's steps, capacity tier in HBM
constexpr int kAheadHost = 1;     // ... and in page-locked host memory
constexpr int kHostBlocksPerSM = 4;  // the grid over the host tier
constexpr unsigned kFull = 0xffffffffu;

template <int VEC>
struct Vec;
template <>
struct Vec<1> { using T = float; };
template <>
struct Vec<2> { using T = float2; };
template <>
struct Vec<4> { using T = float4; };

struct Tiers {
  float* capacity;      // (R, D), HBM or page-locked host memory
  float* cache;         // (C, D)
  float* cap_accum;     // (R,), HBM or page-locked host memory
  float* cache_accum;   // (C,)
  float* freq;          // (C,)
};

struct Worklist {
  const int32_t* __restrict__ slots;
  const int32_t* __restrict__ evict_rows;
  const int32_t* __restrict__ fetch_rows;
  const float* __restrict__ counts;
  int64_t n;
};

// One worklist entry, in the lane that holds it: its fields (ev and ft -1
// for a pad slot) and, once the round is current, its accumulators.
struct Entry {
  int32_t s = -1, ev = -1, ft = -1;
  float count = 0.f, slot_acc = 0.f, cap_acc = 0.f;
};

__device__ __forceinline__ Entry read_entry(const Worklist& wl,
                                            int64_t round, int lane) {
  Entry f;
  const int64_t e = round * kRound + lane;
  if (lane < kRound && e < wl.n) {
    f.s = wl.slots[e];
    f.ev = wl.evict_rows[e];
    f.ft = wl.fetch_rows[e];
    f.count = wl.counts[e];
    if (f.s < 0) f.ev = f.ft = -1;
  }
  return f;
}

// The round's accumulator loads, one entry a lane...
__device__ __forceinline__ void acquire(Entry& f, const Tiers& t) {
  if (f.ev >= 0) f.slot_acc = t.cache_accum[f.s];
  if (f.ft >= 0) f.cap_acc = t.cap_accum[f.ft];
}

// ... and its stores, when the warp leaves the round.
__device__ __forceinline__ void retire(const Entry& f, const Tiers& t) {
  if (f.ev >= 0) t.cap_accum[f.ev] = f.slot_acc;
  if (f.ft >= 0) {
    t.cache_accum[f.s] = f.cap_acc;
    t.freq[f.s] = f.count;
  }
}

// The warp's stream of live entries: rounds w, w + W, ... of kRound
// entries, lane j < kRound holding entry kRound c + j of the current round;
// the next round's fields are read one round ahead. Warp-uniform but for
// the entries.
struct Stream {
  Entry cur, nxt;
  unsigned live;    // the current round's live lanes not yet taken
  int64_t c, W, rounds;
  int lane;

  __device__ __forceinline__ Stream(const Worklist& wl, const Tiers& t,
                                    int64_t w, int64_t W_, int lane_)
      : c(w), W(W_), rounds((wl.n + kRound - 1) / kRound), lane(lane_) {
    cur = read_entry(wl, c, lane);
    nxt = read_entry(wl, c + W, lane);
    acquire(cur, t);
    live = __ballot_sync(kFull, cur.ev >= 0 || cur.ft >= 0);
  }

  // Moves on to the next round with a live entry, retiring the rounds it
  // leaves; false past the last (whose accumulators are then stored).
  __device__ __forceinline__ bool fill(const Worklist& wl, const Tiers& t) {
    while (live == 0) {
      if (c >= rounds) return false;
      retire(cur, t);
      c += W;
      cur = nxt;
      if (c >= rounds) return false;
      nxt = read_entry(wl, c + W, lane);
      acquire(cur, t);
      live = __ballot_sync(kFull, cur.ev >= 0 || cur.ft >= 0);
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

// One entry's rows as the lanes of its group hold them in a register body
// (s < 0: the group has no entry this step): this lane's VEC floats of the
// slot's row (for the writeback) and of the capacity row (for the fetch).
template <int VEC>
struct Move {
  using T = typename Vec<VEC>::T;
  int32_t s, ev, ft;
  T slot_row, cap_row;
};

// Takes the next step's up to P entries into m (lane group q = lane / G of
// G = 32 / P lanes takes the q-th); false when the warp's stream is done.
template <int VEC, int P>
__device__ __forceinline__ bool take(Move<VEC>& m, Stream& st,
                                     const Worklist& wl, const Tiers& t) {
  constexpr int G = 32 / P;
  if (!st.fill(wl, t)) return false;
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
  if (mine < 0) m.s = m.ev = m.ft = -1;
  return true;
}

// Both row loads of the step, into registers.
template <int VEC, int P>
__device__ __forceinline__ void load(Move<VEC>& m, const Tiers& t,
                                     int lane) {
  using T = typename Vec<VEC>::T;
  constexpr int D = 32 / P * VEC;
  const int col = lane % (32 / P) * VEC;
  if (m.ev >= 0)
    m.slot_row = *reinterpret_cast<const T*>(t.cache + (int64_t)m.s * D + col);
  if (m.ft >= 0)
    m.cap_row =
        *reinterpret_cast<const T*>(t.capacity + (int64_t)m.ft * D + col);
}

// Both row stores of the step, from registers.
template <int VEC, int P>
__device__ __forceinline__ void store(const Move<VEC>& m, const Tiers& t,
                                      int lane) {
  using T = typename Vec<VEC>::T;
  constexpr int D = 32 / P * VEC;
  const int col = lane % (32 / P) * VEC;
  if (m.ev >= 0)
    *reinterpret_cast<T*>(t.capacity + (int64_t)m.ev * D + col) = m.slot_row;
  if (m.ft >= 0)
    *reinterpret_cast<T*>(t.cache + (int64_t)m.s * D + col) = m.cap_row;
}

// The column-loop body (P = 0): one live entry's rows for the whole warp.
template <int VEC>
__device__ __forceinline__ void move_rows(const Tiers& t, int32_t s,
                                          int32_t ev, int32_t ft, int64_t D,
                                          int lane) {
  using T = typename Vec<VEC>::T;
  float* slot_row = t.cache + (int64_t)s * D;
  float* wb_row = t.capacity + (int64_t)ev * D;
  const float* ft_row = t.capacity + (int64_t)ft * D;
  for (int64_t c = (int64_t)lane * VEC; c < D; c += 32 * VEC) {
    T a, b;
    if (ev >= 0) a = *reinterpret_cast<const T*>(slot_row + c);
    if (ft >= 0) b = *reinterpret_cast<const T*>(ft_row + c);
    if (ev >= 0) *reinterpret_cast<T*>(wb_row + c) = a;
    if (ft >= 0) *reinterpret_cast<T*>(slot_row + c) = b;
  }
}

// P > 0: the register body at D = 32 * VEC / P with a ring of AHEAD steps;
// P = 0: the column loop.
template <int VEC, int P, int AHEAD>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
cache_exchange_kernel(Tiers t, Worklist wl, int64_t D) {
  const int lane = threadIdx.x & 31;
  const int64_t W = (int64_t)gridDim.x * kWarpsPerBlock;
  const int64_t w = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  Stream st(wl, t, w, W, lane);
  if constexpr (P == 0) {
    while (st.fill(wl, t)) {
      const int k = st.pop();
      move_rows<VEC>(t, __shfl_sync(kFull, st.cur.s, k),
                     __shfl_sync(kFull, st.cur.ev, k),
                     __shfl_sync(kFull, st.cur.ft, k), D, lane);
    }
  } else {
    // the ring: step i's loads were issued AHEAD - 1 steps before its
    // stores; a step that finds the stream done ends the walk, every step
    // taken before it having stored by then
    Move<VEC> ring[AHEAD];
    bool full[AHEAD];
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) {
      full[i] = take<VEC, P>(ring[i], st, wl, t);
      if (full[i]) load<VEC, P>(ring[i], t, lane);
    }
    for (;;) {
#pragma unroll
      for (int i = 0; i < AHEAD; ++i) {
        if (!full[i]) return;
        store<VEC, P>(ring[i], t, lane);
        full[i] = take<VEC, P>(ring[i], st, wl, t);
        if (full[i]) load<VEC, P>(ring[i], t, lane);
      }
    }
  }
}

// The persistent grid for `entries` worklist entries, at most one warp per
// round of kRound entries: in HBM kWaves times the blocks the card holds at
// once (the occupancy limit on every SM), over the host tier
// kHostBlocksPerSM blocks an SM; both read once per device.
template <typename Kern>
int64_t grid_blocks(Kern kernel, int64_t entries, bool host,
                    int (&cache)[64][2]) {
  int dev = 0;
  cudaGetDevice(&dev);
  int* n = cache[dev & 63];
  if (n[0] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                  kWarpsPerBlock * 32, 0);
    sms = sms > 0 ? sms : 1;
    n[1] = kHostBlocksPerSM * sms;
    n[0] = kWaves * sms * (per_sm > 0 ? per_sm : 1);
  }
  const int64_t rounds = (entries + kRound - 1) / kRound;
  const int64_t want = (rounds + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return want < n[host] ? want : n[host];
}

template <int VEC, int P, int AHEAD>
cudaError_t launch(const Tiers& t, const Worklist& wl, int64_t D, bool host,
                   cudaStream_t stream) {
  static int cache[64][2] = {};
  const int64_t blocks =
      grid_blocks(cache_exchange_kernel<VEC, P, AHEAD>, wl.n, host, cache);
  cache_exchange_kernel<VEC, P, AHEAD>
      <<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(t, wl, D);
  return cudaGetLastError();
}

// The register body at D = 32 * VEC / P, its ring set by the placement.
template <int VEC, int P>
cudaError_t launch_rows(const Tiers& t, const Worklist& wl, int64_t D,
                        bool host, cudaStream_t stream) {
  return host ? launch<VEC, P, kAheadHost>(t, wl, D, true, stream)
              : launch<VEC, P, kAheadCard>(t, wl, D, false, stream);
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

}  // namespace

// host_tier: nonzero when the capacity tier is page-locked host memory.
extern "C" int cache_exchange_launch(void* capacity, void* cache,
                                     void* cap_accum, void* cache_accum,
                                     void* freq, const void* slots,
                                     const void* evict_rows,
                                     const void* fetch_rows,
                                     const void* counts, int64_t n, int64_t D,
                                     int host_tier, void* stream) {
  if (n == 0) return 0;
  const Tiers t{static_cast<float*>(capacity), static_cast<float*>(cache),
                static_cast<float*>(cap_accum),
                static_cast<float*>(cache_accum), static_cast<float*>(freq)};
  const Worklist wl{static_cast<const int32_t*>(slots),
                    static_cast<const int32_t*>(evict_rows),
                    static_cast<const int32_t*>(fetch_rows),
                    static_cast<const float*>(counts), n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool h = host_tier != 0;
  if (D % 4 == 0 && aligned(capacity, 16) && aligned(cache, 16)) {
    if (D == 64) return (int)launch_rows<4, 2>(t, wl, D, h, s);
    if (D == 128) return (int)launch_rows<4, 1>(t, wl, D, h, s);
    return (int)launch<4, 0, 1>(t, wl, D, h, s);
  }
  if (D % 2 == 0 && aligned(capacity, 8) && aligned(cache, 8))
    return (int)launch<2, 0, 1>(t, wl, D, h, s);
  return (int)launch<1, 0, 1>(t, wl, D, h, s);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Capacity tier -> fresh shadow slab fetches of the async cached tier:
// a row-wise fetch and a chunk-granular fetch. Both only read the tiers.
//
// Replaces the TPU kernel src/repro/kernels/cache_ops.py::
// cache_fetch_kernel:226 (body _fetch_kernel) with cache_fetch: worklist
// entry i copies capacity row fetch_rows[i] and its accumulator into
// shadow row i; a -1 entry writes a zero row and a zero accumulator.
//
// Replaces the TPU kernel cache_ops.py::cache_fetch_chunked_kernel:302
// (body _fetch_chunked_kernel) with cache_fetch_chunked: block k copies the
// `chunk` contiguous capacity rows starting at starts[k] (clamped by the
// caller so that start + chunk <= R) into shadow rows [k*chunk,
// (k+1)*chunk), with their accumulators; a -1 start writes a zero block.
//
// Bound on the H100: bytes. Each shadow row is one D*4-byte read (256 B at
// D=64) from a random place in a capacity tier of up to 43.6 GB and one
// write; there is no arithmetic. The capacity tier is in HBM or in
// page-locked host memory read over PCIe through the same pointers (UVA),
// where the bound is the link's measured host-to-device rate.
//
// What held the row fetch's first design back (one warp an entry, float4
// lanes, lane 0 reading the accumulator after the row; chip_smoke.py,
// dlrm-m1's 50,955-entry worklist, NVIDIA H100 80GB HBM3, 700 W): on the
// card (phase 5b) 0.01301 device ms against a 0.007929 ms bound: at D = 64
// lanes 16-31 idled, the accumulator was a second dependent round trip
// after the row, and each of ~6,400 blocks ran one entry and exited with
// nothing of the next in flight. Over the host tier (phase 11a) 0.7140 ms
// against 0.2589 ms (36%), 0.5342 ms with cap_accum on the card.
// The first redesign (below, with one grid and a ring of 3 steps for both
// placements) fixed the card (0.008839 device ms) but not the host tier:
// 0.7509 ms against the first design's 0.7497, and 0.5627 against 0.5403
// with cap_accum on the card. Its grid, kWaves times the blocks the card
// holds at once, put nearly every row of the worklist in flight together,
// ~38,000 reads from all over the 43.6 GB tier; what the host tier wants
// is fewer reads in flight from a window of neighbouring entries, as the
// first design's block order happened to give it.
//
// Design of the row fetch (cache_commit.cu's schedule):
//   * A persistent grid over the worklist, never more warps than rounds of
//     kRound = 8 entries: in HBM kWaves times the blocks the card holds at
//     once; over the host tier kHostBlocksPerSM = 1 block an SM (528
//     warps), so that the rounds in flight are neighbours in the worklist
//     (the planner's rows come sorted) and ~3,200 reads wait on the link
//     at a time. Warp w takes rounds w, w + W, ...; in a round, lane j < 8
//     reads entry 8 c + j's row index, one round ahead.
//   * The accumulators a round at a time, one entry a lane: lane j issues
//     cap_accum[fetch_rows[e]] when the warp enters the round, and stores
//     it (or 0 for a pad) to shadow_accum[e] when the warp leaves it, so
//     the round's 8 stores are one 32-byte sector.
//   * The register bodies (D = 64 and D = 128, capacity and slab on a
//     16-byte boundary): a step moves P = 128 / D entries, 32 / P lanes
//     each, one float4 a lane, all 32 lanes busy (at D = 64 two 256-byte
//     rows, which land side by side in the slab). A ring holds them: a
//     step's load is issued AHEAD - 1 steps before its store, AHEAD =
//     kAheadCard = 2 in HBM and kAheadHost = 3 over the host tier (the
//     wrapper passes the placement; one body, two instantiations). A pad
//     loads nothing and stores a zero row.
//   * Any other D, or a tensor off a 16-byte boundary: one entry at a time
//     for the whole warp, columns lane-strided in VEC = 4, 2 or 1 floats,
//     on the same grid and rounds.
// Times (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W, the first
// design in the same call): phase 5b, in HBM, 0.006274 device ms against
// 0.01177, and 0.009594 against 0.01622 with the L2 emptied before each
// launch (83% of the 0.007929 ms bound, which counts every byte at the HBM
// rate). Phase 11a, over the host tier (45.91 / 55.16 GB/s): 0.7063 ms
// against 0.7414 (bound 0.2856), and 0.5690 against 0.5713 with cap_accum
// on the card. What holds it there is the SMs' reads from host memory,
// whose rate differs between machines: here 12.9 MB of rows in 0.569 ms
// (22.7 GB/s) at their rows and 26 GB/s packed, against 45.9 GB/s for
// the copy engine; on a second H100 machine (55.3 GB/s each way) 0.3322
// ms, 0.2763 with cap_accum on the card (46.7 GB/s, 84% of the bound).
//
// The chunk fetch (its first design, kept) gives one block to each chunk:
// its chunk*D floats are contiguous in both tiers, so the block copies them
// as one coalesced float4 stream, and its first `chunk` threads move the
// accumulators.
//
// Offsets are 64-bit: at full width a row index passes 2^24 and
// row * D * 4 passes 2^35 bytes. Every shadow row is written, pads
// included, so the wrapper allocates the slab with torch.empty. Values are
// copied, never computed: the result is bit-equal to the plain versions
// (repro_torch/kernels/ref.py::cache_fetch_ref, cache_fetch_chunked_ref).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kWaves = 4;         // the persistent grid: resident blocks x 4
constexpr int kRound = 8;         // worklist entries a warp reads a round
constexpr int kAheadCard = 2;     // the ring's steps, capacity tier in HBM
constexpr int kAheadHost = 3;     // ... and in page-locked host memory
constexpr int kHostBlocksPerSM = 1;  // the grid over the host tier
constexpr int kChunkThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

template <int VEC>
struct Vec;
template <>
struct Vec<1> { using T = float; };
template <>
struct Vec<2> { using T = float2; };
template <>
struct Vec<4> { using T = float4; };

struct Fetch {
  const float* __restrict__ capacity;     // (R, D), HBM or host
  const float* __restrict__ cap_accum;    // (R,), HBM or host
  const int32_t* __restrict__ fetch_rows; // (n,)
  float* __restrict__ shadow;             // (n, D)
  float* __restrict__ shadow_accum;       // (n,)
  int64_t n;
};

// One worklist entry, in the lane that holds it: in range or not, its row
// (-1: a pad) and, once the round is current, its accumulator.
struct Entry {
  bool in = false;
  int32_t ft = -1;
  float acc = 0.f;
};

__device__ __forceinline__ Entry read_entry(const Fetch& f, int64_t round,
                                            int lane) {
  Entry x;
  const int64_t e = round * kRound + lane;
  if (lane < kRound && e < f.n) {
    x.in = true;
    x.ft = f.fetch_rows[e];
  }
  return x;
}

// The warp's stream of entries: rounds w, w + W, ... of kRound entries,
// lane j < kRound holding entry kRound c + j of the current round, the
// next round's rows read one round ahead; entering a round issues its
// accumulator loads, leaving it stores them. Warp-uniform but for the
// entries.
struct Stream {
  Entry cur, nxt;
  unsigned left;    // the current round's lanes not yet taken
  int64_t c, W, rounds;
  int lane;

  __device__ __forceinline__ void enter(const Fetch& f) {
    if (cur.ft >= 0) cur.acc = f.cap_accum[cur.ft];
    left = __ballot_sync(kFull, cur.in);
  }

  __device__ __forceinline__ void leave(const Fetch& f) {
    if (cur.in)
      f.shadow_accum[c * kRound + lane] = cur.ft >= 0 ? cur.acc : 0.f;
  }

  __device__ __forceinline__ Stream(const Fetch& f, int64_t w, int64_t W_,
                                    int lane_)
      : c(w), W(W_), rounds((f.n + kRound - 1) / kRound), lane(lane_) {
    cur = read_entry(f, c, lane);
    nxt = read_entry(f, c + W, lane);
    enter(f);
  }

  // Moves on to the next round, leaving the one it is done with; false
  // past the last.
  __device__ __forceinline__ bool fill(const Fetch& f) {
    while (left == 0) {
      if (c >= rounds) return false;
      leave(f);
      c += W;
      cur = nxt;
      if (c >= rounds) return false;
      nxt = read_entry(f, c + W, lane);
      enter(f);
    }
    return true;
  }

  // Takes the current round's next entry (fill() was true): its lane.
  __device__ __forceinline__ int pop() {
    const int k = __ffs(left) - 1;
    left &= left - 1;
    return k;
  }
};

// One entry's row as the lanes of its group hold it in a register body
// (e < 0: the group has no entry this step).
template <int VEC>
struct Move {
  using T = typename Vec<VEC>::T;
  int64_t e;
  int32_t ft;
  T row;
};

// Takes the next step's up to P entries into m (lane group q = lane / G of
// G = 32 / P lanes takes the q-th) and issues its load; false when the
// warp's stream is done.
template <int VEC, int P>
__device__ __forceinline__ bool take(Move<VEC>& m, Stream& st,
                                     const Fetch& f) {
  using T = typename Vec<VEC>::T;
  constexpr int G = 32 / P;
  constexpr int D = G * VEC;
  if (!st.fill(f)) return false;
  int mine = -1;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int k = st.left ? st.pop() : -1;
    if (st.lane / G == q) mine = k;
  }
  m.ft = __shfl_sync(kFull, st.cur.ft, mine >= 0 ? mine : 0);
  m.e = mine >= 0 ? st.c * kRound + mine : -1;
  if (m.e >= 0) {
    m.row = T{};
    if (m.ft >= 0)
      m.row = *reinterpret_cast<const T*>(f.capacity + (int64_t)m.ft * D +
                                          st.lane % G * VEC);
  }
  return true;
}

template <int VEC, int P>
__device__ __forceinline__ void store(const Move<VEC>& m, const Fetch& f,
                                      int lane) {
  using T = typename Vec<VEC>::T;
  constexpr int D = 32 / P * VEC;
  if (m.e >= 0)
    *reinterpret_cast<T*>(f.shadow + m.e * D + lane % (32 / P) * VEC) = m.row;
}

// The column-loop body (P = 0): one entry's row for the whole warp.
template <int VEC>
__device__ __forceinline__ void fetch_row(const Fetch& f, int64_t e,
                                          int32_t ft, int64_t D, int lane) {
  using T = typename Vec<VEC>::T;
  float* dst = f.shadow + e * D;
  const float* src = f.capacity + (int64_t)ft * D;
  for (int64_t c = (int64_t)lane * VEC; c < D; c += 32 * VEC) {
    T v{};
    if (ft >= 0) v = *reinterpret_cast<const T*>(src + c);
    *reinterpret_cast<T*>(dst + c) = v;
  }
}

// P > 0: the register body at D = 32 * VEC / P with a ring of AHEAD steps;
// P = 0: the column loop.
template <int VEC, int P, int AHEAD>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
cache_fetch_kernel(Fetch f, int64_t D) {
  const int lane = threadIdx.x & 31;
  const int64_t W = (int64_t)gridDim.x * kWarpsPerBlock;
  const int64_t w = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  Stream st(f, w, W, lane);
  if constexpr (P == 0) {
    while (st.fill(f)) {
      const int k = st.pop();
      fetch_row<VEC>(f, st.c * kRound + k, __shfl_sync(kFull, st.cur.ft, k),
                     D, lane);
    }
  } else {
    // the ring, as in cache_exchange.cu: a step that finds the stream done
    // ends the walk, every step taken before it having stored by then
    Move<VEC> ring[AHEAD];
    bool full[AHEAD];
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) full[i] = take<VEC, P>(ring[i], st, f);
    for (;;) {
#pragma unroll
      for (int i = 0; i < AHEAD; ++i) {
        if (!full[i]) return;
        store<VEC, P>(ring[i], f, lane);
        full[i] = take<VEC, P>(ring[i], st, f);
      }
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(kChunkThreads)
cache_fetch_chunked_kernel(const float* __restrict__ capacity,
                           const float* __restrict__ cap_accum,
                           const int32_t* __restrict__ starts,
                           float* __restrict__ shadow,
                           float* __restrict__ shadow_accum, int64_t chunk,
                           int64_t D) {
  using T = typename Vec<VEC>::T;
  const int64_t k = blockIdx.x;
  const int32_t s = starts[k];
  const int64_t total = chunk * D;
  float* dst = shadow + k * total;
  float* dst_acc = shadow_accum + k * chunk;
  if (s >= 0) {
    const float* src = capacity + (int64_t)s * D;
    for (int64_t i = (int64_t)threadIdx.x * VEC; i < total;
         i += kChunkThreads * VEC)
      *reinterpret_cast<T*>(dst + i) = *reinterpret_cast<const T*>(src + i);
    for (int64_t j = threadIdx.x; j < chunk; j += kChunkThreads)
      dst_acc[j] = cap_accum[(int64_t)s + j];
  } else {
    const T zero{};
    for (int64_t i = (int64_t)threadIdx.x * VEC; i < total;
         i += kChunkThreads * VEC)
      *reinterpret_cast<T*>(dst + i) = zero;
    for (int64_t j = threadIdx.x; j < chunk; j += kChunkThreads)
      dst_acc[j] = 0.0f;
  }
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

// widest vector that divides the row (or block) and fits both pointers
int vec_width(int64_t width, const void* a, const void* b) {
  if (width % 4 == 0 && aligned(a, 16) && aligned(b, 16)) return 4;
  if (width % 2 == 0 && aligned(a, 8) && aligned(b, 8)) return 2;
  return 1;
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
cudaError_t launch_fetch(const Fetch& f, int64_t D, bool host,
                         cudaStream_t stream) {
  static int cache[64][2] = {};
  const int64_t blocks =
      grid_blocks(cache_fetch_kernel<VEC, P, AHEAD>, f.n, host, cache);
  cache_fetch_kernel<VEC, P, AHEAD>
      <<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(f, D);
  return cudaGetLastError();
}

// The register body at D = 32 * VEC / P, its ring set by the placement.
template <int VEC, int P>
cudaError_t launch_rows(const Fetch& f, int64_t D, bool host,
                        cudaStream_t stream) {
  return host ? launch_fetch<VEC, P, kAheadHost>(f, D, true, stream)
              : launch_fetch<VEC, P, kAheadCard>(f, D, false, stream);
}

template <int VEC>
cudaError_t launch_chunked(const float* cap, const float* ca,
                           const int32_t* st, float* sh, float* sa, int64_t k,
                           int64_t chunk, int64_t D, cudaStream_t stream) {
  cache_fetch_chunked_kernel<VEC><<<(unsigned)k, kChunkThreads, 0, stream>>>(
      cap, ca, st, sh, sa, chunk, D);
  return cudaGetLastError();
}

}  // namespace

// host_tier: nonzero when the capacity tier is page-locked host memory.
extern "C" int cache_fetch_launch(const void* capacity, const void* cap_accum,
                                  const void* fetch_rows, void* shadow,
                                  void* shadow_accum, int64_t n, int64_t D,
                                  int host_tier, void* stream) {
  if (n == 0) return 0;
  const Fetch f{static_cast<const float*>(capacity),
                static_cast<const float*>(cap_accum),
                static_cast<const int32_t*>(fetch_rows),
                static_cast<float*>(shadow), static_cast<float*>(shadow_accum),
                n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool h = host_tier != 0;
  switch (vec_width(D, capacity, shadow)) {
    case 4:
      if (D == 64) return (int)launch_rows<4, 2>(f, D, h, s);
      if (D == 128) return (int)launch_rows<4, 1>(f, D, h, s);
      return (int)launch_fetch<4, 0, 1>(f, D, h, s);
    case 2: return (int)launch_fetch<2, 0, 1>(f, D, h, s);
    default: return (int)launch_fetch<1, 0, 1>(f, D, h, s);
  }
}

extern "C" int cache_fetch_chunked_launch(const void* capacity,
                                          const void* cap_accum,
                                          const void* starts, void* shadow,
                                          void* shadow_accum, int64_t k,
                                          int64_t chunk, int64_t D,
                                          void* stream) {
  if (k == 0) return 0;
  const float* cap = static_cast<const float*>(capacity);
  const float* ca = static_cast<const float*>(cap_accum);
  const int32_t* st = static_cast<const int32_t*>(starts);
  float* sh = static_cast<float*>(shadow);
  float* sa = static_cast<float*>(shadow_accum);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a block is chunk*D contiguous floats starting at a row boundary
  switch (vec_width(D, cap, sh)) {
    case 4: return (int)launch_chunked<4>(cap, ca, st, sh, sa, k, chunk, D, s);
    case 2: return (int)launch_chunked<2>(cap, ca, st, sh, sa, k, chunk, D, s);
    default: return (int)launch_chunked<1>(cap, ca, st, sh, sa, k, chunk, D, s);
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Fused sparse backward with row-wise AdaGrad, fp32, in place.
//
// Replaces the TPU kernel src/repro/kernels/sparse_update.py::
// fused_bag_backward_adagrad_segments_kernel (body _fused_kernel) with two
// entry points over one per-row body:
//
//   fused_bag_backward_adagrad_launch           one plan, the S = 1 case
//                                               (fused_bag_backward_adagrad_kernel);
//   fused_bag_backward_adagrad_segments_launch  S per-owner segments of one
//                                               plan (S > 1).
//
// For each live entry i of a SparsePlan (unique_rows[i] >= 0):
//   g   = sum of pooled[bag_ids[j]] for j in [bag_offsets[i], bag_offsets[i+1])
//         added in that order, in fp32;
//   acc = accum[row] + mean(g^2);   w = w - lr * g * rsqrt(acc + eps);
// and both are written back in place (the TPU kernel aliases its outputs to
// its inputs). No per-lookup gradient tensor exists: the only full-width
// reads are the pooled (B*F, D) bag gradients and the touched table rows.
//
// Bound on the H100: bytes, counted as work; in fact latency. Each touched
// row and accumulator is read and written once from a table of tens of GB,
// and each (row, bag) pair reads one D*4-byte pooled row, a few FLOPs an
// element. At dlrm-m1's training batch (512) that is ~26 MB of table
// traffic and ~82 MB of pooled-row reads from the 50 MB L2 (the pooled
// gradients are 3.9 MB): tens of microseconds spread over 132 SMs. What
// bounds it in fact is latency along one row. The adds of a column must
// stay in CSR order (below), so one warp walks a row's whole run, and
// Zipf-distributed lookups make some runs long: the hottest row of a
// batch has ~4,000 bags (its 512 bags, each met ~8 times in a row). A walk
// that loads a bag's row only after adding the previous one pays an L2
// round trip a bag, ~150 ns on an H100: ~0.6 ms for that one row while
// the card idles.
//
// What the design does about it:
//   * Sums in registers, loads in flight. For D = 32, 64, 96, 128 the body
//     is templated on NC = D / 32 and keeps a lane's NC column sums in
//     registers (float2 pairs when NC is even). A run is walked in stages
//     of K bag rows (32 at D <= 64, one 32-bag group of ids; 16 above):
//     the lanes read 32 bag ids with one coalesced load a group (two
//     groups ahead) and broadcast them with __shfl_sync, and two stages of
//     rows sit in registers, so the next stage's K loads are in flight
//     while the current one is added. Only the adds are serial. A stage
//     costs about one L2 round trip however many stages are in flight
//     (ptxas's wait for a stage covers the loads issued after it), so the
//     run's time is its stage count: K = 32 takes the hottest row from
//     ~4,000 round trips to ~124 (~50 us on an H100). Deeper register
//     rings, an L1 prefetch window, a shared-memory ring fed by cp.async or
//     by bulk copies, and stages cut at repeated bags (one load a
//     segment) were all slower here: they add instructions or branches to
//     each bag, and one warp issues them in series.
//   * The adds stay __fadd_rn in CSR order from 0.f, column by column, so
//     each g is bit-equal to the plain version
//     (repro_torch/kernels/ref.py::bag_grad_sums_abs) and to the reference.
//     The epilogue is kept operation for operation: lane-strided
//     __fmul_rn/__fadd_rn partials of g^2 (each column fetched from the
//     lane that holds it), the __shfl_xor_sync butterfly 16..1, __fdiv_rn
//     by D, rsqrtf, and __fmul_rn/__fsub_rn into the row, so nvcc fuses
//     nothing into an FMA the plain version does not have. This order is
//     what rowwise_adagrad.cu repeats, which keeps the two-pass update
//     bit-equal to this one.
//   * A persistent grid over live entries: kWaves times the blocks the
//     card holds at once (the occupancy limit on every SM), capped at one
//     warp per 32 plan entries. The warps deal the entries out one by one
//     (lane j of warp w reads entry (32 r + j) W + w in round r), so a
//     table's hottest rows, which sit side by side in the sorted plan, land
//     on different warps; more warps than fit at once leave each warp, the
//     one with the hottest row too, fewer other rows. A warp reads a
//     round's rows and offsets, __ballot_sync's the live ones and updates
//     them one after another, reading the next entry's table row and first
//     bag ids while it walks the current one. In the one-plan kernel
//     unique_rows is a live prefix (the planner's contract), so a warp
//     stops at its first round without a live entry; no warp is spent on
//     the ~90% of entries that are pads at the training batch, and no host
//     sync is needed to learn the unique count. The segmented kernel pads
//     each segment on its own, so its warps skip pad rounds and go on.
//     Either way: one launch a call.
//   * Any other D (or a table or pooled tensor off an 8-byte boundary at
//     D = 64 or 128, which load float2 pairs) keeps the shared-memory body: each warp keeps its
//     row's D sums in its slice of shared memory (4 warps x D floats a
//     block; past the default 48 KB the launch opts in, and a D beyond the
//     card's limit is refused as an invalid argument).
// Row offsets are computed in 64 bits: row * D * 4 passes 2^32 bytes long
// before row ids leave int32. Unique rows are distinct, and the segments
// are disjoint row ranges of one plan (split_plan_by_owner), so no two
// warps write one row; every row goes through the same body in both
// kernels, so its bits do not depend on how the plan was segmented. What
// the TPU kernel needed and this one does not: the plan arrays in
// scalar-prefetch SMEM and D % 128 lanes.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kWaves = 4;         // the persistent grid: resident blocks x 4
constexpr unsigned kFull = 0xffffffffu;

// The register body at NC = D / 32 (D = 32, 64, 96, 128). Lane l holds
// NC columns of a row, V adjacent ones a load (float2 when NC is even):
// its i-th value is column (i / V) * 32V + l * V + i % V. A run is walked
// in stages of K bag rows, two stages in registers (2 x K x NC floats a
// lane, no spills): the next stage loads while one adds.
template <int NC>
struct Depth {
  static constexpr int V = NC % 2 == 0 ? 2 : 1;
  static constexpr int K = NC <= 2 ? 32 : 16;
};

// Lane's NC values of the global row at `row`.
template <int NC>
__device__ __forceinline__ void load_row(float (&x)[NC],
                                         const float* __restrict__ row,
                                         int lane) {
  constexpr int V = Depth<NC>::V;
#pragma unroll
  for (int h = 0; h < NC / V; ++h) {
    if constexpr (V == 2) {
      const float2 t = reinterpret_cast<const float2*>(row)[h * 32 + lane];
      x[2 * h] = t.x;
      x[2 * h + 1] = t.y;
    } else {
      x[h] = row[h * 32 + lane];
    }
  }
}

template <int NC>
__device__ __forceinline__ void store_row(float* __restrict__ row,
                                          const float (&x)[NC], int lane) {
  constexpr int V = Depth<NC>::V;
#pragma unroll
  for (int h = 0; h < NC / V; ++h) {
    if constexpr (V == 2)
      reinterpret_cast<float2*>(row)[h * 32 + lane] =
          make_float2(x[2 * h], x[2 * h + 1]);
    else
      row[h * 32 + lane] = x[h];
  }
}

// Loads the pooled rows of n <= K bags whose ids sit in lanes first ..
// first + n - 1 of `ids` (one 32-bag group); WHOLE: n == K.
template <int NC, int K, bool WHOLE>
__device__ __forceinline__ void load_bags(float (&v)[K][NC],
                                          const float* __restrict__ pooled,
                                          int32_t ids, int first, int n,
                                          int lane) {
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const int32_t bag = __shfl_sync(kFull, ids, (first + t) & 31);
    if (WHOLE || t < n)
      load_row<NC>(v[t], pooled + (int64_t)bag * (32 * NC), lane);
  }
}

// Adds the first n <= K rows of a stage in order: the CSR order.
template <int NC, int K, bool WHOLE>
__device__ __forceinline__ void add_bags(float (&g)[NC],
                                         const float (&v)[K][NC], int n) {
#pragma unroll
  for (int t = 0; t < K; ++t)
    if (WHOLE || t < n)
#pragma unroll
      for (int i = 0; i < NC; ++i) g[i] = __fadd_rn(g[i], v[t][i]);
}

// Lane l's partial of sum(g^2) in the shared-memory body's order: g[l]^2,
// then g[l + 32]^2, ... from 0.f, each column fetched from the lane that
// holds it.
template <int NC>
__device__ __forceinline__ float square_partial(const float (&g)[NC],
                                                int lane) {
  float sq = 0.f;
#pragma unroll
  for (int m = 0; m < NC; ++m) {
    float x;
    if constexpr (Depth<NC>::V == 2) {
      const int src = (lane >> 1) + 16 * (m & 1);
      const float x0 = __shfl_sync(kFull, g[2 * (m / 2)], src);
      const float x1 = __shfl_sync(kFull, g[2 * (m / 2) + 1], src);
      x = (lane & 1) ? x1 : x0;
    } else {
      x = g[m];
    }
    sq = __fadd_rn(sq, __fmul_rn(x, x));
  }
  return sq;
}

// g = the sum of the pooled rows of the n bags at bag_ids[lo ..), in
// order. `ids` holds the first 32 of them (lane j: bag j), read ahead by
// the caller; the next two 32-bag groups are read ahead here. Two stages:
// the next K rows load while the current K add.
template <int NC>
__device__ __forceinline__ void sum_run(float (&g)[NC], int32_t lo,
                                        int32_t n, int32_t ids,
                                        const int32_t* __restrict__ bag_ids,
                                        const float* __restrict__ pooled,
                                        int lane) {
  constexpr int K = Depth<NC>::K;
  static_assert(32 % K == 0, "a stage never straddles two 32-bag groups");
#pragma unroll
  for (int i = 0; i < NC; ++i) g[i] = 0.f;
  int32_t ids1 = 32 + lane < n ? bag_ids[lo + 32 + lane] : 0;
  int32_t ids2 = 64 + lane < n ? bag_ids[lo + 64 + lane] : 0;
  int32_t q = 0;                           // the next bag to load
  // loads bags [q, q + K) into a stage; `ids` holds q's group
  auto load = [&](float (&stage)[K][NC]) {
    if (q < n) {
      if (q > 0 && (q & 31) == 0) {
        ids = ids1;
        ids1 = ids2;
        ids2 = q + 64 + lane < n ? bag_ids[lo + q + 64 + lane] : 0;
      }
      if (n - q >= K)
        load_bags<NC, K, true>(stage, pooled, ids, q & 31, K, lane);
      else
        load_bags<NC, K, false>(stage, pooled, ids, q & 31, n - q, lane);
    }
    q += K;
  };
  // adds the stage that holds bags [p, p + K)
  auto add = [&](const float (&stage)[K][NC], int32_t p) {
    if (n - p >= K)
      add_bags<NC, K, true>(g, stage, K);
    else
      add_bags<NC, K, false>(g, stage, n - p);
  };
  float a[K][NC], b[K][NC];
  load(a);
  for (int32_t p = 0;;) {
    load(b);
    add(a, p);
    p += K;
    if (p >= n) return;
    load(a);
    add(b, p);
    p += K;
    if (p >= n) return;
  }
}

// What a warp reads ahead for one live entry: its table row and the first
// 32 of its bag ids.
template <int NC>
struct Ahead {
  float w[NC];
  int32_t ids;
};

template <int NC>
__device__ __forceinline__ void read_ahead(Ahead<NC>& r,
                                           const float* __restrict__ table,
                                           const int32_t* __restrict__ bag_ids,
                                           int32_t row, int32_t lo,
                                           int32_t n, int lane) {
  load_row<NC>(r.w, table + (int64_t)row * (32 * NC), lane);
  r.ids = lane < n ? bag_ids[lo + lane] : 0;
}

// The shared-memory body (any other D): one warp's update of one row from
// its CSR slice [lo, hi); g is the warp's D floats of shared memory.
__device__ __forceinline__ void update_row(
    float* __restrict__ table, float* __restrict__ accum, int32_t row,
    int32_t lo, int32_t hi, const int32_t* __restrict__ bag_ids,
    const float* __restrict__ pooled, float* g, int D, float lr, float eps,
    int lane) {
  // read before the walk: lane 0 writes it back at the end
  const float acc_in = accum[row];
  for (int c = lane; c < D; c += 32) g[c] = 0.f;
  for (int32_t j0 = lo; j0 < hi; j0 += 32) {
    const int n = (hi - j0) < 32 ? (hi - j0) : 32;
    const int32_t mine = lane < n ? bag_ids[j0 + lane] : 0;
    for (int t = 0; t < n; ++t) {
      const int32_t bag = __shfl_sync(kFull, mine, t);
      const float* src = pooled + (int64_t)bag * D;
      for (int c = lane; c < D; c += 32) g[c] = __fadd_rn(g[c], src[c]);
    }
  }
  float sq = 0.f;
  for (int c = lane; c < D; c += 32) sq = __fadd_rn(sq, __fmul_rn(g[c], g[c]));
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(kFull, sq, off);
  const float acc = __fadd_rn(acc_in, __fdiv_rn(sq, (float)D));
  const float rs = rsqrtf(__fadd_rn(acc, eps));
  float* w = table + (int64_t)row * D;
  for (int c = lane; c < D; c += 32)
    w[c] = __fsub_rn(w[c], __fmul_rn(__fmul_rn(lr, g[c]), rs));
  if (lane == 0) accum[row] = acc;
}

// Updates the live entries of one round of 32 entries in lane order. Lane k
// holds entry k's row (< 0: not live), CSR slice [lo, hi) and, for a live
// entry, its accumulator. The register body reads the next entry's table
// row and first bag ids while it walks the current one.
template <int NC>
__device__ __forceinline__ void update_group(
    float* __restrict__ table, float* __restrict__ accum, unsigned live,
    int32_t row, int32_t lo, int32_t hi, float acc_in,
    const int32_t* __restrict__ bag_ids, const float* __restrict__ pooled,
    float* smem_g, int D, float lr, float eps, int lane) {
  if constexpr (NC == 0) {
    while (live) {
      const int k = __ffs(live) - 1;
      live &= live - 1;
      update_row(table, accum, __shfl_sync(kFull, row, k),
                 __shfl_sync(kFull, lo, k), __shfl_sync(kFull, hi, k),
                 bag_ids, pooled, smem_g, D, lr, eps, lane);
    }
  } else {
    constexpr int DC = 32 * NC;
    int k = __ffs(live) - 1;
    live &= live - 1;
    int32_t r = __shfl_sync(kFull, row, k);
    int32_t l = __shfl_sync(kFull, lo, k);
    int32_t n = __shfl_sync(kFull, hi, k) - l;
    Ahead<NC> cur;
    read_ahead<NC>(cur, table, bag_ids, r, l, n, lane);
    for (;;) {
      const bool more = live != 0;
      Ahead<NC> nxt;
      int kn = 0;
      int32_t rn = 0, ln = 0, nn = 0;
      if (more) {
        kn = __ffs(live) - 1;
        live &= live - 1;
        rn = __shfl_sync(kFull, row, kn);
        ln = __shfl_sync(kFull, lo, kn);
        nn = __shfl_sync(kFull, hi, kn) - ln;
        read_ahead<NC>(nxt, table, bag_ids, rn, ln, nn, lane);
      }
      float g[NC];
      sum_run<NC>(g, l, n, cur.ids, bag_ids, pooled, lane);
      float sq = square_partial<NC>(g, lane);
      for (int off = 16; off > 0; off >>= 1)
        sq += __shfl_xor_sync(kFull, sq, off);
      const float acc = __fadd_rn(__shfl_sync(kFull, acc_in, k),
                                  __fdiv_rn(sq, (float)DC));
      const float rs = rsqrtf(__fadd_rn(acc, eps));
      float w[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i)
        w[i] = __fsub_rn(cur.w[i], __fmul_rn(__fmul_rn(lr, g[i]), rs));
      store_row<NC>(table + (int64_t)r * DC, w, lane);
      if (lane == 0) accum[r] = acc;
      if (!more) break;
      k = kn;
      r = rn;
      l = ln;
      n = nn;
      cur = nxt;
    }
  }
}

// The warps of the grid deal the plan's entries out one by one: lane j of
// warp w reads entries (32 r + j) W + w, r = 0, 1, ..., with W warps in
// the grid. Consecutive entries (a table's hottest rows sit side by side
// in the sorted plan) land on different warps.
template <int NC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_bag_backward_adagrad_kernel(float* __restrict__ table,
                                  float* __restrict__ accum,
                                  const int32_t* __restrict__ unique_rows,
                                  const int32_t* __restrict__ bag_offsets,
                                  const int32_t* __restrict__ bag_ids,
                                  const float* __restrict__ pooled,
                                  int64_t U, int64_t D, float lr, float eps) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int32_t W = gridDim.x * kWarpsPerBlock;
  const int32_t w = blockIdx.x * kWarpsPerBlock + warp;
  for (int32_t j = lane; (int64_t)(j - lane) * W + w < U; j += 32) {
    const int64_t e = (int64_t)j * W + w;
    const int32_t row = e < U ? unique_rows[e] : -1;
    const unsigned live = __ballot_sync(kFull, row >= 0);
    // past the live prefix: so is every later entry of this warp
    if (live == 0) break;
    int32_t lo = 0, hi = 0;
    float acc_in = 0.f;
    if (row >= 0) {
      lo = bag_offsets[e];
      hi = bag_offsets[e + 1];
      acc_in = accum[row];
    }
    update_group<NC>(table, accum, live, row, lo, hi, acc_in, bag_ids, pooled,
                     smem + warp * D, (int)D, lr, eps, lane);
  }
}

template <int NC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_bag_backward_adagrad_segments_kernel(
    float* __restrict__ table, float* __restrict__ accum,
    const int32_t* __restrict__ seg_rows,
    const int32_t* __restrict__ seg_offsets,
    const int32_t* __restrict__ bag_ids, const float* __restrict__ pooled,
    const int32_t* __restrict__ seg_base, int64_t S, int64_t C, int64_t D,
    float lr, float eps) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t total = S * C;
  const int32_t W = gridDim.x * kWarpsPerBlock;
  const int32_t w = blockIdx.x * kWarpsPerBlock + warp;
  for (int32_t j = lane; (int64_t)(j - lane) * W + w < total; j += 32) {
    const int64_t e = (int64_t)j * W + w;
    const int32_t local = e < total ? seg_rows[e] : -1;
    const unsigned live = __ballot_sync(kFull, local >= 0);
    if (live == 0) continue;       // pads of their segments
    int32_t row = -1, lo = 0, hi = 0;
    float acc_in = 0.f;
    if (local >= 0) {
      const int64_t s = e / C;
      const int32_t* offs = seg_offsets + s * (C + 1) + (e - s * C);
      row = seg_base[s] + local;
      lo = offs[0];
      hi = offs[1];
      acc_in = accum[row];
    }
    update_group<NC>(table, accum, live, row, lo, hi, acc_in, bag_ids, pooled,
                     smem + warp * D, (int)D, lr, eps, lane);
  }
}

// the shared-memory body keeps D fp32 sums a warp; the register body none
template <int NC>
size_t smem_bytes(int64_t D) {
  return NC ? 0 : (size_t)kWarpsPerBlock * (size_t)D * sizeof(float);
}

// Readies `kernel` for `smem` bytes of shared memory a block and returns
// in *blocks the persistent grid for `entries` plan entries: kWaves times
// the blocks the card holds at once (the occupancy limit on every SM), at
// most one warp per 32 entries. Past the 48 KB a launch gets by default
// the kernel opts in, up to the card's limit; a D whose shared-memory body
// needs more fails here as an invalid argument. Done once per device for
// the register body (no shared memory), at every call for the
// shared-memory body (its shared memory depends on D).
template <typename Kern>
cudaError_t prepare(Kern kernel, size_t smem, int64_t entries,
                    int (&cache)[64], int64_t* blocks) {
  int dev = 0;
  cudaGetDevice(&dev);
  int& n = cache[dev & 63];
  if (n == 0 || smem) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) {
        cudaGetLastError();          // not left for a later launch to report
        return err;
      }
    }
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                  kWarpsPerBlock * 32, smem);
    n = kWaves * (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  const int64_t groups = (entries + 31) / 32;
  const int64_t want = (groups + kWarpsPerBlock - 1) / kWarpsPerBlock;
  *blocks = want < n ? want : n;
  return cudaSuccess;
}

template <int NC>
cudaError_t launch_plan(float* table, float* accum, const int32_t* rows,
                        const int32_t* offs, const int32_t* bags,
                        const float* pooled, int64_t U, int64_t D, float lr,
                        float eps, cudaStream_t stream) {
  static int cache[64] = {0};
  const size_t smem = smem_bytes<NC>(D);
  int64_t blocks = 0;
  const cudaError_t err = prepare(fused_bag_backward_adagrad_kernel<NC>, smem,
                                  U, cache, &blocks);
  if (err != cudaSuccess) return err;
  fused_bag_backward_adagrad_kernel<NC>
      <<<(unsigned)blocks, kWarpsPerBlock * 32, smem, stream>>>(
          table, accum, rows, offs, bags, pooled, U, D, lr, eps);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_segments(float* table, float* accum, const int32_t* rows,
                            const int32_t* offs, const int32_t* bags,
                            const float* pooled, const int32_t* base,
                            int64_t S, int64_t C, int64_t D, float lr,
                            float eps, cudaStream_t stream) {
  static int cache[64] = {0};
  const size_t smem = smem_bytes<NC>(D);
  int64_t blocks = 0;
  const cudaError_t err =
      prepare(fused_bag_backward_adagrad_segments_kernel<NC>, smem, S * C,
              cache, &blocks);
  if (err != cudaSuccess) return err;
  fused_bag_backward_adagrad_segments_kernel<NC>
      <<<(unsigned)blocks, kWarpsPerBlock * 32, smem, stream>>>(
          table, accum, rows, offs, bags, pooled, base, S, C, D, lr, eps);
  return cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

// Runs launch(NC) for the body that takes D: the register body at D = 32,
// 64, 96, 128 (64 and 128 load float2 pairs, so table and pooled must be
// 8-byte aligned there), the shared-memory body (NC = 0) otherwise.
template <typename F>
int by_width(int64_t D, const void* table, const void* pooled, F launch) {
  const bool pairs = aligned(table, 8) && aligned(pooled, 8);
  switch (D) {
    case 32: return (int)launch(std::integral_constant<int, 1>{});
    case 64:
      if (pairs) return (int)launch(std::integral_constant<int, 2>{});
      break;
    case 96: return (int)launch(std::integral_constant<int, 3>{});
    case 128:
      if (pairs) return (int)launch(std::integral_constant<int, 4>{});
      break;
  }
  return (int)launch(std::integral_constant<int, 0>{});
}

}  // namespace

extern "C" int fused_bag_backward_adagrad_launch(
    void* table, void* accum, const void* unique_rows, const void* bag_offsets,
    const void* bag_ids, const void* pooled, int64_t U, int64_t D, float lr,
    float eps, void* stream) {
  if (U == 0) return 0;
  return by_width(D, table, pooled, [&](auto nc) {
    return launch_plan<decltype(nc)::value>(
        static_cast<float*>(table), static_cast<float*>(accum),
        static_cast<const int32_t*>(unique_rows),
        static_cast<const int32_t*>(bag_offsets),
        static_cast<const int32_t*>(bag_ids),
        static_cast<const float*>(pooled), U, D, lr, eps,
        static_cast<cudaStream_t>(stream));
  });
}

extern "C" int fused_bag_backward_adagrad_segments_launch(
    void* table, void* accum, const void* seg_rows, const void* seg_offsets,
    const void* bag_ids, const void* pooled, const void* seg_base, int64_t S,
    int64_t C, int64_t D, float lr, float eps, void* stream) {
  if (S * C == 0) return 0;
  return by_width(D, table, pooled, [&](auto nc) {
    return launch_segments<decltype(nc)::value>(
        static_cast<float*>(table), static_cast<float*>(accum),
        static_cast<const int32_t*>(seg_rows),
        static_cast<const int32_t*>(seg_offsets),
        static_cast<const int32_t*>(bag_ids),
        static_cast<const float*>(pooled),
        static_cast<const int32_t*>(seg_base), S, C, D, lr, eps,
        static_cast<cudaStream_t>(stream));
  });
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

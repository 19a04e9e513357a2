// Legacy row-wise AdaGrad from deduplicated row gradients, fp32, in place.
//
// Replaces the TPU kernel src/repro/kernels/rowwise_adagrad.py::
// rowwise_adagrad_kernel (body _rwadagrad_kernel), the second pass of the
// two-pass sparse update: per-lookup gradients are first summed per unique
// row (repro_torch/kernels/ref.py::dedup_grads_ref), then for each entry i
// with uniq[i] >= 0:
//   acc = accum[row] + mean(g^2);   w = w - lr * g * rsqrt(acc + eps);
// with g = gsum[i], written back in place (the TPU kernel aliases its
// outputs to its inputs). Entries with uniq[i] < 0 are skipped; the live
// rows are distinct (one per run of the dedup), so no two warps write one
// row, and entries may be taken in any order.
//
// Bound on the H100: bytes. Per live entry it reads one D*4-byte gradient
// row and reads and writes one scattered table row and one accumulator,
// against a few FLOPs per element; every entry's uniq is read once.
//
// What held it back in the first design (chip_smoke.py phase 5c: 0.0689-
// 0.0727 ms of device time against a 0.01239 ms bound; NVIDIA H100 80GB
// HBM3, 700 W): one warp for each of the N entries of the dedup's layout,
// where N is the padded batch (B F L) and only run heads are live (~51k of
// ~491k), so ~90% of the warps read one uniq value and exit; and a live
// warp's gsum row, accumulator and table row came one after another: three
// round trips a row. This design takes 0.0216-0.0217 ms there (1.75x the
// bound, same card).
//
// Design:
//   * A persistent grid over the entries in 32-entry rounds: kWaves times
//     the blocks the card holds at once, never more warps than rounds.
//     Warp w takes rounds w, w + W, ...; lane j reads uniq[32 c + j] and
//     the warp __ballot_sync's the live ones. Heads sit wherever their run
//     starts, so every round is read (4 bytes an entry, ~1/20 of the
//     bytes); the next round's uniq loads while this one updates.
//   * Read-ahead (the register body): while the warp updates one live
//     entry, the next one's gsum row, table row and accumulator are in
//     flight, across a round's edge too: one round trip a row.
//   * The same bits as the fused update (fused_bag_backward_adagrad.cu): at
//     D = 32, 64, 96, 128 the register body of that file, copied here with
//     its helpers (Depth<NC>, load_row, store_row, square_partial): a
//     lane's NC columns in registers, float2 pairs where NC is even, each
//     column's square fetched from the lane that holds it so the
//     lane-strided __fadd_rn/__fmul_rn partials of g^2 keep their order,
//     the __shfl_xor_sync butterfly 16..1, __fdiv_rn by D, rsqrtf, and
//     __fmul_rn/__fsub_rn into the row, so nvcc fuses nothing into an FMA.
//     Any other D (or a table or gsum off an 8-byte boundary at D = 64 or
//     128) keeps the scalar lane-strided body, one entry at a time, with
//     the same order of operations. Wherever the dedup's sums carry the
//     fused kernel's bits (it adds each row's gradients in the same sorted
//     order), the two-pass update equals the fused one bit for bit.
// The TPU's limits do not carry over: no scalar-prefetch SMEM cap on uniq,
// no D % 128 lanes. Row offsets are 64-bit: row * D * 4 passes 2^32 bytes.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kWaves = 4;         // the persistent grid: resident blocks x 4
constexpr int kAhead = 2;         // entries in the register body's ring
constexpr unsigned kFull = 0xffffffffu;

// From fused_bag_backward_adagrad.cu: lane l holds NC = D / 32 columns of a
// row, V adjacent ones a load (float2 when NC is even): its i-th value is
// column (i / V) * 32V + l * V + i % V.
template <int NC>
struct Depth {
  static constexpr int V = NC % 2 == 0 ? 2 : 1;
};

// From fused_bag_backward_adagrad.cu: lane's NC values of the row at `row`.
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

// From fused_bag_backward_adagrad.cu.
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

// From fused_bag_backward_adagrad.cu: lane l's partial of sum(g^2) in the
// scalar body's order: g[l]^2, then g[l + 32]^2, ... from 0.f, each column
// fetched from the lane that holds it.
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

// The warp's stream of live entries: rounds w, w + W, ... of 32 entries,
// lane j holding uniq of entry 32 c + j of the current round; the next
// round's is read one round ahead. Warp-uniform but for the rows.
struct Stream {
  int32_t cur, nxt;
  unsigned live;    // the current round's live lanes not yet taken
  int64_t c, W, N;
  int lane;

  __device__ __forceinline__ int32_t read(const int32_t* __restrict__ uniq,
                                          int64_t round) const {
    const int64_t e = round * 32 + lane;
    return e < N ? uniq[e] : -1;
  }

  __device__ __forceinline__ Stream(const int32_t* __restrict__ uniq,
                                    int64_t w, int64_t W_, int64_t N_,
                                    int lane_)
      : c(w), W(W_), N(N_), lane(lane_) {
    cur = read(uniq, c);
    nxt = read(uniq, c + W);
    live = __ballot_sync(kFull, cur >= 0);
  }

  // Takes the next live entry: its row and its index e; false past the
  // warp's last round.
  __device__ __forceinline__ bool take(const int32_t* __restrict__ uniq,
                                       int32_t& row, int64_t& e) {
    while (live == 0) {
      c += W;
      if (c * 32 >= N) return false;
      cur = nxt;
      nxt = read(uniq, c + W);
      live = __ballot_sync(kFull, cur >= 0);
    }
    const int k = __ffs(live) - 1;
    live &= live - 1;
    row = __shfl_sync(kFull, cur, k);
    e = c * 32 + k;
    return true;
  }
};

// What the register body reads ahead for one live entry.
template <int NC>
struct Ahead {
  float g[NC], w[NC];
  float acc;
  int32_t row;
};

template <int NC>
__device__ __forceinline__ void read_ahead(Ahead<NC>& a,
                                           const float* __restrict__ table,
                                           const float* __restrict__ accum,
                                           const float* __restrict__ gsum,
                                           int64_t e, int lane) {
  load_row<NC>(a.g, gsum + e * (32 * NC), lane);
  load_row<NC>(a.w, table + (int64_t)a.row * (32 * NC), lane);
  a.acc = accum[a.row];
}

// The fused kernel's epilogue on one read-ahead entry: acc = accum + mean
// (g^2), w -= lr * g * rsqrt(acc + eps), into the row in place.
template <int NC>
__device__ __forceinline__ void update(const Ahead<NC>& a,
                                       float* __restrict__ table,
                                       float* __restrict__ accum, float lr,
                                       float eps, int lane) {
  constexpr int DC = 32 * NC;
  float sq = square_partial<NC>(a.g, lane);
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(kFull, sq, off);
  const float acc = __fadd_rn(a.acc, __fdiv_rn(sq, (float)DC));
  const float rs = rsqrtf(__fadd_rn(acc, eps));
  float w[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i)
    w[i] = __fsub_rn(a.w[i], __fmul_rn(__fmul_rn(lr, a.g[i]), rs));
  store_row<NC>(table + (int64_t)a.row * DC, w, lane);
  if (lane == 0) accum[a.row] = acc;
}

template <int NC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rowwise_adagrad_kernel(float* __restrict__ table, float* __restrict__ accum,
                       const int32_t* __restrict__ uniq,
                       const float* __restrict__ gsum, int64_t N, int64_t D,
                       float lr, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t W = (int64_t)gridDim.x * kWarpsPerBlock;
  const int64_t w = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  Stream st(uniq, w, W, N, lane);
  int32_t row;
  int64_t e;
  if constexpr (NC == 0) {
    // the scalar body: lane l owns columns l, l + 32, ...
    while (st.take(uniq, row, e)) {
      // read before the butterfly, whose shuffles order every lane's read
      // before lane 0's write-back
      const float acc_in = accum[row];
      const float* g = gsum + e * D;
      float sq = 0.f;
      for (int64_t c = lane; c < D; c += 32)
        sq = __fadd_rn(sq, __fmul_rn(g[c], g[c]));
      for (int off = 16; off > 0; off >>= 1)
        sq += __shfl_xor_sync(kFull, sq, off);
      const float acc = __fadd_rn(acc_in, __fdiv_rn(sq, (float)D));
      const float rs = rsqrtf(__fadd_rn(acc, eps));
      float* w_row = table + (int64_t)row * D;
      for (int64_t c = lane; c < D; c += 32)
        w_row[c] = __fsub_rn(w_row[c], __fmul_rn(__fmul_rn(lr, g[c]), rs));
      if (lane == 0) accum[row] = acc;
    }
  } else {
    // the ring: entry i's loads were issued kAhead - 1 entries before its
    // update; a slot that finds the stream done ends the walk, every entry
    // taken before it having been updated by then
    Ahead<NC> ring[kAhead];
    bool full[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      full[i] = st.take(uniq, ring[i].row, e);
      if (full[i]) read_ahead<NC>(ring[i], table, accum, gsum, e, lane);
    }
    for (;;) {
#pragma unroll
      for (int i = 0; i < kAhead; ++i) {
        if (!full[i]) return;
        update<NC>(ring[i], table, accum, lr, eps, lane);
        full[i] = st.take(uniq, ring[i].row, e);
        if (full[i]) read_ahead<NC>(ring[i], table, accum, gsum, e, lane);
      }
    }
  }
}

// The persistent grid for N entries: kWaves times the blocks the card
// holds at once (the occupancy limit on every SM, read once per device),
// at most one warp per 32 entries.
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
  const int64_t rounds = (entries + 31) / 32;
  const int64_t want = (rounds + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return want < n ? want : n;
}

template <int NC>
cudaError_t launch(float* table, float* accum, const int32_t* uniq,
                   const float* gsum, int64_t N, int64_t D, float lr,
                   float eps, cudaStream_t stream) {
  static int cache[64] = {0};
  const int64_t blocks = grid_blocks(rowwise_adagrad_kernel<NC>, N, cache);
  rowwise_adagrad_kernel<NC><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                               stream>>>(table, accum, uniq, gsum, N, D, lr,
                                         eps);
  return cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

// Runs launch(NC) for the body that takes D: the register body at D = 32,
// 64, 96, 128 (64 and 128 load float2 pairs, so table and gsum must be
// 8-byte aligned there), the scalar body (NC = 0) otherwise; as
// fused_bag_backward_adagrad.cu's by_width picks.
template <typename F>
int by_width(int64_t D, const void* table, const void* gsum, F launch) {
  const bool pairs = aligned(table, 8) && aligned(gsum, 8);
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

extern "C" int rowwise_adagrad_launch(void* table, void* accum,
                                      const void* uniq, const void* gsum,
                                      int64_t N, int64_t D, float lr,
                                      float eps, void* stream) {
  if (N == 0) return 0;
  return by_width(D, table, gsum, [&](auto nc) {
    return launch<decltype(nc)::value>(
        static_cast<float*>(table), static_cast<float*>(accum),
        static_cast<const int32_t*>(uniq), static_cast<const float*>(gsum),
        N, D, lr, eps, static_cast<cudaStream_t>(stream));
  });
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

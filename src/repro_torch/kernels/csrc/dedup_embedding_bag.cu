// Plan-driven deduplicated embedding bag (sum), fp32.
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag.py::
// dedup_embedding_bag_kernel (body _dedup_bag_kernel): every unique row of
// a SparsePlan leaves the (H, D) table once, and every bag receives the sum
// of its slots' rows; the `mean` division stays in the wrapper, as in the
// reference's ops.py. The TPU kernel adds each unique row into its bags in
// CSR (sorted-row) order, which on a GPU would need atomics across rows and
// give a run-to-run order. This port keeps the slot order instead, in two
// kernels launched back to back on one stream:
//   1. dedup_gather_kernel: copies table[unique_rows[e]] into a compact
//      (U, D) slab for every LIVE plan entry e (the one read of each unique
//      row from the table) and writes row_pos[unique_rows[e]] = e into a
//      row-indexed (H,) int32 position map;
//   2. dedup_embedding_bag_kernel (the pool): one warp per bag walks its L
//      slots in order, reads each slot's slab position from the map with
//      one load and adds the slab row.
// The sums are added in the same order as embedding_bag.cu and the plain
// version (repro_torch/kernels/ref.py::dedup_embedding_bag_ref), one fp32
// add per column and slot, never split into partial sums, so all three
// agree bit for bit. The TPU's 8 MiB VMEM cap on the output has no
// counterpart.
//
// Bound on the H100: bytes. The gather moves each live unique row once
// (D*4 bytes read from a table of tens of GB, D*4 written to the slab);
// the pool reads each valid slot's index and slab row (the slab, 13 MB at
// the training batch, stays in the 50 MB L2) and writes the (B*F, D)
// output, with D adds per valid slot.
//
// What the design does about it:
//   * The planner sizes the plan to the flat stream (U = B*F*L entries),
//     of which about a tenth are live at the training batch. The gather is
//     a persistent grid (the occupancy limit of blocks on every SM) whose
//     warps stride over groups of plan entries and stop at the first -1:
//     the live prefix is contiguous and ascending (the planner's contract),
//     so no warp is launched for a pad entry and no host sync is needed to
//     learn the live count. A warp moves a group of K rows with VEC-wide
//     (16-byte at D=64) accesses, all of the group's loads issued before
//     its stores, so K rows are in flight per warp (K = 8 at D = 64: 16
//     lanes a row, two rows per instruction).
//   * The position map replaces a binary search over the whole plan (19
//     dependent reads per slot at U = 491,520). It costs 4 bytes a table
//     row (681 MB at the 170,361,920-row M1 table). The wrapper allocates
//     it with the slab, as one scratch tensor, on every call and never
//     clears it: the pool reads only the entries of rows its indices name,
//     which the plan covers and this call's gather wrote. Each position
//     read is clamped into [0, U): an index outside the plan breaks the
//     caller's contract and reads a wrong slab row, but never out of
//     bounds.
//   * The pool loads up to 32 slot indices with one coalesced read, each
//     lane reads its own slot's position, the positions are broadcast with
//     __shfl_sync, and kUnroll slab rows are loaded before they are added
//     in order, so their reads are in flight together.
// Row and slab offsets are computed in 64 bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGatherWarps = 8;   // warps per gather block
constexpr int kPoolWarps = 4;     // warps (bags) per pool block
constexpr int kInFlight = 4;      // vector loads per lane before the stores
constexpr int kUnroll = 8;        // slab rows loaded before they are added
constexpr unsigned kFull = 0xffffffffu;

template <int VEC>
struct Vec;
template <>
struct Vec<1> { using T = float; };
template <>
struct Vec<2> { using T = float2; };
template <>
struct Vec<4> { using T = float4; };

__device__ __forceinline__ void add(float& a, float b) { a += b; }
__device__ __forceinline__ void add(float2& a, float2 b) { a.x += b.x; a.y += b.y; }
__device__ __forceinline__ void add(float4& a, float4 b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ float2 zero<float2>() { return make_float2(0.f, 0.f); }
template <> __device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// A warp takes groups of K consecutive plan entries (lane k < K holds entry
// e0 + k's row); the group's K * nvec vectors of VEC floats are spread over
// the lanes, kInFlight loads per lane before the matching stores.
template <int VEC>
__global__ void __launch_bounds__(kGatherWarps * 32)
dedup_gather_kernel(const float* __restrict__ table,
                    const int32_t* __restrict__ unique_rows,
                    float* __restrict__ compact,
                    int32_t* __restrict__ row_pos, int64_t U, int64_t D,
                    int K) {
  using T = typename Vec<VEC>::T;
  const int lane = threadIdx.x & 31;
  const int nvec = (int)(D / VEC);
  const int span = K * nvec;
  const int64_t warp = (int64_t)blockIdx.x * kGatherWarps + (threadIdx.x >> 5);
  const int64_t stride = (int64_t)gridDim.x * kGatherWarps * K;
  for (int64_t e0 = warp * K; e0 < U; e0 += stride) {
    const int32_t mine = (lane < K && e0 + lane < U) ? unique_rows[e0 + lane]
                                                     : -1;
    // the live prefix ended: every later group of this warp is -1 too
    if (__shfl_sync(kFull, mine, 0) < 0) break;
    if (mine >= 0) row_pos[mine] = (int32_t)(e0 + lane);
    for (int base = 0; base < span; base += 32 * kInFlight) {
      T v[kInFlight];
      int k[kInFlight], c[kInFlight];
      bool ok[kInFlight];
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) {
        const int i = base + j * 32 + lane;
        k[j] = i / nvec;
        c[j] = i - k[j] * nvec;
        const int32_t row = __shfl_sync(kFull, mine, k[j] & 31);
        ok[j] = i < span && row >= 0;
        if (ok[j])
          v[j] = reinterpret_cast<const T*>(table + (int64_t)row * D)[c[j]];
      }
#pragma unroll
      for (int j = 0; j < kInFlight; ++j)
        if (ok[j])
          reinterpret_cast<T*>(compact + (e0 + k[j]) * D)[c[j]] = v[j];
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(kPoolWarps * 32)
dedup_embedding_bag_kernel(const float* __restrict__ compact,
                           const int32_t* __restrict__ row_pos,
                           const int32_t* __restrict__ indices,
                           float* __restrict__ out, int64_t n_bags, int64_t L,
                           int64_t U, int64_t D) {
  using T = typename Vec<VEC>::T;
  const int lane = threadIdx.x & 31;
  const int64_t bag = (int64_t)blockIdx.x * kPoolWarps + (threadIdx.x >> 5);
  if (bag >= n_bags) return;
  const int32_t* bag_idx = indices + bag * L;
  float* out_row = out + bag * D;
  for (int64_t c0 = 0; c0 < D; c0 += 32 * VEC) {
    const int64_t col = c0 + (int64_t)lane * VEC;
    const bool active = col < D;
    T acc = zero<T>();
    for (int64_t l0 = 0; l0 < L; l0 += 32) {
      const int n = (L - l0) < 32 ? (int)(L - l0) : 32;
      const int32_t mine = lane < n ? bag_idx[l0 + lane] : -1;
      int32_t pos = -1;                          // -1 pad
      if (mine >= 0) {
        const int32_t p = row_pos[mine];
        pos = p < 0 ? 0 : (p >= U ? (int32_t)(U - 1) : p);
      }
      for (int j0 = 0; j0 < n; j0 += kUnroll) {
        T v[kUnroll];
        bool ok[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int32_t p = __shfl_sync(kFull, pos, (j0 + u) & 31);
          ok[u] = active && j0 + u < n && p >= 0;
          if (ok[u]) v[u] = *reinterpret_cast<const T*>(compact + p * D + col);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (ok[u]) add(acc, v[u]);
      }
    }
    if (active) *reinterpret_cast<T*>(out_row + col) = acc;
  }
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

// blocks of the gather's persistent grid: every SM holds as many as its
// occupancy limit allows; queried once per device and VEC
template <int VEC>
int64_t gather_grid() {
  static int cached[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int& n = cached[dev & 63];
  if (n == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dedup_gather_kernel<VEC>, kGatherWarps * 32, 0);
    n = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  return n;
}

template <int VEC>
cudaError_t launch_gather(const float* table, const int32_t* rows,
                          float* compact, int32_t* row_pos, int64_t U,
                          int64_t D, cudaStream_t stream) {
  const int nvec = (int)(D / VEC);
  int k = 32 * kInFlight / nvec;
  k = k < 1 ? 1 : (k > 32 ? 32 : k);
  const int64_t groups = (U + k - 1) / k;
  int64_t blocks = (groups + kGatherWarps - 1) / kGatherWarps;
  const int64_t limit = gather_grid<VEC>();
  if (blocks > limit) blocks = limit;
  dedup_gather_kernel<VEC><<<(unsigned)blocks, kGatherWarps * 32, 0,
                             stream>>>(table, rows, compact, row_pos, U, D,
                                       k);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch_pool(const float* compact, const int32_t* row_pos,
                        const int32_t* indices, float* out, int64_t n_bags,
                        int64_t L, int64_t U, int64_t D, cudaStream_t stream) {
  const int64_t blocks = (n_bags + kPoolWarps - 1) / kPoolWarps;
  dedup_embedding_bag_kernel<VEC><<<(unsigned)blocks, kPoolWarps * 32, 0,
                                    stream>>>(compact, row_pos, indices, out,
                                              n_bags, L, U, D);
  return cudaGetLastError();
}

}  // namespace

// compact: caller-allocated (U, D) fp32 scratch; row_pos: caller-allocated
// (H,) int32 scratch, never cleared; U >= 1
extern "C" int dedup_embedding_bag_launch(const void* table,
                                          const void* unique_rows,
                                          const void* indices, void* compact,
                                          void* row_pos, void* out, int64_t U,
                                          int64_t n_bags, int64_t L,
                                          int64_t D, void* stream) {
  const float* t = static_cast<const float*>(table);
  const int32_t* rows = static_cast<const int32_t*>(unique_rows);
  const int32_t* idx = static_cast<const int32_t*>(indices);
  float* slab = static_cast<float*>(compact);
  int32_t* pos = static_cast<int32_t*>(row_pos);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (U > 0) {
    cudaError_t err;
    if (D % 4 == 0 && aligned(t, 16) && aligned(slab, 16))
      err = launch_gather<4>(t, rows, slab, pos, U, D, s);
    else if (D % 2 == 0 && aligned(t, 8) && aligned(slab, 8))
      err = launch_gather<2>(t, rows, slab, pos, U, D, s);
    else
      err = launch_gather<1>(t, rows, slab, pos, U, D, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (n_bags == 0) return 0;
  if (D % 128 == 0 && aligned(slab, 16) && aligned(o, 16))
    return (int)launch_pool<4>(slab, pos, idx, o, n_bags, L, U, D, s);
  if (D % 64 == 0 && aligned(slab, 8) && aligned(o, 8))
    return (int)launch_pool<2>(slab, pos, idx, o, n_bags, L, U, D, s);
  return (int)launch_pool<1>(slab, pos, idx, o, n_bags, L, U, D, s);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

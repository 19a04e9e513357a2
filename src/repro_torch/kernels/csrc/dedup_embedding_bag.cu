// Plan-driven deduplicated embedding bag (sum), fp32.
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag.py::
// dedup_embedding_bag_kernel (body _dedup_bag_kernel): every unique row of
// a SparsePlan leaves the (H, D) table once, and every bag receives the sum
// of its slots' rows; the `mean` division stays in the wrapper, as in the
// reference's ops.py. The TPU kernel adds each unique row into its bags in
// CSR (sorted-row) order, which on a GPU would need atomics across rows and
// give a run-to-run order. This port keeps the slot order instead, in two
// phases of one launch call:
//   1. gather: one warp per plan entry copies table[unique_rows[i]] into a
//      compact (U, D) slab — the one read of each unique row from the
//      table;
//   2. pool: one warp per bag walks its L slots in order, finds each slot's
//      row in the plan's ascending live prefix by binary search (the plain
//      version's searchsorted remap) and adds the slab row.
// The sums are added in the same order as embedding_bag.cu and the plain
// version (repro_torch/kernels/ref.py::dedup_embedding_bag_ref), so all
// three agree bit for bit. The TPU's 8 MiB VMEM cap on the output has no
// counterpart.
//
// Bound on the H100: bytes. Phase 1 moves each unique D*4-byte row once
// from a table of tens of GB; phase 2 reads the slab (small enough to stay
// in the 50 MB L2 at the training batch) and writes the (B*F, D) output,
// with D adds per valid slot. The binary search costs log2(U) dependent
// 4-byte reads per slot, also from L2.
//
// Design details: the slot's 32 indices are loaded with one coalesced read,
// each lane searches for its own slot, and the (row, position) pairs are
// broadcast with __shfl_sync; each lane holds VEC consecutive floats of the
// row (float2 at D=64). Row offsets into the table are computed in 64 bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
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

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
dedup_gather_kernel(const float* __restrict__ table,
                    const int32_t* __restrict__ unique_rows,
                    float* __restrict__ compact, int64_t U, int64_t D) {
  const int lane = threadIdx.x & 31;
  const int64_t entry = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (entry >= U) return;
  const int32_t row = unique_rows[entry];
  if (row < 0) return;                        // past the unique count
  const float* src = table + (int64_t)row * D;
  float* dst = compact + entry * D;
  for (int64_t c = lane; c < D; c += 32) dst[c] = src[c];
}

// first position p in [0, U) with key(p) >= r, where key is unique_rows with
// the -1 tail read as +infinity; clamped to U-1 (the plain version's clamp)
__device__ __forceinline__ int64_t find_row(const int32_t* __restrict__ rows,
                                            int64_t U, int32_t r) {
  int64_t lo = 0, hi = U;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    const int32_t v = rows[mid];
    if (v >= 0 && v < r) lo = mid + 1;
    else hi = mid;
  }
  return lo < U ? lo : U - 1;
}

template <int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
dedup_embedding_bag_kernel(const float* __restrict__ compact,
                           const int32_t* __restrict__ unique_rows,
                           const int32_t* __restrict__ indices,
                           float* __restrict__ out, int64_t n_bags, int64_t L,
                           int64_t U, int64_t D) {
  using T = typename Vec<VEC>::T;
  const int lane = threadIdx.x & 31;
  const int64_t bag = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (bag >= n_bags) return;
  const int32_t* bag_idx = indices + bag * L;
  float* out_row = out + bag * D;
  for (int64_t c0 = 0; c0 < D; c0 += 32 * VEC) {
    const int64_t col = c0 + (int64_t)lane * VEC;
    const bool active = col < D;
    T acc = zero<T>();
    for (int64_t l0 = 0; l0 < L; l0 += 32) {
      const int64_t n = (L - l0) < 32 ? (L - l0) : 32;
      const int32_t mine = lane < n ? bag_idx[l0 + lane] : -1;
      const int64_t pos = mine >= 0 ? find_row(unique_rows, U, mine) : 0;
      for (int j = 0; j < n; ++j) {
        const int32_t r = __shfl_sync(kFull, mine, j);
        const int64_t p = __shfl_sync(kFull, pos, j);
        if (r < 0) continue;                     // -1 pad
        if (active) add(acc, *reinterpret_cast<const T*>(compact + p * D + col));
      }
    }
    if (active) *reinterpret_cast<T*>(out_row + col) = acc;
  }
}

template <int VEC>
cudaError_t launch_pool(const float* compact, const int32_t* rows,
                        const int32_t* indices, float* out, int64_t n_bags,
                        int64_t L, int64_t U, int64_t D, cudaStream_t stream) {
  const int64_t blocks = (n_bags + kWarpsPerBlock - 1) / kWarpsPerBlock;
  dedup_embedding_bag_kernel<VEC><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                                    stream>>>(compact, rows, indices, out,
                                              n_bags, L, U, D);
  return cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

}  // namespace

// compact: caller-allocated (U, D) fp32 scratch; U >= 1
extern "C" int dedup_embedding_bag_launch(const void* table,
                                          const void* unique_rows,
                                          const void* indices, void* compact,
                                          void* out, int64_t U,
                                          int64_t n_bags, int64_t L,
                                          int64_t D, void* stream) {
  const float* t = static_cast<const float*>(table);
  const int32_t* rows = static_cast<const int32_t*>(unique_rows);
  const int32_t* idx = static_cast<const int32_t*>(indices);
  float* slab = static_cast<float*>(compact);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (U > 0) {
    const int64_t blocks = (U + kWarpsPerBlock - 1) / kWarpsPerBlock;
    dedup_gather_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0, s>>>(
        t, rows, slab, U, D);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (n_bags == 0) return 0;
  if (D % 128 == 0 && aligned(slab, 16) && aligned(o, 16))
    return (int)launch_pool<4>(slab, rows, idx, o, n_bags, L, U, D, s);
  if (D % 64 == 0 && aligned(slab, 8) && aligned(o, 8))
    return (int)launch_pool<2>(slab, rows, idx, o, n_bags, L, U, D, s);
  return (int)launch_pool<1>(slab, rows, idx, o, n_bags, L, U, D, s);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

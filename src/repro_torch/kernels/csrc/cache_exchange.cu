// Batched capacity <-> cache row exchange, in place.
//
// Replaces the TPU kernel src/repro/kernels/cache_ops.py::
// cache_exchange_kernel (body _exchange_kernel). Worklist entry i touches
// cache slot slots[i] (-1 = skip) and, in this order:
//   1. if evict_rows[i] >= 0, writes the slot's row and accumulator back
//      to capacity row evict_rows[i] (dirty-victim writeback);
//   2. if fetch_rows[i] >= 0, copies capacity row fetch_rows[i] and its
//      accumulator into the slot and sets freq[slot] = counts[i].
// The caller guarantees the slots are distinct and the evict and fetch row
// sets disjoint, so entries are independent and run in parallel without
// racing; within an entry one warp does step 1 before step 2.
//
// Bound on the H100: bytes. Each entry moves one D*4-byte row (256 B at
// D=64) plus two or three scalars between random addresses of a capacity
// tier of up to ~44 GB and a cache of ~6 GB; there is no arithmetic.
//
// Design: one warp per entry, each lane moving VEC consecutive floats
// (float2 at D=64: one coalesced 256-byte read and write per row), lane 0
// moving the accumulator and the LFU seed. Up to 15K entries per serving
// batch give enough independent warps to keep many row reads in flight.
// Row offsets are 64-bit: row * D * 4 reaches 43.6e9 bytes at full width.
// Values are copied, never computed, so the result is bit-equal to the
// plain version (repro_torch/kernels/ref.py::cache_exchange_ref).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <int VEC>
struct Vec;
template <>
struct Vec<1> { using T = float; };
template <>
struct Vec<2> { using T = float2; };
template <>
struct Vec<4> { using T = float4; };

template <int VEC>
__device__ __forceinline__ void copy_row(float* __restrict__ dst,
                                         const float* __restrict__ src,
                                         int64_t D, int lane) {
  using T = typename Vec<VEC>::T;
  for (int64_t c = (int64_t)lane * VEC; c < D; c += 32 * VEC) {
    *reinterpret_cast<T*>(dst + c) = *reinterpret_cast<const T*>(src + c);
  }
}

template <int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
cache_exchange_kernel(float* capacity, float* cache, float* cap_accum,
                      float* cache_accum, float* freq,
                      const int32_t* __restrict__ slots,
                      const int32_t* __restrict__ evict_rows,
                      const int32_t* __restrict__ fetch_rows,
                      const float* __restrict__ counts, int64_t n, int64_t D) {
  const int lane = threadIdx.x & 31;
  const int64_t e = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (e >= n) return;
  const int32_t s = slots[e];
  if (s < 0) return;
  const int32_t ev = evict_rows[e];
  const int32_t ft = fetch_rows[e];
  float* slot_row = cache + (int64_t)s * D;
  if (ev >= 0) {
    copy_row<VEC>(capacity + (int64_t)ev * D, slot_row, D, lane);
    if (lane == 0) cap_accum[ev] = cache_accum[s];
  }
  if (ft >= 0) {
    copy_row<VEC>(slot_row, capacity + (int64_t)ft * D, D, lane);
    if (lane == 0) {
      cache_accum[s] = cap_accum[ft];
      freq[s] = counts[e];
    }
  }
}

template <int VEC>
cudaError_t launch(float* capacity, float* cache, float* cap_accum,
                   float* cache_accum, float* freq, const int32_t* slots,
                   const int32_t* evict_rows, const int32_t* fetch_rows,
                   const float* counts, int64_t n, int64_t D,
                   cudaStream_t stream) {
  const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  cache_exchange_kernel<VEC><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      capacity, cache, cap_accum, cache_accum, freq, slots, evict_rows,
      fetch_rows, counts, n, D);
  return cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

}  // namespace

extern "C" int cache_exchange_launch(void* capacity, void* cache,
                                     void* cap_accum, void* cache_accum,
                                     void* freq, const void* slots,
                                     const void* evict_rows,
                                     const void* fetch_rows,
                                     const void* counts, int64_t n, int64_t D,
                                     void* stream) {
  if (n == 0) return 0;
  float* cap = static_cast<float*>(capacity);
  float* cch = static_cast<float*>(cache);
  const int32_t* sl = static_cast<const int32_t*>(slots);
  const int32_t* ev = static_cast<const int32_t*>(evict_rows);
  const int32_t* ft = static_cast<const int32_t*>(fetch_rows);
  const float* cn = static_cast<const float*>(counts);
  float* ca = static_cast<float*>(cap_accum);
  float* cc = static_cast<float*>(cache_accum);
  float* fq = static_cast<float*>(freq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 128 == 0 && aligned(cap, 16) && aligned(cch, 16))
    return (int)launch<4>(cap, cch, ca, cc, fq, sl, ev, ft, cn, n, D, s);
  if (D % 64 == 0 && aligned(cap, 8) && aligned(cch, 8))
    return (int)launch<2>(cap, cch, ca, cc, fq, sl, ev, ft, cn, n, D, s);
  return (int)launch<1>(cap, cch, ca, cc, fq, sl, ev, ft, cn, n, D, s);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

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
// slab. No entry reads the capacity tier, so entries are independent and
// run in parallel without racing.
//
// Bound on the H100: bytes. A writeback reads one D*4-byte cache row (256 B
// at D=64) and writes it to a random place of a capacity tier of up to
// 43.6 GB; an install reads a shadow row and writes a cache row. There is
// no arithmetic. The TPU kernel stages each row through VMEM; here a warp
// moves it directly.
//
// Design: one warp per entry, each lane moving VEC consecutive floats
// (float4 at D=64: 16 lanes per 256-byte row) and lane 0 moving the
// accumulators. Both phases walk the columns with the same lane mapping, so
// every lane overwrites in phase 2 only the columns it itself read in
// phase 1, and program order alone puts the read of cache[s] before its
// overwrite: no __syncwarp is needed. Offsets are 64-bit (row * D * 4
// passes 2^35 bytes at full width). Values are copied, never computed: the
// result is bit-equal to the plain version (repro_torch/kernels/ref.py::
// cache_commit_ref).
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
__device__ __forceinline__ void copy_row(float* dst, const float* src,
                                         int64_t D, int lane) {
  using T = typename Vec<VEC>::T;
  for (int64_t c = (int64_t)lane * VEC; c < D; c += 32 * VEC)
    *reinterpret_cast<T*>(dst + c) = *reinterpret_cast<const T*>(src + c);
}

template <int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
cache_commit_kernel(float* capacity, float* cache, float* cap_accum,
                    float* cache_accum, const float* __restrict__ shadow,
                    const float* __restrict__ shadow_accum,
                    const int32_t* __restrict__ slots,
                    const int32_t* __restrict__ evict_rows,
                    const int32_t* __restrict__ fetch_rows,
                    const int32_t* __restrict__ src_pos, int64_t n,
                    int64_t D) {
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
    const int64_t sp = src_pos != nullptr ? (int64_t)src_pos[e] : e;
    copy_row<VEC>(slot_row, shadow + sp * D, D, lane);
    if (lane == 0) cache_accum[s] = shadow_accum[sp];
  }
}

template <int VEC>
cudaError_t launch(float* cap, float* cch, float* ca, float* cc,
                   const float* sh, const float* sa, const int32_t* sl,
                   const int32_t* ev, const int32_t* ft, const int32_t* sp,
                   int64_t n, int64_t D, cudaStream_t stream) {
  const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  cache_commit_kernel<VEC><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      cap, cch, ca, cc, sh, sa, sl, ev, ft, sp, n, D);
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
  float* cap = static_cast<float*>(capacity);
  float* cch = static_cast<float*>(cache);
  float* ca = static_cast<float*>(cap_accum);
  float* cc = static_cast<float*>(cache_accum);
  const float* sh = static_cast<const float*>(shadow);
  const float* sa = static_cast<const float*>(shadow_accum);
  const int32_t* sl = static_cast<const int32_t*>(slots);
  const int32_t* ev = static_cast<const int32_t*>(evict_rows);
  const int32_t* ft = static_cast<const int32_t*>(fetch_rows);
  const int32_t* sp = static_cast<const int32_t*>(src_pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 4 == 0 && aligned(cap, 16) && aligned(cch, 16) && aligned(sh, 16))
    return (int)launch<4>(cap, cch, ca, cc, sh, sa, sl, ev, ft, sp, n, D, s);
  if (D % 2 == 0 && aligned(cap, 8) && aligned(cch, 8) && aligned(sh, 8))
    return (int)launch<2>(cap, cch, ca, cc, sh, sa, sl, ev, ft, sp, n, D, s);
  return (int)launch<1>(cap, cch, ca, cc, sh, sa, sl, ev, ft, sp, n, D, s);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

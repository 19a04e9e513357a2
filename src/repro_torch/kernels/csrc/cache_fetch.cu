// Capacity tier -> fresh shadow slab fetches of the async cached tier:
// a row-wise fetch and a chunk-granular fetch. Both only read the tiers.
//
// Replaces the TPU kernel src/repro/kernels/cache_ops.py::
// cache_fetch_kernel (body _fetch_kernel) with cache_fetch: worklist entry
// i copies capacity row fetch_rows[i] and its accumulator into shadow row
// i; a -1 entry writes a zero row and a zero accumulator.
//
// Replaces the TPU kernel cache_ops.py::cache_fetch_chunked_kernel (body
// _fetch_chunked_kernel) with cache_fetch_chunked: block k copies the
// `chunk` contiguous capacity rows starting at starts[k] (clamped by the
// caller so that start + chunk <= R) into shadow rows [k*chunk,
// (k+1)*chunk), with their accumulators; a -1 start writes a zero block.
//
// Bound on the H100: bytes. Each shadow row is one D*4-byte read (256 B at
// D=64) from a random place in a capacity tier of up to 43.6 GB and one
// write; there is no arithmetic. The TPU kernels stage each row through
// VMEM with DMA semaphores; here a warp (row fetch) or a block (chunk
// fetch) moves the bytes straight from device memory to device memory.
//
// Design: the row fetch gives one warp to each entry, each lane moving VEC
// consecutive floats (float4 at D=64: 16 lanes move the 256-byte row in one
// coalesced access) and lane 0 moving the accumulator; tens of thousands
// of independent warps keep many random row reads in flight. The chunk
// fetch gives one block to each chunk: its chunk*D floats are contiguous in
// both tiers, so the block copies them as one coalesced float4 stream, and
// its first `chunk` threads move the accumulators. Offsets are 64-bit: at
// full width a row index passes 2^24 and row * D * 4 passes 2^35 bytes.
// Every shadow row is written, pads included, so the wrapper allocates the
// slab with torch.empty. Values are copied, never computed: the result is
// bit-equal to the plain versions (repro_torch/kernels/ref.py::
// cache_fetch_ref, cache_fetch_chunked_ref).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kChunkThreads = 128;

template <int VEC>
struct Vec;
template <>
struct Vec<1> { using T = float; };
template <>
struct Vec<2> { using T = float2; };
template <>
struct Vec<4> { using T = float4; };

template <int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
cache_fetch_kernel(const float* __restrict__ capacity,
                   const float* __restrict__ cap_accum,
                   const int32_t* __restrict__ fetch_rows,
                   float* __restrict__ shadow, float* __restrict__ shadow_accum,
                   int64_t n, int64_t D) {
  using T = typename Vec<VEC>::T;
  const int lane = threadIdx.x & 31;
  const int64_t e = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (e >= n) return;
  const int32_t ft = fetch_rows[e];
  float* dst = shadow + e * D;
  if (ft >= 0) {
    const float* src = capacity + (int64_t)ft * D;
    for (int64_t c = (int64_t)lane * VEC; c < D; c += 32 * VEC)
      *reinterpret_cast<T*>(dst + c) = *reinterpret_cast<const T*>(src + c);
    if (lane == 0) shadow_accum[e] = cap_accum[ft];
  } else {
    const T zero{};
    for (int64_t c = (int64_t)lane * VEC; c < D; c += 32 * VEC)
      *reinterpret_cast<T*>(dst + c) = zero;
    if (lane == 0) shadow_accum[e] = 0.0f;
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

template <int VEC>
cudaError_t launch_fetch(const float* cap, const float* ca, const int32_t* ft,
                         float* sh, float* sa, int64_t n, int64_t D,
                         cudaStream_t stream) {
  const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  cache_fetch_kernel<VEC><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      cap, ca, ft, sh, sa, n, D);
  return cudaGetLastError();
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

extern "C" int cache_fetch_launch(const void* capacity, const void* cap_accum,
                                  const void* fetch_rows, void* shadow,
                                  void* shadow_accum, int64_t n, int64_t D,
                                  void* stream) {
  if (n == 0) return 0;
  const float* cap = static_cast<const float*>(capacity);
  const float* ca = static_cast<const float*>(cap_accum);
  const int32_t* ft = static_cast<const int32_t*>(fetch_rows);
  float* sh = static_cast<float*>(shadow);
  float* sa = static_cast<float*>(shadow_accum);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_width(D, cap, sh)) {
    case 4: return (int)launch_fetch<4>(cap, ca, ft, sh, sa, n, D, s);
    case 2: return (int)launch_fetch<2>(cap, ca, ft, sh, sa, n, D, s);
    default: return (int)launch_fetch<1>(cap, ca, ft, sh, sa, n, D, s);
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

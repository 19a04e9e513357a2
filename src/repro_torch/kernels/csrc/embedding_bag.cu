// Pooled multi-hot embedding lookup (embedding bag), fp32.
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag.py::
// embedding_bag_kernel (body _bag_kernel): one bag per program, its L rows
// gathered from an (H, D) table, -1 pads skipped, summed in fp32; `mean`
// divides by max(count, 1).
//
// Bound on the H100: bytes. Every valid lookup reads one D*4-byte row at a
// data-dependent address (256 B at D=64) and does D adds with it, far below
// the ~20 FLOP/byte the card needs before fp32 arithmetic limits it. The
// rows are scattered over a table of up to tens of GB, so the cost is the
// number of row reads and how many are in flight at once.
//
// Design: one warp per bag. The warp loads up to 32 of its bag's indices
// with one coalesced read and broadcasts them with __shfl_sync; each lane
// holds VEC consecutive floats of the row (float2 at D=64, so one warp
// reads a whole 256-byte row as one coalesced transaction). The L slots
// are walked in order, skipping pads, so the fp32 sum order is the plain
// version's (repro_torch/kernels/ref.py::embedding_bag_ref) and the two
// agree bit for bit. Row offsets are computed in 64 bits: row * D * 4
// passes 2^32 bytes long before row ids leave int32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;

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
__device__ __forceinline__ void scale(float& a, float c) { a = a / c; }
__device__ __forceinline__ void scale(float2& a, float c) { a.x = a.x / c; a.y = a.y / c; }
__device__ __forceinline__ void scale(float4& a, float c) {
  a.x = a.x / c; a.y = a.y / c; a.z = a.z / c; a.w = a.w / c;
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ float2 zero<float2>() { return make_float2(0.f, 0.f); }
template <> __device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

template <int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
embedding_bag_kernel(const float* __restrict__ table,
                     const int32_t* __restrict__ indices,
                     float* __restrict__ out, int64_t n_bags, int64_t L,
                     int64_t D, int mean) {
  using T = typename Vec<VEC>::T;
  const int lane = threadIdx.x & 31;
  const int64_t bag = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (bag >= n_bags) return;
  const int32_t* bag_idx = indices + bag * L;
  float* out_row = out + bag * D;
  // column chunks of 32*VEC floats; one chunk at D=64 with float2
  for (int64_t c0 = 0; c0 < D; c0 += 32 * VEC) {
    const int64_t col = c0 + (int64_t)lane * VEC;
    const bool active = col < D;
    T acc = zero<T>();
    int count = 0;
    for (int64_t l0 = 0; l0 < L; l0 += 32) {
      const int64_t n = (L - l0) < 32 ? (L - l0) : 32;
      const int32_t mine = lane < n ? bag_idx[l0 + lane] : -1;
      for (int j = 0; j < n; ++j) {
        const int32_t r = __shfl_sync(0xffffffffu, mine, j);
        if (r < 0) continue;                       // -1 pad
        ++count;
        if (active) {
          const T v = *reinterpret_cast<const T*>(table + (int64_t)r * D + col);
          add(acc, v);
        }
      }
    }
    if (active) {
      if (mean) scale(acc, (float)(count > 0 ? count : 1));
      *reinterpret_cast<T*>(out_row + col) = acc;
    }
  }
}

template <int VEC>
cudaError_t launch(const float* table, const int32_t* indices, float* out,
                   int64_t n_bags, int64_t L, int64_t D, int mean,
                   cudaStream_t stream) {
  const int64_t blocks = (n_bags + kWarpsPerBlock - 1) / kWarpsPerBlock;
  embedding_bag_kernel<VEC><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      table, indices, out, n_bags, L, D, mean);
  return cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

}  // namespace

extern "C" int embedding_bag_launch(const void* table, const void* indices,
                                    void* out, int64_t n_bags, int64_t L,
                                    int64_t D, int mean, void* stream) {
  if (n_bags == 0) return 0;
  const float* t = static_cast<const float*>(table);
  const int32_t* i = static_cast<const int32_t*>(indices);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 128 == 0 && aligned(t, 16) && aligned(o, 16))
    return (int)launch<4>(t, i, o, n_bags, L, D, mean, s);
  if (D % 64 == 0 && aligned(t, 8) && aligned(o, 8))
    return (int)launch<2>(t, i, o, n_bags, L, D, mean, s);
  return (int)launch<1>(t, i, o, n_bags, L, D, mean, s);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

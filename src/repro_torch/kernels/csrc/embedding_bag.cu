// Pooled multi-hot embedding lookup (embedding bag), fp32.
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag.py::
// embedding_bag_kernel (body _bag_kernel): one bag per program, its L rows
// gathered from an (H, D) table, -1 pads skipped, summed in fp32; `mean`
// divides by max(count, 1).
//
// Bound on the H100: bytes, and in practice how many row reads are in
// flight. Every valid lookup reads one D*4-byte row at a data-dependent
// address (256 B at D=64) and does D adds with it, far below the ~20
// FLOP/byte the card needs before fp32 arithmetic limits it. At the
// serving shape (480 bags of L=32, about half valid, uniform over a
// 5.8 GB cache) no row is in L2 and the card is nearly empty, so a bag
// costs one HBM round trip for each batch of its loads that is in flight
// at once. At the training shape (15,360 Zipf bags over ~51k distinct
// rows) the rows come mostly from L2 and the kernel runs near L2's rate.
//
// Design: one warp per bag, blocks of two warps (the serving shape's 480
// bags on 240 blocks: every one of the 132 SMs gets work); each lane holds
// VEC consecutive floats of the row (float2 at D=64: one warp reads a
// whole 256-byte row in one coalesced transaction). The bag's slots are
// taken in stages of 32 (16 at VEC 4): one coalesced read of the stage's
// indices, then all of the stage's row loads, then the adds, in slot
// order into a zero fp32 accumulator. A pad (or a lane past D) loads
// +0.0f instead of a row: the accumulator starts at +0.0f and so is never
// -0.0f, and x + 0.0f == x for every other x, so adding it is skipping
// it; the sum order is the plain version's
// (repro_torch/kernels/ref.py::embedding_bag_ref) and the two agree bit
// for bit. Two ways to have the stage's loads in flight together:
//  - ASYNC (at most kAsyncBagsPerSM bags an SM, e.g. serving): each lane
//    copies its columns of all the stage's rows into shared memory with
//    cp.async (a pad's copy reads nothing and zero-fills), waits once,
//    then adds from shared memory. Every load of the stage is issued
//    before the first add, so a stage costs about one round trip.
//  - registers (larger grids, e.g. training): the loads go into a
//    register array, unconditionally (pads read a zero row), and ptxas
//    keeps about five of them ahead of the adds. There the card is full
//    of warps and L2's rate limits; the asynchronous stage's extra shared
//    traffic was slower on the card (PERF.md section 6).
// ptxas (-Xptxas -v, sm_90a) registers and spills: PERF.md section 6;
// 0 spill bytes. Row offsets are computed in 64 bits: row * D * 4 passes
// 2^32 bytes long before row ids leave int32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 2;
constexpr unsigned kFull = 0xffffffffu;
// bags a launch may have, per SM, and still take the asynchronous stage
constexpr int kAsyncBagsPerSM = 32;

// what a pad slot (and a lane past D) loads in the register stage: +0.0f
// in every column of a chunk, so the stage's loads and adds are
// unconditional
__device__ float kZeroRow[4 * 32];

// one lane's bytes of one row into shared memory, asynchronously; with
// ok false nothing is read and the bytes are zero-filled
template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(float* dst, const float* src,
                                               bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const unsigned n = ok ? BYTES : 0;
  // "memory": no read of the previous stage's slots may sink below it
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(BYTES), "r"(n) : "memory");
}

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

template <int VEC, bool ASYNC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
embedding_bag_kernel(const float* __restrict__ table,
                     const int32_t* __restrict__ indices,
                     float* __restrict__ out, int64_t n_bags, int64_t L,
                     int64_t D, int mean) {
  using T = typename Vec<VEC>::T;
  // rows of a stage held at once: 64 floats a lane
  constexpr int K = VEC == 4 ? 16 : 32;
  const int lane = threadIdx.x & 31;
  float* buf = nullptr;                  // this lane's column of the stage
  if constexpr (ASYNC) {
    __shared__ __align__(16) float stage[kWarpsPerBlock][K * 32 * VEC];
    buf = stage[threadIdx.x >> 5] + lane * VEC;
  }
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
      const int n = (L - l0) < 32 ? (int)(L - l0) : 32;
      const int32_t mine = lane < n ? bag_idx[l0 + lane] : -1;
      const unsigned valid = __ballot_sync(kFull, mine >= 0);
      count += __popc(valid);
#pragma unroll
      for (int k0 = 0; k0 < 32; k0 += K) {
        if (k0 >= n) break;
        if constexpr (ASYNC) {
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const int32_t r = __shfl_sync(kFull, mine, k0 + j);
            const bool ok = r >= 0 && active;
            cp_async_zfill<VEC * 4>(buf + j * 32 * VEC,
                                    ok ? table + (int64_t)r * D + col : table,
                                    ok);
          }
          asm volatile("cp.async.wait_all;\n" ::: "memory");
#pragma unroll
          for (int j = 0; j < K; ++j)
            add(acc, *reinterpret_cast<const T*>(buf + j * 32 * VEC));
        } else {
          T v[K];
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const int32_t r = __shfl_sync(kFull, mine, k0 + j);
            const float* src = (r >= 0 && active) ? table + (int64_t)r * D + col
                                                  : kZeroRow + lane * VEC;
            v[j] = __ldg(reinterpret_cast<const T*>(src));
          }
#pragma unroll
          for (int j = 0; j < K; ++j) add(acc, v[j]);
        }
      }
    }
    if (active) {
      if (mean) scale(acc, (float)(count > 0 ? count : 1));
      *reinterpret_cast<T*>(out_row + col) = acc;
    }
  }
}

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int& n = cached[dev & 63];
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
  }
  return n;
}

template <int VEC>
cudaError_t launch(const float* table, const int32_t* indices, float* out,
                   int64_t n_bags, int64_t L, int64_t D, int mean,
                   cudaStream_t stream) {
  const unsigned blocks =
      (unsigned)((n_bags + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (n_bags <= (int64_t)kAsyncBagsPerSM * sm_count())
    embedding_bag_kernel<VEC, true><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
        table, indices, out, n_bags, L, D, mean);
  else
    embedding_bag_kernel<VEC, false><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
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

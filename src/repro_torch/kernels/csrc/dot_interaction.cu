// Pairwise-dot feature interaction, packed strict lower triangle, fp32.
//
// Replaces the TPU kernel src/repro/kernels/dot_interaction.py::
// dot_interaction_kernel (body _dot_int_kernel): per example, Z Z^T over
// the stacked (F, D) feature matrix with fp32 accumulation, keeping the
// strictly-lower triangle. The TPU kernel wrote the masked (F, F) square
// and left the triangle packing to XLA because its vector units have no
// in-kernel gather; here each thread writes its packed pairs directly, in
// np.tril_indices(F, -1) order: pair p = i*(i-1)/2 + j for j < i.
//
// Bound on the H100: bytes, and in practice latency and shared memory.
// At the serving shape (16, 31, 64) a call reads 127 KB and writes 30 KB
// (a 0.05 us bound): the launch, one round trip for the staging and the
// longest thread's FMA chains set the time. At the training batch
// (512, 31, 64) it reads 4.06 MB and writes 0.95 MB (a 1.5 us bound)
// against 15.2 M FMAs, and the shared-memory reads that feed the FMAs
// limit it: an SM's shared memory delivers 32 floats a cycle against 128
// FMAs, and a thread with a T x T tile needs 2/T floats an FMA. The
// kernel does fp32 FMAs on the CUDA cores (no TF32): DLRM computes in
// fp32, and each pair's sum is a fixed chain.
//
// Every pair's sum is one fixed chain, whatever tile, block or staging
// path computes it (the top MLP's gradient, and so the trained tables'
// bits, depend on it):
//   acc = 0.f; for d in 0..D-1: acc = fmaf(z_i[d], z_j[d], acc).
// Design. The (F, F) square is cut into T x T tiles of (i, j) pairs and
// only the tiles on or below the diagonal are enumerated: tile t of tile
// row a is t = a(a+1)/2 + c with c <= a, found once a thread. A thread
// owns one tile, reads its T rows of z_i and T rows of z_j once per 4 d
// as float4 from shared memory, and runs the tile's T*T independent
// chains side by side (pairs on or above the diagonal and rows past F are
// computed and dropped). T is 4 when there are four warps of such tiles
// for every SM (the training batch), else 2 (chains a quarter as long, on
// four times the threads: the serving batch). A block of 256 threads
// takes as many whole examples as spread the batch evenly over the SMs,
// or, when the examples alone would leave SMs idle, a slice of one
// example's tiles (the serving batch's 16 examples run on 144 blocks), so
// a launch at either shape puts work on every SM. All 256 threads stage
// the rows the block's tiles read with cp.async, every copy in flight at
// once: 16-byte copies where D % 4 == 0 and z is 16-byte aligned, 4-byte
// ones otherwise; no division by D per element. Rows are padded to an odd
// number of 16-byte chunks (4 * ((D / 4) | 1) floats; an odd number of
// words, D | 1, when D % 4 != 0), and row i of an example sits at shared
// row (i % T) * nt + i / T (nt tile rows): the tile rows a warp's tiles
// read are then consecutive shared rows on distinct banks, so a
// quarter-warp's 16-byte reads do not conflict. ptxas registers and
// spills: PERF.md section 6.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxShared = 48 * 1024;

// floats a staged row takes: an odd number of 16-byte chunks (float4
// reads) or of words (scalar reads), so consecutive rows start on distinct
// banks
__host__ __device__ __forceinline__ int row_stride(int D) {
  return D % 4 == 0 ? 4 * ((D / 4) | 1) : (D | 1);
}

__host__ __device__ __forceinline__ int tiles_of(int F, int T) {
  const int nt = (F + T - 1) / T;
  return nt * (nt + 1) / 2;
}

// the tile row a of tile t: the largest a with a(a+1)/2 <= t
__device__ __forceinline__ int tile_row(int t) {
  int a = (int)((sqrtf(8.f * (float)t + 1.f) - 1.f) * 0.5f);
  while (a * (a + 1) / 2 > t) --a;
  while ((a + 1) * (a + 2) / 2 <= t) ++a;
  return a;
}

template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

template <int T, bool V4>
__global__ void __launch_bounds__(kThreads)
dot_interaction_kernel(const float* __restrict__ z, float* __restrict__ out,
                       int64_t B, int F, int D, int n_tiles, int epb,
                       int tpb) {
  extern __shared__ __align__(16) float zs[];
  constexpr int kLogT = T == 4 ? 2 : 1;
  const int stride = row_stride(D);
  const int nt = (F + T - 1) / T;                  // tile rows
  const int rows_pad = nt * T;                     // staged rows an example
  const int64_t e0 = (int64_t)blockIdx.x * epb;
  const int n_ex = (int)((B - e0) < epb ? (B - e0) : epb);
  const int t_begin = blockIdx.y * tpb;
  const int t_end = min(n_tiles, t_begin + tpb);
  // the slice reads rows up to its last tile's; all F when it has them all
  const int rows = min(F, (tile_row(t_end - 1) + 1) * T);

  // stage rows [0, rows) of n_ex examples. Row i of example le goes to
  // shared row le * rows_pad + (i % T) * nt + i / T: the T rows a tile
  // reads sit nt rows apart, and the tile rows of one warp's tiles on
  // consecutive shared rows, so their 16-byte reads fall on distinct banks
  {
    const int cv = V4 ? D / 4 : D;                 // copies a row
    int r = threadIdx.x / cv, c = threadIdx.x - r * cv;
    const int dr = kThreads / cv, dc = kThreads - dr * cv;
    int le = r / rows, i = r - le * rows;
    const float* zb = z + e0 * F * D;
    while (le < n_ex) {
      const float* src = zb + (le * F + i) * D;
      float* dst = zs + (le * rows_pad + (i & (T - 1)) * nt + (i >> kLogT)) * stride;
      if (V4)
        cp_async<16>(dst + 4 * c, src + 4 * c);
      else
        cp_async<4>(dst + c, src + c);
      c += dc;
      i += dr;
      if (c >= cv) { c -= cv; ++i; }
      while (i >= rows) { i -= rows; ++le; }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncthreads();

  const int le = threadIdx.x / tpb;
  const int t = t_begin + (threadIdx.x - le * tpb);
  if (le >= n_ex || t >= t_end) return;
  const int a = tile_row(t), c = t - a * (a + 1) / 2;
  const int i0 = a * T, j0 = c * T;
  // shared offsets of the tile's rows; rows past what was staged (i >= F)
  // read stale words whose products are dropped below
  int xi[T], xj[T];
#pragma unroll
  for (int u = 0; u < T; ++u) {
    xi[u] = (le * rows_pad + u * nt + a) * stride;
    xj[u] = (le * rows_pad + u * nt + c) * stride;
  }
  float acc[T][T];
#pragma unroll
  for (int u = 0; u < T; ++u)
#pragma unroll
    for (int v = 0; v < T; ++v) acc[u][v] = 0.f;
  if (V4) {
    for (int d = 0; d < D; d += 4) {
      float4 p[T], q[T];
#pragma unroll
      for (int u = 0; u < T; ++u) {
        p[u] = *reinterpret_cast<const float4*>(zs + xi[u] + d);
        q[u] = *reinterpret_cast<const float4*>(zs + xj[u] + d);
      }
#pragma unroll
      for (int u = 0; u < T; ++u)
#pragma unroll
        for (int v = 0; v < T; ++v) acc[u][v] = fmaf(p[u].x, q[v].x, acc[u][v]);
#pragma unroll
      for (int u = 0; u < T; ++u)
#pragma unroll
        for (int v = 0; v < T; ++v) acc[u][v] = fmaf(p[u].y, q[v].y, acc[u][v]);
#pragma unroll
      for (int u = 0; u < T; ++u)
#pragma unroll
        for (int v = 0; v < T; ++v) acc[u][v] = fmaf(p[u].z, q[v].z, acc[u][v]);
#pragma unroll
      for (int u = 0; u < T; ++u)
#pragma unroll
        for (int v = 0; v < T; ++v) acc[u][v] = fmaf(p[u].w, q[v].w, acc[u][v]);
    }
  } else {
    for (int d = 0; d < D; ++d) {
      float p[T], q[T];
#pragma unroll
      for (int u = 0; u < T; ++u) {
        p[u] = zs[xi[u] + d];
        q[u] = zs[xj[u] + d];
      }
#pragma unroll
      for (int u = 0; u < T; ++u)
#pragma unroll
        for (int v = 0; v < T; ++v) acc[u][v] = fmaf(p[u], q[v], acc[u][v]);
    }
  }
  float* ob = out + (e0 + le) * ((int64_t)F * (F - 1) / 2);
#pragma unroll
  for (int u = 0; u < T; ++u) {
    const int i = i0 + u;
    if (i >= F) break;
    const int64_t base = (int64_t)i * (i - 1) / 2;
#pragma unroll
    for (int v = 0; v < T; ++v) {
      if (j0 + v < i) ob[base + j0 + v] = acc[u][v];
    }
  }
}

// bytes of shared memory one example takes at tile size T
size_t example_bytes(int F, int D, int T) {
  return (size_t)((F + T - 1) / T) * T * row_stride(D) * sizeof(float);
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

template <int T, bool V4>
cudaError_t launch(const float* z, float* out, int64_t B, int F, int D,
                   cudaStream_t stream) {
  const int sms = sm_count();
  const int n_tiles = tiles_of(F, T);
  const size_t ex_bytes = example_bytes(F, D, T);
  if (ex_bytes > kMaxShared) return cudaErrorInvalidValue;
  // whole examples a block, as many as spread B evenly over the SMs (one
  // block each), within a block's threads and the shared memory
  int64_t epb = (B + sms - 1) / sms;
  if (epb > kThreads / n_tiles) epb = kThreads / n_tiles;
  if (epb > (int64_t)(kMaxShared / ex_bytes)) epb = kMaxShared / ex_bytes;
  if (epb < 1) epb = 1;
  const int64_t groups = (B + epb - 1) / epb;
  // one example's tiles over several blocks when the groups leave SMs
  // idle, and always at most kThreads tiles a block
  int64_t slices = 1;
  if (epb == 1 && groups < sms) slices = (sms + groups - 1) / groups;
  if (slices > n_tiles) slices = n_tiles;
  if (slices < (n_tiles + kThreads - 1) / kThreads)
    slices = (n_tiles + kThreads - 1) / kThreads;
  const int tpb = (int)((n_tiles + slices - 1) / slices);
  slices = (n_tiles + tpb - 1) / tpb;
  dim3 grid((unsigned)groups, (unsigned)slices);
  dot_interaction_kernel<T, V4>
      <<<grid, kThreads, epb * ex_bytes, stream>>>(
          z, out, B, F, D, n_tiles, (int)epb, tpb);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dot_interaction_launch(const void* z, void* out, int64_t B,
                                      int64_t F, int64_t D, void* stream) {
  if (B == 0 || F < 2) return 0;
  const float* zp = static_cast<const float*>(z);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int f = (int)F, d = (int)D;
  const bool v4 = D % 4 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0;
  // 4 x 4 tiles when there are four warps of them for every SM
  const bool big = B * tiles_of(f, 4) >= (int64_t)sm_count() * 128;
  if (big)
    return (int)(v4 ? launch<4, true>(zp, o, B, f, d, s)
                    : launch<4, false>(zp, o, B, f, d, s));
  return (int)(v4 ? launch<2, true>(zp, o, B, f, d, s)
                  : launch<2, false>(zp, o, B, f, d, s));
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

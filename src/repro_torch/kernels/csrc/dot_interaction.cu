// Pairwise-dot feature interaction, packed strict lower triangle, fp32.
//
// Replaces the TPU kernel src/repro/kernels/dot_interaction.py::
// dot_interaction_kernel (body _dot_int_kernel): per example, Z Z^T over
// the stacked (F, D) feature matrix with fp32 accumulation, keeping the
// strictly-lower triangle. The TPU kernel wrote the masked (F, F) square
// and left the triangle packing to XLA because its vector units have no
// in-kernel gather; here each thread writes its packed pair directly, in
// np.tril_indices(F, -1) order: pair p = i*(i-1)/2 + j for j < i.
//
// Bound on the H100: bytes, barely — at the serving shape (B=16, F=31,
// D=64) one call reads 127 KB and writes 30 KB against 0.95 MFLOP, a
// fraction of a microsecond either way, so launch latency dominates. The
// kernel does fp32 FMAs on the CUDA cores (no TF32): the product is too
// small for tensor-core tiles to pay, and DLRM computes in fp32.
//
// Design: one block per example. The block stages Z in shared memory with
// a row stride of D+1 floats, so the 32 threads of a warp — which read one
// shared row i (a broadcast) and 32 different rows j — hit 32 different
// banks. Each thread then walks d in order with fmaf for its pairs.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
dot_interaction_kernel(const float* __restrict__ z, float* __restrict__ out,
                       int F, int D) {
  extern __shared__ float zs[];                  // F x (D + 1)
  const int64_t b = blockIdx.x;
  const int stride = D + 1;
  const float* zb = z + b * F * D;
  for (int t = threadIdx.x; t < F * D; t += blockDim.x) {
    zs[(t / D) * stride + (t % D)] = zb[t];
  }
  __syncthreads();
  const int P = F * (F - 1) / 2;
  float* ob = out + b * P;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    // row i of pair p: the largest i with i*(i-1)/2 <= p
    int i = (int)((1.0f + sqrtf(1.0f + 8.0f * (float)p)) * 0.5f);
    while (i * (i - 1) / 2 > p) --i;
    while ((i + 1) * i / 2 <= p) ++i;
    const int j = p - i * (i - 1) / 2;
    const float* zi = zs + i * stride;
    const float* zj = zs + j * stride;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc = fmaf(zi[d], zj[d], acc);
    ob[p] = acc;
  }
}

}  // namespace

extern "C" int dot_interaction_launch(const void* z, void* out, int64_t B,
                                      int64_t F, int64_t D, void* stream) {
  if (B == 0 || F < 2) return 0;
  const size_t smem = (size_t)F * (size_t)(D + 1) * sizeof(float);
  dot_interaction_kernel<<<(unsigned)B, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<float*>(out), (int)F, (int)D);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

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
// row.
//
// Bound on the H100: bytes. Per live entry it reads one D*4-byte gradient
// row and reads and writes one scattered table row and one accumulator,
// against a few FLOPs per element.
//
// Design: one warp per entry; lane l owns columns l, l+32, ... and reads
// its gradients straight from gsum (each is used twice, from L1). The
// arithmetic is the fused kernel's (fused_bag_backward_adagrad.cu,
// update_row) operation for operation: the same lane-strided
// __fadd_rn/__fmul_rn partial sums of g^2, the same butterfly shuffle
// reduction, __fdiv_rn by D, rsqrtf, and __fmul_rn/__fsub_rn so nvcc fuses
// nothing into an FMA. So wherever the dedup's sums carry the fused
// kernel's bits (it adds each row's gradients in the same sorted order),
// the two-pass update equals the fused one bit for bit. The TPU's limits
// do not carry over: no scalar-prefetch SMEM cap on uniq, no D % 128
// lanes. Row offsets are 64-bit: row * D * 4 passes 2^32 bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rowwise_adagrad_kernel(float* __restrict__ table, float* __restrict__ accum,
                       const int32_t* __restrict__ uniq,
                       const float* __restrict__ gsum, int64_t N, int64_t D,
                       float lr, float eps) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t entry = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (entry >= N) return;                          // warp-uniform
  const int32_t row = uniq[entry];
  if (row < 0) return;                             // not a run head
  const float* g = gsum + entry * D;
  float sq = 0.f;
  for (int64_t c = lane; c < D; c += 32) sq = __fadd_rn(sq, __fmul_rn(g[c], g[c]));
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(kFull, sq, off);
  const float acc = __fadd_rn(accum[row], __fdiv_rn(sq, (float)D));
  const float rs = rsqrtf(__fadd_rn(acc, eps));
  float* w = table + (int64_t)row * D;
  for (int64_t c = lane; c < D; c += 32)
    w[c] = __fsub_rn(w[c], __fmul_rn(__fmul_rn(lr, g[c]), rs));
  if (lane == 0) accum[row] = acc;
}

}  // namespace

extern "C" int rowwise_adagrad_launch(void* table, void* accum,
                                      const void* uniq, const void* gsum,
                                      int64_t N, int64_t D, float lr,
                                      float eps, void* stream) {
  if (N == 0) return 0;
  const int64_t blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
  rowwise_adagrad_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(table), static_cast<float*>(accum),
      static_cast<const int32_t*>(uniq), static_cast<const float*>(gsum), N,
      D, lr, eps);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

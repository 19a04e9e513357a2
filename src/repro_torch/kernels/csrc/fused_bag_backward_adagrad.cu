// Fused sparse backward with row-wise AdaGrad, fp32, in place.
//
// Replaces the TPU kernel src/repro/kernels/sparse_update.py::
// fused_bag_backward_adagrad_segments_kernel (body _fused_kernel) with two
// entry points over one per-row body:
//
//   fused_bag_backward_adagrad_launch           one plan, the S = 1 case
//                                               (fused_bag_backward_adagrad_kernel);
//   fused_bag_backward_adagrad_segments_launch  S per-owner segments of one
//                                               plan (S > 1).
//
// For each live entry i of a SparsePlan (unique_rows[i] >= 0):
//   g   = sum of pooled[bag_ids[j]] for j in [bag_offsets[i], bag_offsets[i+1])
//         added in that order, in fp32;
//   acc = accum[row] + mean(g^2);   w = w - lr * g * rsqrt(acc + eps);
// and both are written back in place (the TPU kernel aliases its outputs to
// its inputs). No per-lookup gradient tensor exists: the only full-width
// reads are the pooled (B*F, D) bag gradients and the touched table rows.
//
// Bound on the H100: bytes. Per touched row the kernel reads and writes one
// D*4-byte row and one accumulator and reads one pooled row per (row, bag)
// pair, against a few FLOPs per element; the rows are scattered over a
// table of tens of GB, so what counts is how many row reads are in flight.
//
// Design: one warp per plan entry (per (s, i) entry of the S x C segment
// grid for the segmented form). Entries past the unique count
// (unique_rows[i] < 0) return at once, so the grid covers the plan's U
// entries and no host sync is needed to learn the unique count. The warp
// loads up to 32 bag ids with one coalesced read and broadcasts them with
// __shfl_sync; each lane owns the columns lane, lane+32, ... and keeps their
// running sums in the warp's slice of shared memory (D floats). The bags
// are walked in CSR order, so each column's sum is added in the plain
// version's order (repro_torch/kernels/ref.py::bag_grad_sums_abs) and agrees
// with it bit for bit. mean(g^2) is a warp shuffle reduction, whose order
// differs from torch.mean's; the update uses __fmul_rn/__fsub_rn so that
// nvcc does not fuse it into an FMA the plain version does not have. Row
// offsets are computed in 64 bits: row * D * 4 passes 2^32 bytes long before
// row ids leave int32. Unique rows are distinct, so no two warps write the
// same row.
//
// Segments: entry (s, i) updates row seg_base[s] + seg_rows[s*C + i] from
// the bag slice [seg_offsets[s*(C+1) + i], seg_offsets[s*(C+1) + i + 1]),
// absolute positions into the shared bag_ids. The segments are disjoint row
// ranges of one plan (split_plan_by_owner), so again no two warps write one
// row, and every row goes through the same per-row body as in the one-plan
// kernel: each row's bits do not depend on how the plan was segmented. What
// the TPU kernel needed and this one does not: the plan arrays in
// scalar-prefetch SMEM (a block loads its own entry) and D % 128 lanes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

// One warp's update of one row from its CSR slice [lo, hi); g is the warp's
// D floats of shared memory. Shared by both kernels, so a row's result is
// the same bits whichever kernel runs it.
__device__ __forceinline__ void update_row(
    float* __restrict__ table, float* __restrict__ accum, int64_t row,
    int32_t lo, int32_t hi, const int32_t* __restrict__ bag_ids,
    const float* __restrict__ pooled, float* g, int64_t D, float lr,
    float eps, int lane) {
  for (int64_t c = lane; c < D; c += 32) g[c] = 0.f;
  for (int32_t j0 = lo; j0 < hi; j0 += 32) {
    const int n = (hi - j0) < 32 ? (hi - j0) : 32;
    const int32_t mine = lane < n ? bag_ids[j0 + lane] : 0;
    for (int t = 0; t < n; ++t) {
      const int64_t bag = __shfl_sync(kFull, mine, t);
      const float* src = pooled + bag * D;
      for (int64_t c = lane; c < D; c += 32) g[c] = __fadd_rn(g[c], src[c]);
    }
  }
  float sq = 0.f;
  for (int64_t c = lane; c < D; c += 32) sq = __fadd_rn(sq, __fmul_rn(g[c], g[c]));
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(kFull, sq, off);
  const float acc = __fadd_rn(accum[row], __fdiv_rn(sq, (float)D));
  const float rs = rsqrtf(__fadd_rn(acc, eps));
  float* w = table + row * D;
  for (int64_t c = lane; c < D; c += 32)
    w[c] = __fsub_rn(w[c], __fmul_rn(__fmul_rn(lr, g[c]), rs));
  if (lane == 0) accum[row] = acc;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_bag_backward_adagrad_kernel(float* __restrict__ table,
                                  float* __restrict__ accum,
                                  const int32_t* __restrict__ unique_rows,
                                  const int32_t* __restrict__ bag_offsets,
                                  const int32_t* __restrict__ bag_ids,
                                  const float* __restrict__ pooled,
                                  int64_t U, int64_t D, float lr, float eps) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t entry = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (entry >= U) return;                          // warp-uniform
  const int32_t row = unique_rows[entry];
  if (row < 0) return;                             // past the unique count
  update_row(table, accum, row, bag_offsets[entry], bag_offsets[entry + 1],
             bag_ids, pooled, smem + (int64_t)warp * D, D, lr, eps, lane);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_bag_backward_adagrad_segments_kernel(
    float* __restrict__ table, float* __restrict__ accum,
    const int32_t* __restrict__ seg_rows,
    const int32_t* __restrict__ seg_offsets,
    const int32_t* __restrict__ bag_ids, const float* __restrict__ pooled,
    const int32_t* __restrict__ seg_base, int64_t S, int64_t C, int64_t D,
    float lr, float eps) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t entry = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (entry >= S * C) return;                      // warp-uniform
  const int32_t local = seg_rows[entry];
  if (local < 0) return;                           // a pad of its segment
  const int64_t s = entry / C;
  const int64_t i = entry - s * C;
  const int32_t* offs = seg_offsets + s * (C + 1) + i;
  update_row(table, accum, (int64_t)seg_base[s] + local, offs[0], offs[1],
             bag_ids, pooled, smem + (int64_t)warp * D, D, lr, eps, lane);
}

// each warp keeps its row's D fp32 sums in shared memory; past the 48 KB a
// launch gets by default the kernel opts in, up to the card's limit, and a
// D beyond that fails here as an invalid argument
template <typename K>
cudaError_t opt_in_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

extern "C" int fused_bag_backward_adagrad_launch(
    void* table, void* accum, const void* unique_rows, const void* bag_offsets,
    const void* bag_ids, const void* pooled, int64_t U, int64_t D, float lr,
    float eps, void* stream) {
  if (U == 0) return 0;
  const int64_t blocks = (U + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const size_t smem = (size_t)kWarpsPerBlock * (size_t)D * sizeof(float);
  const cudaError_t err = opt_in_smem(fused_bag_backward_adagrad_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  fused_bag_backward_adagrad_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32,
                                      smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(table), static_cast<float*>(accum),
      static_cast<const int32_t*>(unique_rows),
      static_cast<const int32_t*>(bag_offsets),
      static_cast<const int32_t*>(bag_ids), static_cast<const float*>(pooled),
      U, D, lr, eps);
  return (int)cudaGetLastError();
}

extern "C" int fused_bag_backward_adagrad_segments_launch(
    void* table, void* accum, const void* seg_rows, const void* seg_offsets,
    const void* bag_ids, const void* pooled, const void* seg_base, int64_t S,
    int64_t C, int64_t D, float lr, float eps, void* stream) {
  if (S * C == 0) return 0;
  const int64_t blocks = (S * C + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const size_t smem = (size_t)kWarpsPerBlock * (size_t)D * sizeof(float);
  const cudaError_t err =
      opt_in_smem(fused_bag_backward_adagrad_segments_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  fused_bag_backward_adagrad_segments_kernel<<<
      (unsigned)blocks, kWarpsPerBlock * 32, smem,
      static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(table), static_cast<float*>(accum),
      static_cast<const int32_t*>(seg_rows),
      static_cast<const int32_t*>(seg_offsets),
      static_cast<const int32_t*>(bag_ids), static_cast<const float*>(pooled),
      static_cast<const int32_t*>(seg_base), S, C, D, lr, eps);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Causal flash attention, forward: O = softmax(Q K^T / sqrt(dh) + causal
// mask) V on (b, h, s, dh) fp32 or bf16 tensors, fp32 arithmetic.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_kernel (body _flash_kernel) and keeps its arithmetic:
// fp32 scores of the pre-scaled query, -1e30 above the diagonal, an online
// softmax with fp32 running max m, denominator l and accumulator, each key
// tile folded in as m' = max(m, rowmax s), p = exp(s - m'), l' = l e^(m-m')
// + sum p, acc' = acc e^(m-m') + p V; the result is acc / max(l, 1e-30) in
// the input's dtype. Not its block layout: the TPU kernel streams K/V tiles
// by DMA into VMEM for one (b, h, q-block) grid step at a time and pads dh
// to the 128-lane width and s to the block.
//
// Bound on the H100: operations. A call does 4 b h dh s(s+1)/2 FLOPs (QK^T
// and PV over the causal half) on 4 b h s dh elements of input and output:
// at (1, 32, 8192, 64) that is 0.275 TFLOP against 134 MB in bf16, 0.278 ms
// at the dense bf16 tensor-core rate (989 TFLOP/s) and 0.04 ms of memory
// traffic. This first kernel does its FMAs on the CUDA cores in fp32 (67
// TFLOP/s peak), so it sits well above that bound; wgmma with bf16 operands
// for QK^T and PV, TMA loads and a pipelined K/V ring are the redesign.
//
// Design: one block of 8 warps per (b*h, 64-query tile); the grid walks the
// tiles heaviest first (tile n_qt-1 has the longest causal prefix). The
// block stages its pre-scaled Q tile once and then, per 64-key tile up to
// and including the diagonal one (the causal bound), K transposed (row
// stride 65: conflict-free column reads and only 2-way conflicts on the
// transposing stores) and V in shared memory, converted to fp32. Each warp
// owns 8 query rows: lane j scores keys j and j+32 against them, the row
// max and sum reduce by warp shuffles, the warp's probabilities go through
// its own slice of shared memory (8 rows of a key side by side, read back
// as two float4 broadcasts), and lane j accumulates dh/32 contiguous output
// columns of the 8 rows in registers. Only the diagonal tile is masked; a
// ragged last tile is zero-filled, and its keys past s lie above every
// valid query, so the causal mask covers them. Rows past s are not stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;               // query rows per block
constexpr int kBK = 64;               // keys per tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBQ / kWarps;   // query rows per warp
constexpr int kKtStride = kBK + 1;    // row stride of the transposed K tile
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * DH + (size_t)DH * kKtStride +
                          (size_t)kBK * DH + (size_t)kWarps * kBK * kRows);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       float scale) {
  constexpr int kCols = DH / 32;               // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                            // kBQ x DH, pre-scaled
  float* kt = qs + kBQ * DH;                   // DH x kKtStride (K^T)
  float* vs = kt + DH * kKtStride;             // kBK x DH
  float* ps = vs + kBK * DH;                   // kWarps x kBK x kRows

  const int n_qt = (S + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - (int)blockIdx.x;   // heaviest tiles first
  const int q0 = qt * kBQ;
  const int64_t base = (int64_t)blockIdx.y * S * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * kRows;                 // the warp's first row

  for (int i = threadIdx.x * 4; i < kBQ * DH; i += kThreads * 4) {
    const int r = i / DH, c = i % DH;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < S) x = load4(q + base + (int64_t)(q0 + r) * DH + c);
    *reinterpret_cast<float4*>(qs + i) =
        make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
  }

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }
  float* pw = ps + warp * kBK * kRows;

  for (int kt_i = 0; kt_i <= qt; ++kt_i) {     // the causal bound
    const int k0 = kt_i * kBK;
    __syncthreads();              // every warp is done with the last tile
    for (int i = threadIdx.x * 4; i < kBK * DH; i += kThreads * 4) {
      const int r = i / DH, c = i % DH;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + r < S) {
        const int64_t off = base + (int64_t)(k0 + r) * DH + c;
        kx = load4(k + off);
        vx = load4(v + off);
      }
      kt[(c + 0) * kKtStride + r] = kx.x;
      kt[(c + 1) * kKtStride + r] = kx.y;
      kt[(c + 2) * kKtStride + r] = kx.z;
      kt[(c + 3) * kKtStride + r] = kx.w;
      *reinterpret_cast<float4*>(vs + i) = vx;
    }
    __syncthreads();

    // scores of the warp's 8 rows against keys lane and lane + 32
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float ka[4], kb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ka[j] = kt[(d + j) * kKtStride + lane];
        kb[j] = kt[(d + j) * kKtStride + lane + 32];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(
            qs + (r0 + r) * DH + d);
        s[r][0] = fmaf(qv.x, ka[0], s[r][0]);
        s[r][0] = fmaf(qv.y, ka[1], s[r][0]);
        s[r][0] = fmaf(qv.z, ka[2], s[r][0]);
        s[r][0] = fmaf(qv.w, ka[3], s[r][0]);
        s[r][1] = fmaf(qv.x, kb[0], s[r][1]);
        s[r][1] = fmaf(qv.y, kb[1], s[r][1]);
        s[r][1] = fmaf(qv.z, kb[2], s[r][1]);
        s[r][1] = fmaf(qv.w, kb[3], s[r][1]);
      }
    }
    if (kt_i == qt) {                          // the diagonal tile
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int qq = q0 + r0 + r;
        if (k0 + lane > qq) s[r][0] = kMasked;
        if (k0 + lane + 32 > qq) s[r][1] = kMasked;
      }
    }

    // online softmax, then this tile's probabilities into the warp's slice
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float p0 = __expf(s[r][0] - m_new);
      const float p1 = __expf(s[r][1] - m_new);
      const float corr = __expf(m[r] - m_new);   // 0 on the first tile
      l[r] = l[r] * corr + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= corr;
      s[r][0] = p0;
      s[r][1] = p1;
    }
    *reinterpret_cast<float4*>(pw + lane * kRows) =
        make_float4(s[0][0], s[1][0], s[2][0], s[3][0]);
    *reinterpret_cast<float4*>(pw + lane * kRows + 4) =
        make_float4(s[4][0], s[5][0], s[6][0], s[7][0]);
    *reinterpret_cast<float4*>(pw + (lane + 32) * kRows) =
        make_float4(s[0][1], s[1][1], s[2][1], s[3][1]);
    *reinterpret_cast<float4*>(pw + (lane + 32) * kRows + 4) =
        make_float4(s[4][1], s[5][1], s[6][1], s[7][1]);
    __syncwarp();

    // acc += P V over the tile's keys, lane's contiguous columns
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(pw + j * kRows);
      const float4 pb = *reinterpret_cast<const float4*>(pw + j * kRows + 4);
      const float p[kRows] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
      float vv[kCols];
      if constexpr (kCols == 4) {
        const float4 x =
            *reinterpret_cast<const float4*>(vs + j * DH + lane * 4);
        vv[0] = x.x; vv[1] = x.y; vv[2] = x.z; vv[3] = x.w;
      } else {
        const float2 x =
            *reinterpret_cast<const float2*>(vs + j * DH + lane * 2);
        vv[0] = x.x; vv[1] = x.y;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[r][c] = fmaf(p[r], vv[c], acc[r][c]);
    }
    __syncwarp();                 // the slice is rewritten on the next tile
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qq = q0 + r0 + r;
    if (qq >= S) continue;
    const float den = fmaxf(l[r], 1e-30f);
    T* orow = o + base + (int64_t)qq * DH + lane * kCols;
#pragma unroll
    for (int c = 0; c < kCols; ++c) store1(orow + c, acc[r][c] / den);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int64_t BH, int64_t S, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  auto kern = flash_attention_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((S + kBQ - 1) / kBQ), (unsigned)BH);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), (int)S, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: (BH, S, DH) contiguous, DH 64 or 128, one dtype (is_bf16:
// bf16, else fp32); scale multiplies q (1/sqrt of the unpadded dh).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int64_t BH,
                                      int64_t S, int64_t DH, int64_t is_bf16,
                                      float scale, void* stream) {
  if (BH == 0 || S == 0) return 0;
  if (BH > 65535 || S > (int64_t)INT32_MAX / 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (DH == 64) {
    err = is_bf16 ? launch<__nv_bfloat16, 64>(q, k, v, o, BH, S, scale, st)
                  : launch<float, 64>(q, k, v, o, BH, S, scale, st);
  } else if (DH == 128) {
    err = is_bf16 ? launch<__nv_bfloat16, 128>(q, k, v, o, BH, S, scale, st)
                  : launch<float, 128>(q, k, v, o, BH, S, scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Causal flash attention, backward: dQ, dK, dV of O = softmax(Q K^T scale
// + causal mask) V on (b*h, s, dh) bf16 or fp32 tensors, from Q, K, V, O,
// dO and the forward's per-row log-sum-exp (flash_attention.cu, in log2
// units: lse2 = log2 sum_j 2^(s_j scale log2 e)).
//
// Replaces no TPU kernel. The reference never differentiates its Pallas
// kernel (src/repro/kernels/ops.py:319); its training gradient is XLA's
// autodiff of nn/layers.py::blockwise_attention. The port's train mode
// runs the forward kernel, so its gradient is a kernel too. It is the
// FlashAttention-2 backward (Dao 2023, Algorithm 2) without the score
// matrix in device memory:
//   delta = rowsum(dO o O) in fp32 (flash_bwd_delta_kernel);
//   per (b*h, 64-key tile), over the query tiles from the diagonal down
//   (flash_bwd_dkdv_kernel): S = Q K^T, P = 2^(S scale log2e - lse2)
//   under the causal mask, dP = dO V^T, dS = P o (dP - delta); dV += P^T dO
//   with P rounded to bf16 first for bf16 inputs (as the forward rounds it
//   before P V), dK += dS^T Q, scaled by `scale` at the end;
//   per (b*h, 64-query tile), over the key tiles up to the diagonal, in a
//   pass of its own (flash_bwd_dq_kernel): the same S, P, dP, dS, then
//   dQ += dS K, scaled by `scale` at the end.
// Every output element is summed by one thread in a fixed order, and no
// float output is written by two blocks: no atomics, so two launches on
// the same inputs give the same bits (the launcher's resume and chaos
// runs are held bit-equal to a plain run). Plain version:
// ref.flash_attention_bwd_ref, the same formulas in torch ops with P
// rounded where this rounds it.
//
// Bound on the H100: operations. A call does about 2.5x the forward's
// FLOPs (dV, dP, dK, dQ and the recomputed S over the causal half: 5 of
// the forward's 2 products): at (4, 32, 4096, 64) 0.687 TFLOP, 0.695 ms at
// the dense bf16 tensor-core rate (989 TFLOP/s); its 8 b h s dh elements
// of input and output (Q, K, V, O, dO read, dQ, dK, dV written) are
// 0.54 GB in bf16, 0.16 ms at 3.35 TB/s. Design: a first, simple kernel,
// right before fast: fp32 FMAs on the CUDA cores
// (67 TFLOP/s peak, and S and dP are computed twice, once in each pass),
// every tile converted to fp32 in shared memory with rows padded by 4
// floats (16-byte loads without bank conflicts between rows). 256 threads
// as a 16 x 16 grid: in the products over dh each thread owns 4 query rows
// and 4 keys (strided by 16, so a warp reads 2 rows of one operand, a
// broadcast, and 16 of the other); in the products over queries or keys it
// owns 4 output rows and dh/16 columns, read as 16-byte vectors. Tiles
// past s are zero-filled: their queries carry lse = +inf (P = 0) and their
// keys lie above every valid query. Rows past s are not stored. wgmma,
// TMA and a tensor-core P are for a later redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;                // queries and keys per tile
constexpr int kThreads = 256;         // a 16 x 16 grid
constexpr int kPS = kB + 4;           // row stride of the P / dS tiles

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

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// P as the product P^T dO takes it: bf16 inputs round it to bf16 (the
// forward rounds P before P V), fp32 inputs keep it
__device__ __forceinline__ float round_p(float p, const float*) { return p; }
__device__ __forceinline__ float round_p(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(p));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float comp(float4 v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

template <int DH>
struct Tile {
  static constexpr int kStride = DH + 4;          // row stride, floats
  static constexpr int kFloats = kB * kStride;
  static constexpr int kCols = DH / 16;           // output columns a thread
};

// rows r0 .. r0 + 63 of a (S, DH) matrix into shared memory as fp32, row
// stride DH + 4; rows past S are zeros. Consecutive threads take
// consecutive rows (a 4-column group each), so the stores into the padded
// rows fall in distinct banks.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int S) {
  constexpr int kStride = Tile<DH>::kStride;
  for (int i = threadIdx.x; i < kB * DH / 4; i += kThreads) {
    const int r = i % kB, c = (i / kB) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S) x = load4(src + (int64_t)(r0 + r) * DH + c);
    store4(dst + r * kStride + c, x);
  }
}

// lse and delta of query rows q0 .. q0 + 63; rows past S get lse = +inf,
// so that P = 2^(x - inf) = 0 there, and delta = 0
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const float* lse,
                                          const float* delta, int q0,
                                          int S) {
  if (threadIdx.x < kB) {
    const bool in = q0 + (int)threadIdx.x < S;
    lse_s[threadIdx.x] = in ? lse[q0 + threadIdx.x] : INFINITY;
    delta_s[threadIdx.x] = in ? delta[q0 + threadIdx.x] : 0.f;
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] B[tx + 16 j][d] over one pair of tiles
template <int DH>
__device__ __forceinline__ void tile_dots(float (&acc)[4][4], const float* a,
                                          const float* b, int ty, int tx) {
  constexpr int kStride = Tile<DH>::kStride;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = load4(a + (ty + 16 * i) * kStride + d);
      bv[i] = load4(b + (tx + 16 * i) * kStride + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = dot4(av[i], bv[j], acc[i][j]);
  }
}

// P and dS of query rows ty + 16 i against keys tx + 16 j of one tile
// pair, from S and dP (in place: s becomes P, dp becomes dS); `diag` masks
// keys above the diagonal (the two tiles start at the same position)
__device__ __forceinline__ void probs(float (&s)[4][4], float (&dp)[4][4],
                                      const float* lse_s,
                                      const float* delta_s, int ty, int tx,
                                      bool diag, float scale_log2) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = ty + 16 * i;
    const float l = lse_s[qi], dl = delta_s[qi];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float p = exp2f(s[i][j] * scale_log2 - l);
      if (diag && tx + 16 * j > qi) p = 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - dl);
    }
  }
}

// delta[r] = sum_c dO[r][c] O[r][c] in fp32, one warp a row
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, int64_t rows) {
  constexpr int kPer = DH / 32;
  const int64_t r = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;                  // the whole warp
  const T* orow = o + r * DH + lane * kPer;
  const T* drow = dout + r * DH + lane * kPer;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < kPer; ++c)
    acc = fmaf(to_float(drow[c]), to_float(orow[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[r] = acc;
}

template <int DH>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (4 * Tile<DH>::kFloats + 2 * kB * kPS + 2 * kB);
}

template <int DH>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * Tile<DH>::kFloats + kB * kPS + 2 * kB);
}

// dK and dV of one (b*h, key tile): grid (b*h, key tiles), key tile 0
// (the most query tiles) first
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int S, float scale,
            float scale_log2) {
  using L = Tile<DH>;
  constexpr int kCols = L::kCols;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + L::kFloats;
  float* qs = vs + L::kFloats;
  float* dos = qs + L::kFloats;
  float* pt = dos + L::kFloats;           // P^T: keys x queries
  float* dst = pt + kB * kPS;             // dS^T
  float* lse_s = dst + kB * kPS;
  float* delta_s = lse_s + kB;

  const int kt = blockIdx.y;
  const int k0 = kt * kB;
  const int n_t = (S + kB - 1) / kB;
  const int64_t row0 = (int64_t)blockIdx.x * S;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<T, DH>(ks, k + row0 * DH, k0, S);
  load_tile<T, DH>(vs, v + row0 * DH, k0, S);

  float acc_dk[4][kCols], acc_dv[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_dk[i][c] = acc_dv[i][c] = 0.f;

  for (int qt = kt; qt < n_t; ++qt) {
    const int q0 = qt * kB;
    __syncthreads();                      // the last tile's readers are done
    load_tile<T, DH>(qs, q + row0 * DH, q0, S);
    load_tile<T, DH>(dos, dout + row0 * DH, q0, S);
    load_rows(lse_s, delta_s, lse + row0, delta + row0, q0, S);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dots<DH>(s, qs, ks, ty, tx);
    tile_dots<DH>(dp, dos, vs, ty, tx);
    probs(s, dp, lse_s, delta_s, ty, tx, qt == kt, scale_log2);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int at = (tx + 16 * j) * kPS + ty + 16 * i;
        pt[at] = round_p(s[i][j], q);
        dst[at] = dp[i][j];
      }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q: keys ty + 16 i, columns
    // 64 n + 4 tx .. + 3
#pragma unroll 2
    for (int qq = 0; qq < kB; qq += 4) {
      float4 pa[4], sa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = load4(pt + (ty + 16 * i) * kPS + qq);
        sa[i] = load4(dst + (ty + 16 * i) * kPS + qq);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float dov[kCols], qv[kCols];
#pragma unroll
        for (int n = 0; n < kCols / 4; ++n) {
          const int at = (qq + e) * L::kStride + 64 * n + 4 * tx;
          const float4 a = load4(dos + at), b = load4(qs + at);
          dov[4 * n] = a.x; dov[4 * n + 1] = a.y;
          dov[4 * n + 2] = a.z; dov[4 * n + 3] = a.w;
          qv[4 * n] = b.x; qv[4 * n + 1] = b.y;
          qv[4 * n + 2] = b.z; qv[4 * n + 3] = b.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pe = comp(pa[i], e), se = comp(sa[i], e);
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            acc_dv[i][c] = fmaf(pe, dov[c], acc_dv[i][c]);
            acc_dk[i][c] = fmaf(se, qv[c], acc_dk[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= S) continue;
    T* dkrow = dk + (row0 + key) * DH;
    T* dvrow = dv + (row0 + key) * DH;
#pragma unroll
    for (int n = 0; n < kCols / 4; ++n) {
      const int c = 64 * n + 4 * tx;
      store4(dkrow + c, make_float4(acc_dk[i][4 * n] * scale,
                                    acc_dk[i][4 * n + 1] * scale,
                                    acc_dk[i][4 * n + 2] * scale,
                                    acc_dk[i][4 * n + 3] * scale));
      store4(dvrow + c, make_float4(acc_dv[i][4 * n], acc_dv[i][4 * n + 1],
                                    acc_dv[i][4 * n + 2],
                                    acc_dv[i][4 * n + 3]));
    }
  }
}

// dQ of one (b*h, query tile): grid (b*h, query tiles), the last query
// tile (the most key tiles) first
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int S, float scale, float scale_log2) {
  using L = Tile<DH>;
  constexpr int kCols = L::kCols;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + L::kFloats;
  float* ks = dos + L::kFloats;
  float* vs = ks + L::kFloats;
  float* dss = vs + L::kFloats;           // dS: queries x keys
  float* lse_s = dss + kB * kPS;
  float* delta_s = lse_s + kB;

  const int n_t = (S + kB - 1) / kB;
  const int qt = n_t - 1 - (int)blockIdx.y;
  const int q0 = qt * kB;
  const int64_t row0 = (int64_t)blockIdx.x * S;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<T, DH>(qs, q + row0 * DH, q0, S);
  load_tile<T, DH>(dos, dout + row0 * DH, q0, S);
  load_rows(lse_s, delta_s, lse + row0, delta + row0, q0, S);

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    __syncthreads();                      // the last tile's readers are done
    load_tile<T, DH>(ks, k + row0 * DH, kt * kB, S);
    load_tile<T, DH>(vs, v + row0 * DH, kt * kB, S);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dots<DH>(s, qs, ks, ty, tx);
    tile_dots<DH>(dp, dos, vs, ty, tx);
    probs(s, dp, lse_s, delta_s, ty, tx, kt == qt, scale_log2);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dss[(ty + 16 * i) * kPS + tx + 16 * j] = dp[i][j];
    __syncthreads();

    // dQ += dS K: query rows ty + 16 i, columns 64 n + 4 tx .. + 3
#pragma unroll 2
    for (int kk = 0; kk < kB; kk += 4) {
      float4 sa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sa[i] = load4(dss + (ty + 16 * i) * kPS + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float kv[kCols];
#pragma unroll
        for (int n = 0; n < kCols / 4; ++n) {
          const float4 a =
              load4(ks + (kk + e) * L::kStride + 64 * n + 4 * tx);
          kv[4 * n] = a.x; kv[4 * n + 1] = a.y;
          kv[4 * n + 2] = a.z; kv[4 * n + 3] = a.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float se = comp(sa[i], e);
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            acc[i][c] = fmaf(se, kv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    T* dqrow = dq + (row0 + row) * DH;
#pragma unroll
    for (int n = 0; n < kCols / 4; ++n)
      store4(dqrow + 64 * n + 4 * tx,
             make_float4(acc[i][4 * n] * scale, acc[i][4 * n + 1] * scale,
                         acc[i][4 * n + 2] * scale,
                         acc[i][4 * n + 3] * scale));
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   void* dq, void* dk, void* dv, float* delta, int64_t BH,
                   int64_t S, float scale, cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  const int64_t rows = BH * S;
  flash_bwd_delta_kernel<T, DH>
      <<<(unsigned)((rows + 7) / 8), kThreads, 0, stream>>>(
          static_cast<const T*>(o), do_, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the same fp32 product as the forward's and ref.flash_attention_tiled_ref's
  const float scale_log2 = scale * 1.4426950408889634f;
  const dim3 grid((unsigned)BH, (unsigned)((S + kB - 1) / kB));
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dkdv_smem<DH>());
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, DH>
      <<<grid, kThreads, dkdv_smem<DH>(), stream>>>(
          q_, k_, v_, do_, lse, delta, static_cast<T*>(dk),
          static_cast<T*>(dv), (int)S, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dq_smem<DH>());
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, DH><<<grid, kThreads, dq_smem<DH>(), stream>>>(
      q_, k_, v_, do_, lse, delta, static_cast<T*>(dq), (int)S, scale,
      scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: (BH, S, DH) contiguous, DH 64 or 128, one
// dtype (is_bf16: bf16, else fp32), 16-byte aligned; lse: (BH, S) fp32 as
// the forward stored it (log2 units); delta: (BH, S) fp32 scratch; scale
// is 1/sqrt of the unpadded dh. Three launches on `stream`: delta, dK/dV,
// dQ. Returns a cudaError.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, void* dq, void* dk, void* dv,
    float* delta, int64_t BH, int64_t S, int64_t DH, int64_t is_bf16,
    float scale, void* stream) {
  if (BH == 0 || S == 0) return 0;
  if (BH > INT32_MAX || (S + kB - 1) / kB > 65535 || S > INT32_MAX / 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (DH == 64) {
    err = is_bf16 ? launch<__nv_bfloat16, 64>(q, k, v, o, dout, lse, dq, dk,
                                              dv, delta, BH, S, scale, st)
                  : launch<float, 64>(q, k, v, o, dout, lse, dq, dk, dv,
                                      delta, BH, S, scale, st);
  } else if (DH == 128) {
    err = is_bf16 ? launch<__nv_bfloat16, 128>(q, k, v, o, dout, lse, dq, dk,
                                               dv, delta, BH, S, scale, st)
                  : launch<float, 128>(q, k, v, o, dout, lse, dq, dk, dv,
                                       delta, BH, S, scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

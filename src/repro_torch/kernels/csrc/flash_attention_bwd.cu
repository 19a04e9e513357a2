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
// matrix in device memory, in three launches:
//   delta = rowsum(dO o O) in fp32 (flash_bwd_delta_kernel);
//   per (b*h, key tile), over the query tiles from the diagonal down
//   (the dK/dV pass): S = Q K^T, P = 2^(S scale log2e - lse2) under the
//   causal mask, dP = dO V^T, dS = P o (dP - delta); dV += P^T dO,
//   dK += dS^T Q, scaled by `scale` at the end;
//   per (b*h, query tile), over the key tiles up to the diagonal, in a
//   pass of its own (the dQ pass): the same S, P, dP, dS, then dQ += dS K,
//   scaled by `scale` at the end.
// Every output element is summed by one block in a fixed order, and no
// float output is written by two blocks: no atomics, so two launches on
// the same inputs give the same bits (the launcher's resume and chaos
// runs are held bit-equal to a plain run). The price is that both passes
// compute S and dP: 7 products where the function needs 5. For bf16
// inputs P and dS are rounded to bf16 before the products that take them
// (P^T dO; dS^T Q and dS K), as the forward rounds P before P V and as
// the tensor cores need; every product sums in fp32. fp32 inputs round
// nothing. Plain version: ref.flash_attention_bwd_ref, the same formulas
// in torch ops, rounded where this rounds.
//
// Bound on the H100: operations. The function is 5 products over the
// causal half (S, dP, dV, dK, dQ: 2.5x the forward's FLOPs): at
// (4, 32, 4096, 64) 0.687 TFLOP, 0.695 ms at the dense bf16 tensor-core
// rate (989 TFLOP/s); the two passes do 7 (0.96 TFLOP), 0.97 ms at that
// rate. Its 8 b h s dh elements of input and output (Q, K, V, O, dO read,
// dQ, dK, dV written) are 0.54 GB in bf16, 0.16 ms at 3.35 TB/s.
//
// bf16 (sm90::flash_bwd_dkdv_kernel_sm90, flash_bwd_dq_kernel_sm90: what
// LM training runs). The first kernel did every product as fp32 FMAs on
// the CUDA cores (67 TFLOP/s peak), converted every tile to fp32 in
// shared memory with plain loads between two __syncthreads, so no load
// overlapped math, and staged each 64 x 64 tile pair anew. These:
// - run all products on the tensor cores: wgmma m64nNk16, bf16 operands,
//   fp32 accumulators in registers. The dK/dV pass computes transposed,
//   so that the keys are wgmma's M: S^T = K Q^T and dP^T = V dO^T with
//   both operands K-major in shared memory; P^T and dS^T are formed and
//   rounded to bf16 in registers, and their accumulator fragments are the
//   register A operand of dV += P^T dO and dK += dS^T Q, with dO and Q
//   read MN-major (transposed) from their tiles, as the forward reads V.
//   The dQ pass has the forward's shape: S = Q K^T and dP = dO V^T from
//   shared memory, dS in registers as A of dQ += dS K, K read MN-major;
// - load by TMA, in 128B-swizzled tiles that the wgmma descriptors read
//   without bank conflicts: one producer thread keeps a ring of kStages
//   stages full (full and empty mbarriers, as the forward's K/V ring),
//   so the next tiles load while this one is computed. The dK/dV pass
//   loads its 128 keys of K and V once and streams 64-query tiles of Q
//   and dO; a second producer warp puts each tile's lse and delta into
//   shared memory beside it (rows past s: lse = +inf, so P = 0). The dQ
//   pass loads its 128 queries of Q and dO once, keeps each row's lse and
//   delta in registers, and streams K and V tiles (128 keys at dh 64, 64
//   at dh 128: the forward's register trade-off);
// - one block of 3 warpgroups per (b*h, 128-key tile) or (b*h, 128-query
//   tile), heaviest causal tiles first: warpgroup 0 produces and gives
//   its registers to the two consumer warpgroups (setmaxnreg 24 / 240),
//   each of which owns 64 keys or 64 queries. Only tiles that reach the
//   diagonal are masked, tiles above it are never loaded, and a
//   warpgroup skips a tile that is wholly above its diagonal. TMA
//   zero-fills rows past s: such queries carry lse = +inf and dO = 0, and
//   such keys lie above every valid query; rows past s are not stored.
// The exponent is ex2.approx(x - lse2) with x = s * (scale log2 e) in
// fp32, as the forward's softmax.
//
// fp32 (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel: the first kernels,
// kept for fp32, whose tensor-core products would be TF32): 256 threads
// as a 16 x 16 grid over 64 x 64 tiles, every tile in fp32 in shared
// memory with rows padded by 4 floats (16-byte loads without bank
// conflicts between rows). In the products over dh each thread owns 4
// query rows and 4 keys (strided by 16, so a warp reads 2 rows of one
// operand, a broadcast, and 16 of the other); in the products over
// queries or keys it owns 4 output rows and dh/16 columns, read as
// 16-byte vectors. Tiles past s are zero-filled: their queries carry
// lse = +inf (P = 0) and their keys lie above every valid query. Rows
// past s are not stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kB = 64;                // queries and keys per tile
constexpr int kThreads = 256;         // a 16 x 16 grid
constexpr int kPS = kB + 4;           // row stride of the P / dS tiles

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
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
        pt[at] = s[i][j];
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

constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int DH>
cudaError_t launch_delta(const void* o, const void* dout, float* delta,
                         int64_t rows, cudaStream_t stream) {
  flash_bwd_delta_kernel<T, DH>
      <<<(unsigned)((rows + 7) / 8), kThreads, 0, stream>>>(
          static_cast<const T*>(o), static_cast<const T*>(dout), delta,
          rows);
  return cudaGetLastError();
}

// fp32: the SIMT kernels
template <int DH>
cudaError_t launch_fp32(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        void* dq, void* dk, void* dv, float* delta,
                        int64_t BH, int64_t S, float scale,
                        cudaStream_t stream) {
  using T = float;
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  cudaError_t err = launch_delta<T, DH>(o, dout, delta, BH * S, stream);
  if (err != cudaSuccess) return err;
  // the same fp32 product as the forward's and ref.flash_attention_tiled_ref's
  const float scale_log2 = scale * kLog2e;
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

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), TMA rings, warp specialisation
// ---------------------------------------------------------------------------
namespace sm90 {

constexpr int kThreads = 384;         // producer warpgroup + 2 consumers
constexpr int kConsumerThreads = 256;
constexpr int kStages = 3;            // depth of each pass's ring
constexpr int kBox = 64;              // rows of every TMA box
constexpr int kBlock = 128;           // keys (dK/dV) or queries (dQ) a block

// Shared memory of both passes: tiles of R rows stored as DH/64 column
// blocks of (R x 64) bf16 with 128-byte rows in TMA's 128B swizzle
// (1024-byte aligned), then the mbarriers.
// dK/dV: the block's K and V (kBlock keys, loaded once), then kStages
// 64-query tiles of Q, kStages of dO, and each stage's lse and delta
// (fp32, 64 each); barriers kv_full, full[kStages], empty[kStages].
template <int DH>
struct KVLayout {
  static constexpr int kBQ = 64;                          // queries a stage
  static constexpr uint32_t kKVBytes = kBlock * DH * 2;   // K or V
  static constexpr uint32_t kTileBytes = kBQ * DH * 2;    // Q or dO
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kK + kKVBytes;
  static constexpr uint32_t kQ = kV + kKVBytes;
  static constexpr uint32_t kDO = kQ + kStages * kTileBytes;
  static constexpr uint32_t kRows = kDO + kStages * kTileBytes;
  static constexpr uint32_t kBars = kRows + kStages * 2 * kBQ * 4;
  static constexpr uint32_t kEnd = kBars + 8 * (1 + 2 * kStages);
  static constexpr size_t kSmem = kEnd + 1024;            // alignment slack
};

// dQ: the block's Q and dO (kBlock queries, loaded once), then kStages
// K tiles and kStages V tiles of kBK keys; barriers qdo_full,
// full[kStages], empty[kStages]. kBK as the forward's block_k: 128 keys
// for dh 64 (S and dP 64 fp32 registers each, dQ 32), 64 for dh 128 (32
// each, dQ 64), so the consumers fit 240 registers at both.
template <int DH>
struct QLayout {
  static constexpr int kBK = DH == 64 ? 128 : 64;
  static constexpr uint32_t kQBytes = kBlock * DH * 2;    // Q or dO
  static constexpr uint32_t kTileBytes = kBK * DH * 2;    // K or V
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kDO = kQ + kQBytes;
  static constexpr uint32_t kK = kDO + kQBytes;
  static constexpr uint32_t kV = kK + kStages * kTileBytes;
  static constexpr uint32_t kBars = kV + kStages * kTileBytes;
  static constexpr uint32_t kEnd = kBars + 8 * (1 + 2 * kStages);
  static constexpr size_t kSmem = kEnd + 1024;            // alignment slack
};

// rows r0 .. r0 + R - 1 of head bh into a tile of R rows at `dst`, as
// R/64 boxes a column block; completion to `bar`
template <int DH, int R>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          int r0, int bh, uint32_t bar) {
#pragma unroll
  for (int cb = 0; cb < DH / 64; ++cb)
#pragma unroll
    for (int h = 0; h < R / kBox; ++h)
      tma_load(dst + cb * (R * 128) + h * (kBox * 128), map, cb * 64,
               r0 + kBox * h, bh, bar);
}

// descriptor of k-step kk (16 columns of dh) of the 64 rows at `rows` of
// a K-major tile of R rows: 32 bytes along a 128-byte swizzled row, the
// next column block after 4 steps
template <int R>
__device__ __forceinline__ uint64_t kmajor(uint32_t rows, int kk) {
  return sw128_desc(rows + (kk / 4) * (R * 128) + (kk % 4) * 32, 16);
}

// dK and dV of one (b*h, 128-key tile): grid (b*h, key tiles), key tile 0
// (the most query tiles) first
template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel_sm90(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int S,
                           float scale, float scale_log2) {
  using L = KVLayout<DH>;
  constexpr int kBQ = L::kBQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* rows_s = reinterpret_cast<float*>(smem_raw + (base - raw) + L::kRows);
  const uint32_t kv_full = base + L::kBars;
  const uint32_t full = kv_full + 8;
  const uint32_t empty = full + 8 * kStages;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlock;
  // query tiles from the diagonal (k0 is a multiple of kBQ) to s
  const int n_qt = (S + kBQ - 1) / kBQ - k0 / kBQ;
  const int64_t row0 = (int64_t)bh * S;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, 1 + 32);     // the TMA thread + the row warp
      mbar_init(empty + 8 * i, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: thread 0 loads by TMA, warp 1 the lse / delta rows ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * L::kKVBytes);
      load_tile<DH, kBlock>(base + L::kK, &tm_k, k0, bh, kv_full);
      load_tile<DH, kBlock>(base + L::kV, &tm_v, k0, bh, kv_full);
      for (int it = 0; it < n_qt; ++it) {
        const int st = it % kStages;
        const uint32_t round = it / kStages;
        // the first round finds every stage empty (parity trick)
        mbar_wait(empty + 8 * st, (round & 1) ^ 1);
        const int q0 = k0 + it * kBQ;
        mbar_expect_tx(full + 8 * st, 2 * L::kTileBytes);
        load_tile<DH, kBQ>(base + L::kQ + st * L::kTileBytes, &tm_q, q0, bh,
                           full + 8 * st);
        load_tile<DH, kBQ>(base + L::kDO + st * L::kTileBytes, &tm_do, q0,
                           bh, full + 8 * st);
      }
    } else if (threadIdx.x / 32 == 1) {
      const int lane = threadIdx.x % 32;
      for (int it = 0; it < n_qt; ++it) {
        const int st = it % kStages;
        mbar_wait(empty + 8 * st, ((it / kStages) & 1) ^ 1);
        const int q0 = k0 + it * kBQ;
        float* ls = rows_s + st * 2 * kBQ;
#pragma unroll
        for (int h = 0; h < kBQ / 32; ++h) {
          const int r = lane + 32 * h;
          const bool in = q0 + r < S;
          ls[r] = in ? lse[row0 + q0 + r] : INFINITY;
          ls[kBQ + r] = in ? delta[row0 + q0 + r] : 0.f;
        }
        mbar_arrive(full + 8 * st);        // releases the stores above
      }
    }
    return;
  }

  // ---- consumers: warpgroup c owns keys k0 + 64c .. k0 + 64c + 63 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(kConsumerRegs));
  const int c = wg - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int kw0 = k0 + 64 * c;
  // this thread's two keys (rows of every accumulator fragment), and its
  // query columns 8i + 2(lane % 4) + {0, 1} of S^T and dP^T
  const int key0 = kw0 + 16 * (t / 32) + lane / 4;
  const int keys[2] = {key0, key0 + 8};
  const int col = 2 * (lane % 4);

  float acc_dv[DH / 2], acc_dk[DH / 2];   // 64 keys x DH, fp32
  float s[kBQ / 2], dp[kBQ / 2];          // S^T, dP^T: 64 keys x 64 queries
  uint32_t p[kBQ / 16][4], ds[kBQ / 16][4];  // P^T, dS^T: wgmma's A
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc_dv[i] = acc_dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBQ / 2; ++i) s[i] = dp[i] = 0.f;

  const uint32_t ka = base + L::kK + c * (64 * 128);
  const uint32_t va = base + L::kV + c * (64 * 128);
  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_qt; ++it) {
    const int st = it % kStages;
    const int q0 = k0 + it * kBQ;
    mbar_wait(full + 8 * st, (it / kStages) & 1);
    if (q0 + kBQ <= kw0) {                 // every query before every key
      mbar_arrive(empty + 8 * st);
      continue;
    }
    const uint32_t qb = base + L::kQ + st * L::kTileBytes;
    const uint32_t dob = base + L::kDO + st * L::kTileBytes;
    const float* ls = rows_s + st * 2 * kBQ;

    // S^T = K Q^T and dP^T = V dO^T: dh/16 k-steps each
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss<kBQ>(s, kmajor<kBlock>(ka, kk), kmajor<kBQ>(qb, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss<kBQ>(dp, kmajor<kBlock>(va, kk), kmajor<kBQ>(dob, kk),
                    kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P^T = 2^(x - lse2) with x = s scale log2e, 0 where the key is after
    // the query (only tiles that reach the diagonal are masked); dS^T =
    // P^T o (dP^T - delta); both rounded to bf16 as wgmma's A fragments
    const bool diag = kw0 + 63 > q0;
#pragma unroll
    for (int i = 0; i < kBQ / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * i + col + (e & 1);
        float pe = ex2(s[4 * i + e] * scale_log2 - ls[qi]);
        if (diag && keys[e >> 1] > q0 + qi) pe = 0.f;
        s[4 * i + e] = pe;
        dp[4 * i + e] = pe * (dp[4 * i + e] - ls[kBQ + qi]);
      }
    }
    // the fragment of queries 16j..16j+15 is A's fragment for k-step j
#pragma unroll
    for (int j = 0; j < kBQ / 16; ++j) {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        p[j][h] = pack_bf16(s[8 * j + 2 * h], s[8 * j + 2 * h + 1]);
        ds[j][h] = pack_bf16(dp[8 * j + 2 * h], dp[8 * j + 2 * h + 1]);
      }
    }

    // dV += P^T dO and dK += dS^T Q: kBQ/16 k-steps of 16 queries (2048
    // bytes of a tile); dO and Q read MN-major, column blocks kBQ * 128
    // bytes apart
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBQ / 16; ++j)
      wgmma_rs<DH>(acc_dv, p[j], sw128_desc(dob + j * 2048, kBQ * 128));
#pragma unroll
    for (int j = 0; j < kBQ / 16; ++j)
      wgmma_rs<DH>(acc_dk, ds[j], sw128_desc(qb + j * 2048, kBQ * 128));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    mbar_arrive(empty + 8 * st);           // the stage may be loaded again
  }

  // dK scale and dV in bf16; keys past s are not stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= S) continue;
    __nv_bfloat16* dkrow = dk + (row0 + keys[r]) * DH + col;
    __nv_bfloat16* dvrow = dv + (row0 + keys[r]) * DH + col;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(dkrow + 8 * i) =
          __floats2bfloat162_rn(acc_dk[4 * i + 2 * r] * scale,
                                acc_dk[4 * i + 2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvrow + 8 * i) =
          __floats2bfloat162_rn(acc_dv[4 * i + 2 * r],
                                acc_dv[4 * i + 2 * r + 1]);
    }
  }
}

// dQ of one (b*h, 128-query tile): grid (b*h, query tiles), the last
// query tile (the most key tiles) first
template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel_sm90(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int S, float scale,
                         float scale_log2) {
  using L = QLayout<DH>;
  constexpr int kBK = L::kBK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t qdo_full = base + L::kBars;
  const uint32_t full = qdo_full + 8;
  const uint32_t empty = full + 8 * kStages;

  const int bh = blockIdx.x;
  const int q0 = ((int)gridDim.y - 1 - (int)blockIdx.y) * kBlock;
  // key tiles up to the causal bound, none wholly past s
  const int n_kt = (min(q0 + kBlock, S) + kBK - 1) / kBK;
  const int64_t row0 = (int64_t)bh * S;

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the K/V ring full by TMA ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(qdo_full, 2 * L::kQBytes);
      load_tile<DH, kBlock>(base + L::kQ, &tm_q, q0, bh, qdo_full);
      load_tile<DH, kBlock>(base + L::kDO, &tm_do, q0, bh, qdo_full);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % kStages;
        const uint32_t round = kt / kStages;
        mbar_wait(empty + 8 * st, (round & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, 2 * L::kTileBytes);
        load_tile<DH, kBK>(base + L::kK + st * L::kTileBytes, &tm_k,
                           kt * kBK, bh, full + 8 * st);
        load_tile<DH, kBK>(base + L::kV + st * L::kTileBytes, &tm_v,
                           kt * kBK, bh, full + 8 * st);
      }
    }
    return;
  }

  // ---- consumers: warpgroup c owns query rows q0 + 64c .. q0 + 64c + 63 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(kConsumerRegs));
  const int c = wg - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int qw0 = q0 + 64 * c;
  // this thread's two rows of every accumulator fragment, and its key
  // columns 8i + 2(lane % 4) + {0, 1} of S and dP
  const int r0 = qw0 + 16 * (t / 32) + lane / 4;
  const int rows[2] = {r0, r0 + 8};
  const int col = 2 * (lane % 4);
  // each row's lse and delta; rows past s: lse = +inf (P = 0), delta = 0
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = rows[r] < S;
    lse_r[r] = in ? lse[row0 + rows[r]] : INFINITY;
    delta_r[r] = in ? delta[row0 + rows[r]] : 0.f;
  }

  float acc[DH / 2];                    // dQ: 64 x DH, fp32
  float s[kBK / 2], dp[kBK / 2];        // S, dP: 64 x kBK, fp32
  uint32_t ds[kBK / 16][4];             // dS as bf16 pairs: wgmma's A
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s[i] = dp[i] = 0.f;

  const uint32_t qa = base + L::kQ + c * (64 * 128);
  const uint32_t doa = base + L::kDO + c * (64 * 128);
  mbar_wait(qdo_full, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % kStages;
    const int k0 = kt * kBK;
    mbar_wait(full + 8 * st, (kt / kStages) & 1);
    if (k0 > qw0 + 63) {                   // every key after every row
      mbar_arrive(empty + 8 * st);
      continue;
    }
    const uint32_t kb = base + L::kK + st * L::kTileBytes;
    const uint32_t vb = base + L::kV + st * L::kTileBytes;

    // S = Q K^T and dP = dO V^T: dh/16 k-steps each
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss<kBK>(s, kmajor<kBlock>(qa, kk), kmajor<kBK>(kb, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss<kBK>(dp, kmajor<kBlock>(doa, kk), kmajor<kBK>(vb, kk),
                    kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P = 2^(x - lse2), 0 above the diagonal (only tiles that reach it
    // are masked); dS = P o (dP - delta), rounded to bf16 as wgmma's A
    const bool diag = k0 + kBK - 1 > qw0;
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float pe = ex2(s[4 * i + e] * scale_log2 - lse_r[r]);
        if (diag && k0 + 8 * i + col + (e & 1) > rows[r]) pe = 0.f;
        dp[4 * i + e] = pe * (dp[4 * i + e] - delta_r[r]);
      }
    }
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
#pragma unroll
      for (int h = 0; h < 4; ++h)
        ds[j][h] = pack_bf16(dp[8 * j + 2 * h], dp[8 * j + 2 * h + 1]);
    }

    // dQ += dS K: kBK/16 k-steps of 16 keys; K read MN-major, its column
    // blocks kBK * 128 bytes apart
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j)
      wgmma_rs<DH>(acc, ds[j], sw128_desc(kb + j * 2048, kBK * 128));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(empty + 8 * st);           // the stage may be loaded again
  }

  // dQ scale in bf16; rows past s are not stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= S) continue;
    __nv_bfloat16* qrow = dq + (row0 + rows[r]) * DH + col;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(qrow + 8 * i) =
          __floats2bfloat162_rn(acc[4 * i + 2 * r] * scale,
                                acc[4 * i + 2 * r + 1] * scale);
  }
}

// setmaxnreg moves registers within the block's allocation: the
// consumers' 240 must come out of what the launch gives 384 threads
template <typename Kern>
cudaError_t prepare(Kern kern, size_t smem) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * kThreads < kProducerRegs * 128 + kConsumerRegs * 256)
    return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, void* dq, void* dk, void* dv,
           float* delta, int64_t BH, int64_t S, float scale,
           cudaStream_t stream) {
  auto dkdv = flash_bwd_dkdv_kernel_sm90<DH>;
  auto dqk = flash_bwd_dq_kernel_sm90<DH>;
  cudaError_t cerr = prepare(dkdv, KVLayout<DH>::kSmem);
  if (cerr == cudaSuccess) cerr = prepare(dqk, QLayout<DH>::kSmem);
  if (cerr != cudaSuccess) return (int)cerr;
  CUtensorMap tq, tk, tv, tdo;
  int err = encode(&tq, q, BH, S, DH, kBox);
  if (!err) err = encode(&tk, k, BH, S, DH, kBox);
  if (!err) err = encode(&tv, v, BH, S, DH, kBox);
  if (!err) err = encode(&tdo, dout, BH, S, DH, kBox);
  if (err) return err;
  cerr = launch_delta<__nv_bfloat16, DH>(o, dout, delta, BH * S, stream);
  if (cerr != cudaSuccess) return (int)cerr;
  // the same fp32 product as the forward's and ref.flash_attention_tiled_ref's
  const float scale_log2 = scale * kLog2e;
  const dim3 grid((unsigned)BH, (unsigned)((S + kBlock - 1) / kBlock));
  dkdv<<<grid, kThreads, KVLayout<DH>::kSmem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), (int)S, scale, scale_log2);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return (int)cerr;
  dqk<<<grid, kThreads, QLayout<DH>::kSmem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dq), (int)S,
      scale, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace sm90

}  // namespace

// q, k, v, o, dout, dq, dk, dv: (BH, S, DH) contiguous, DH 64 or 128, one
// dtype (is_bf16: bf16, else fp32), 16-byte aligned; lse: (BH, S) fp32 as
// the forward stored it (log2 units); delta: (BH, S) fp32 scratch; scale
// is 1/sqrt of the unpadded dh. Three launches on `stream`: delta, dK/dV,
// dQ; bf16 runs the tensor-core kernels, fp32 the SIMT ones. Returns a
// cudaError, or kDriverError + a CUresult when a TMA descriptor could not
// be encoded (nothing is launched then).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, void* dq, void* dk, void* dv,
    float* delta, int64_t BH, int64_t S, int64_t DH, int64_t is_bf16,
    float scale, void* stream) {
  if (BH == 0 || S == 0) return 0;
  if (BH > INT32_MAX || (S + kB - 1) / kB > 65535 || S > INT32_MAX / 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (DH == 64)
      return sm90::launch<64>(q, k, v, o, dout, lse, dq, dk, dv, delta, BH,
                              S, scale, st);
    if (DH == 128)
      return sm90::launch<128>(q, k, v, o, dout, lse, dq, dk, dv, delta, BH,
                               S, scale, st);
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err;
  if (DH == 64) {
    err = launch_fp32<64>(q, k, v, o, dout, lse, dq, dk, dv, delta, BH, S,
                          scale, st);
  } else if (DH == 128) {
    err = launch_fp32<128>(q, k, v, o, dout, lse, dq, dk, dv, delta, BH, S,
                           scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* kernel_error_string(int code) {
  return sm90::error_string(code);
}

// Causal flash attention, forward: O = softmax(Q K^T / sqrt(dh) + causal
// mask) V on (b, h, s, dh) bf16 or fp32 tensors.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_kernel (body _flash_kernel) and keeps its semantics:
// scores scaled by 1/sqrt(dh), -1e30 above the diagonal, an online softmax
// with fp32 running max m, denominator l and accumulator, each key tile
// folded in as m' = max(m, rowmax s), p = exp(s - m'), l' = l e^(m-m') +
// sum p, acc' = acc e^(m-m') + p V; the result is acc / max(l, 1e-30) in
// the input's dtype. Not its block layout: the TPU kernel streams K/V
// tiles by DMA into VMEM for one (b, h, q-block) grid step at a time and
// pads dh to the 128-lane width and s to the block. For training, the
// caller may pass an lse buffer: both kernels then store each row's
// log-sum-exp in log2 units (m + log2 l of the log2-domain softmax), which
// the backward (flash_attention_bwd.cu) reads to rebuild P; with a null
// lse, as the prefill passes, no store runs.
//
// Bound on the H100: operations. A call does 4 b h dh s(s+1)/2 FLOPs (QK^T
// and PV over the causal half) on 4 b h s dh elements of input and output:
// at (1, 32, 8192, 64) that is 0.275 TFLOP against 134 MB in bf16, 0.278 ms
// at the dense bf16 tensor-core rate (989 TFLOP/s) and 0.04 ms of memory
// traffic.
//
// bf16 (sm90::flash_attention_kernel_sm90, what the LM prefill runs). The
// first kernel did both products as fp32 FMAs on the CUDA cores (67 TFLOP/s
// peak), loaded every tile with plain loads between two __syncthreads and
// staged it in fp32 at 64 x 64. This one:
// - runs QK^T and PV on the tensor cores: wgmma m64nNk16 with bf16 operands
//   and fp32 accumulators in registers. S = Q K^T reads Q and K from shared
//   memory (both K-major). P is rounded to bf16 in registers and is wgmma's
//   A operand from registers (the fp32 accumulator fragment of S for keys
//   16j..16j+15 is exactly the A fragment of k-step j); V is the B operand,
//   read MN-major (transposed) from shared memory, so nothing is
//   transposed by hand;
// - loads by TMA: one producer thread puts the Q tile into shared memory
//   once and streams K and V tiles through a ring of kStages stages, each
//   with a full barrier for K, one for V (TMA's transaction bytes) and an
//   empty barrier that the consumers arrive on after their PV of the
//   stage has completed; loads of the next tiles overlap this tile's math.
//   Tiles use the 128B swizzle, which the wgmma descriptors read without
//   bank conflicts; dh 128 is two 64-column boxes, since a box's inner
//   extent may not exceed the 128-byte swizzle span;
// - one block of 3 warpgroups per (b*h, 128-query tile), heaviest causal
//   tiles first: warpgroup 0 is the producer and gives its registers to the
//   two consumer warpgroups (setmaxnreg 24 / 240), each of which owns 64
//   query rows. Key tiles are 128 wide for dh 64 and 64 for dh 128 (see
//   block_k).
// The softmax runs in registers in the log2 domain: x = s * (scale *
// log2(e)) in fp32 and exp2 (ex2.approx), which is exp(s * scale) with
// log2(e) folded into the scale; a row of the accumulator lives on the 4
// lanes of a quad, so its max takes two shuffles. l sums the unrounded fp32
// P. Only the tiles that reach the diagonal are masked, and tiles above it
// are never loaded. TMA zero-fills key rows past s; they lie above every
// valid query, so the causal mask covers them. Output rows past s are not
// stored. ref.flash_attention_tiled_ref is its plain version, with the
// same tiles and rounding points.
//
// fp32 (flash_attention_kernel, the first port's, with the log-sum-exp
// store as a second instantiation; the 9a and 14a fp32 shapes, 14c's fp32
// run and the card tests run it): one block of 8 warps per
// (b*h, 64-query tile), heaviest tiles first. The block stages its
// pre-scaled Q tile once and then, per 64-key tile up to and including the
// diagonal one, K transposed (row stride 65: conflict-free column reads
// and only 2-way conflicts on the transposing stores) and V in shared
// memory. Each warp owns 8 query rows: lane j scores keys j and j+32
// against them, the row max and sum reduce by warp shuffles, the warp's
// probabilities go through its own slice of shared memory (8 rows of a key
// side by side, read back as two float4 broadcasts), and lane j
// accumulates dh/32 contiguous output columns of the 8 rows in registers,
// with __expf. Only the diagonal tile is masked; a ragged last tile is
// zero-filled. Rows past s are not stored. Its plain version is
// ref.flash_attention_ref.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

#include "sm90.cuh"

namespace {

constexpr int kBQ = 64;               // query rows per block
constexpr int kBK = 64;               // keys per tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBQ / kWarps;   // query rows per warp
constexpr int kKtStride = kBK + 1;    // row stride of the transposed K tile
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

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

// kLse: store each row's log-sum-exp; that instantiation (fp32 training
// only) takes one block an SM's registers, since at dh 128 the store did
// not fit the 128 a thread that two blocks an SM leave without a spill
template <typename T, int DH, bool kLse>
__global__ void __launch_bounds__(kThreads, kLse ? 1 : 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int S, float scale) {
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
    // m and l are the warp's (reduced by shuffles): the row's log-sum-exp
    // of s * scale, stored in log2 units as the bf16 kernel stores it
    if (kLse && lane == 0)
      lse[(int64_t)blockIdx.y * S + qq] = (m[r] + logf(l[r])) * kLog2e;
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int64_t BH, int64_t S, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  auto kern = lse != nullptr ? flash_attention_kernel<T, DH, true>
                             : flash_attention_kernel<T, DH, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((S + kBQ - 1) / kBQ), (unsigned)BH);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, (int)S, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), TMA and a warp-specialised K/V ring
// ---------------------------------------------------------------------------
namespace sm90 {

constexpr int kBQ = 128;              // query rows per block, 64 a consumer
constexpr int kStages = 3;            // depth of the K/V ring
constexpr int kThreads = 384;         // producer warpgroup + 2 consumers
constexpr int kConsumerThreads = 256;
constexpr float kMasked = -1e30f;

// Keys per tile: 128 for dh 64 (S is 64 fp32 registers a thread, O 32);
// 64 for dh 128, so that S (32) and O (64) stay as small as dh 64's and
// the consumers fit 240 registers without spills; the K and V tiles are
// 16 KB each either way.
template <int DH>
constexpr int block_k() { return DH == 64 ? 128 : 64; }

// Shared memory: the Q tile, then kStages K tiles and kStages V tiles,
// each stored as DH/64 column blocks of (rows x 64) bf16 with 128-byte
// rows in TMA's 128B swizzle (1024-byte aligned), then the mbarriers.
template <int DH>
struct Layout {
  static constexpr int kBK = block_k<DH>();
  static constexpr uint32_t kQBytes = kBQ * DH * 2;
  static constexpr uint32_t kTileBytes = kBK * DH * 2;   // one K or V tile
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + kQBytes;
  static constexpr uint32_t kV = kK + kStages * kTileBytes;
  static constexpr uint32_t kBars = kV + kStages * kTileBytes;
  // q_full, k_full[kStages], v_full[kStages], empty[kStages]
  static constexpr uint32_t kEnd = kBars + 8 * (1 + 3 * kStages);
  static constexpr size_t kSmem = kEnd + 1024;           // alignment slack
};

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel_sm90(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            __nv_bfloat16* __restrict__ o,
                            float* __restrict__ lse, int S,
                            float scale_log2) {
  using L = Layout<DH>;
  constexpr int kBK = L::kBK;
  constexpr int kColBlocks = DH / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBars;
  const uint32_t k_full = q_full + 8;
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;

  const int bh = blockIdx.x;
  const int qt = (int)gridDim.y - 1 - (int)blockIdx.y;  // heaviest first
  const int q0 = qt * kBQ;
  // key tiles up to the causal bound, none wholly past s
  const int n_kt = (min(q0 + kBQ, S) + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(k_full + 8 * i, 1);
      mbar_init(v_full + 8 * i, 1);
      mbar_init(empty + 8 * i, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the ring full by TMA ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
      for (int cb = 0; cb < kColBlocks; ++cb)
        tma_load(base + L::kQ + cb * (kBQ * 128), &tm_q, cb * 64, q0, bh,
                 q_full);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % kStages;
        const uint32_t round = kt / kStages;
        // the first round finds every stage empty (parity trick)
        mbar_wait(empty + 8 * st, (round & 1) ^ 1);
        const uint32_t kdst = base + L::kK + st * L::kTileBytes;
        const uint32_t vdst = base + L::kV + st * L::kTileBytes;
        mbar_expect_tx(k_full + 8 * st, L::kTileBytes);
#pragma unroll
        for (int cb = 0; cb < kColBlocks; ++cb)
          tma_load(kdst + cb * (kBK * 128), &tm_k, cb * 64, kt * kBK, bh,
                   k_full + 8 * st);
        mbar_expect_tx(v_full + 8 * st, L::kTileBytes);
#pragma unroll
        for (int cb = 0; cb < kColBlocks; ++cb)
          tma_load(vdst + cb * (kBK * 128), &tm_v, cb * 64, kt * kBK, bh,
                   v_full + 8 * st);
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
  // this thread's two rows of every accumulator fragment, and its columns
  // 8i + 2(lane % 4) + {0, 1}
  const int row0 = q0 + 64 * c + 16 * (t / 32) + lane / 4;
  const int rows[2] = {row0, row0 + 8};
  const int col = 2 * (lane % 4);

  float acc[DH / 2];                   // O: 64 x DH, fp32
  float s[kBK / 2];                    // S, then P: 64 x kBK, fp32
  uint32_t p[kBK / 16][4];             // P as bf16 pairs: wgmma's A
  float m[2] = {-INFINITY, -INFINITY}; // running max (log2 units)
  float l[2] = {0.f, 0.f};             // this thread's part of the sum
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;

  mbar_wait(q_full, 0);
  const uint32_t qa = base + L::kQ + c * (64 * 128);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % kStages;
    const uint32_t parity = (kt / kStages) & 1;
    const uint32_t kb = base + L::kK + st * L::kTileBytes;
    const uint32_t vb = base + L::kV + st * L::kTileBytes;
    const int k0 = kt * kBK;

    // S = Q K^T: dh/16 k-steps; a step moves 32 bytes along a 128-byte
    // swizzled row, and the next column block after 4 steps
    mbar_wait(k_full + 8 * st, parity);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss<kBK>(s,
                    sw128_desc(qa + (kk / 4) * (kBQ * 128) + off, 16),
                    sw128_desc(kb + (kk / 4) * (kBK * 128) + off, 16),
                    kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // online softmax in the log2 domain: x = s * scale * log2(e), -1e30
    // above the diagonal (only the tiles that reach it are masked)
    const bool diag = k0 + kBK > q0 + 64 * c;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * i + e] * scale_log2;
        if (diag && k0 + 8 * i + col + (e & 1) > rows[e >> 1]) x = kMasked;
        s[4 * i + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {   // a row lives on the 4 lanes of a quad
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = ex2(m[r] - mx[r]);  // 0 on the first tile (m = -inf)
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = ex2(s[4 * i + e] - m[e >> 1]);
        s[4 * i + e] = pe;
        l[e >> 1] += pe;             // l sums the unrounded fp32 P
      }
    }
    // S's fragment for keys 16j..16j+15 is P's A fragment for k-step j
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      p[j][0] = pack_bf16(s[8 * j + 0], s[8 * j + 1]);
      p[j][1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
      p[j][2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
      p[j][3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
    }
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      acc[4 * i + 0] *= corr[0];
      acc[4 * i + 1] *= corr[0];
      acc[4 * i + 2] *= corr[1];
      acc[4 * i + 3] *= corr[1];
    }

    // O += P V: kBK/16 k-steps of 16 keys (2048 bytes of the V tile); V is
    // read transposed (MN-major), its column blocks kBK * 128 bytes apart
    mbar_wait(v_full + 8 * st, parity);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j)
      wgmma_rs<DH>(acc, p[j], sw128_desc(vb + j * 2048, kBK * 128));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(empty + 8 * st);     // the stage may be loaded again
  }

  // acc / max(l, 1e-30) in bf16; rows past s are not stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  const int64_t base_row = (int64_t)bh * S;
  // the row's log-sum-exp in log2 units, m + log2(l): the softmax above
  // runs on x = s * scale * log2(e), so this is log2 of sum 2^x, which is
  // lse(s * scale) * log2(e); one lane of the quad stores it
  if (lse != nullptr && (lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (rows[r] < S) lse[base_row + rows[r]] = m[r] + log2f(l[r]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= S) continue;
    __nv_bfloat16* orow = o + (base_row + rows[r]) * DH + col;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) =
          __floats2bfloat162_rn(acc[4 * i + 2 * r] / l[r],
                                acc[4 * i + 2 * r + 1] / l[r]);
  }
}


template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int64_t BH, int64_t S, float scale, cudaStream_t stream) {
  using L = Layout<DH>;
  auto kern = flash_attention_kernel_sm90<DH>;
  static int regs = -1;
  if (regs < 0) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kern);
    if (err != cudaSuccess) return (int)err;
    regs = attr.numRegs;
  }
  cudaError_t attr_err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem);
  if (attr_err != cudaSuccess) return (int)attr_err;
  // setmaxnreg moves registers within the block's allocation: the
  // consumers' 240 must come out of what the launch gives 384 threads
  if (regs * kThreads < kProducerRegs * 128 + kConsumerRegs * 256)
    return (int)cudaErrorInvalidConfiguration;
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, BH, S, DH, kBQ);
  if (!err) err = encode(&tk, k, BH, S, DH, L::kBK);
  if (!err) err = encode(&tv, v, BH, S, DH, L::kBK);
  if (err) return err;
  const dim3 grid((unsigned)BH, (unsigned)((S + kBQ - 1) / kBQ));
  kern<<<grid, kThreads, L::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, (int)S,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace sm90

}  // namespace

// q, k, v, o: (BH, S, DH) contiguous, DH 64 or 128, one dtype (is_bf16:
// bf16, else fp32); scale is 1/sqrt of the unpadded dh. bf16 runs the
// tensor-core kernel (16-byte aligned pointers for TMA), fp32 the SIMT one.
// lse: null, or (BH, S) fp32 that receives each row's log-sum-exp of the
// scaled scores in log2 units (log2 sum_j 2^(s_j scale log2 e)), which the
// backward (flash_attention_bwd.cu) reads; the prefill passes null and no
// store runs. Returns a cudaError, or kDriverError + a CUresult when a TMA
// descriptor could not be encoded.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int64_t BH, int64_t S, int64_t DH,
                                      int64_t is_bf16, float scale,
                                      void* stream) {
  if (BH == 0 || S == 0) return 0;
  if (S > (int64_t)INT32_MAX / 128) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (BH > INT32_MAX || (S + sm90::kBQ - 1) / sm90::kBQ > 65535)
      return (int)cudaErrorInvalidValue;
    if (DH == 64) return sm90::launch<64>(q, k, v, o, lse, BH, S, scale, st);
    if (DH == 128)
      return sm90::launch<128>(q, k, v, o, lse, BH, S, scale, st);
    return (int)cudaErrorInvalidValue;
  }
  if (BH > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (DH == 64) {
    err = launch<float, 64>(q, k, v, o, lse, BH, S, scale, st);
  } else if (DH == 128) {
    err = launch<float, 128>(q, k, v, o, lse, BH, S, scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* kernel_error_string(int code) {
  return sm90::error_string(code);
}

// Flash attention on Hopper (sm_90a): forward, dQ and dK/dV kernels.
//
// Replaces the three Pallas TPU kernels of ray_tpu/ops/flash_attention.py:
//   rtt_flash_fwd     <- _flash_kernel    (O and the per-row logsumexp)
//   rtt_flash_bwd_dq  <- _bwd_dq_kernel   (dQ, walking k innermost)
//   rtt_flash_bwd_dkv <- _bwd_dkv_kernel  (dK and dV, walking q innermost)
//
// Layout: q, k, v, o, dO and the gradients are contiguous [BH, L, D] in one
// dtype (f32 or bf16); lse and delta are contiguous f32 [BH, L].
// D is 64 or 128.
//
// Two designs. f32 inputs run the f32-FMA kernels below; bf16 inputs run
// the tensor-core kernels of namespace sm90 further down (forward, dQ and
// dK/dV). RTT_DISPATCH picks by dtype and head dim alone.
//
// f32-FMA kernels, for f32 inputs. Numerics follow the TPU kernels: every
// product, sum and softmax step is an f32 FMA. The causal mask is the
// reference's finite -1e30 on global row/column indices; columns past the
// end of the sequence get -inf (probability exactly 0); the logsumexp uses
// max(l, 1e-30) as the reference does.
//
// Their design is the simple first version. The TPU grid's sequential
// dimension, with scratch carried from one step to the next, becomes a loop
// inside one thread block:
//   - forward and dQ: one block per (bh, 64-row q tile), looping over the
//     k tiles up to the diagonal;
//   - dK/dV: one block per (bh, 64-row k tile), looping over the q tiles
//     from the diagonal on, so dK and dV are written without atomics, as in
//     the TPU split.
// 256 threads form a 16 x 16 grid; each thread owns a micro-tile of rows
// ty*4+i and columns tx+16*j. Tiles sit in dynamic shared memory as f32 rows
// padded by one float (no bank conflicts): at D = 64 the blocks take 67 KB
// (forward), 84 KB (dQ) and 100 KB (dK/dV), above the 48 KB static limit.
// The API's block_q/block_k only choose between the kernels and the
// reference; the kernels tile as they need.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s) at the GPT-2 125M
// training shape [96, 1024, 64] bf16 causal, counting each input read once
// and each output written once: forward 12.9 GFLOP / 50.7 MB -> 15 us, set by
// bytes; dQ 19.4 GFLOP -> 20 us and dK/dV 25.8 GFLOP -> 26 us, set by
// operations. The f32-FMA kernels use no tensor cores (67 TFLOP/s at most)
// and reread every operand from shared memory for each FMA pair, so they run
// far from that bound; the sm90 kernels feed bf16 tiles to wgmma from a TMA
// ring and keep the softmax arithmetic in registers (see there).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "hopper.cuh"

namespace {

constexpr int kTile = 64;                  // rows of a Q or K tile
constexpr int kThreads = 256;              // threads of a block
constexpr int kGrid = 16;                  // the threads form kGrid x kGrid
constexpr int kMicro = kTile / kGrid;      // rows (and tile columns) a thread owns
constexpr int kWarps = kThreads / 32;
constexpr int kTileLd = kTile + 1;         // row stride of a [kTile, kTile] tile
constexpr float kMaskValue = -1e30f;       // the reference's causal mask value

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Rows [row0, row0 + kTile) of a contiguous [len, D] matrix into a tile
// with row stride D + 1; rows past len become zeros.
template <int D>
__device__ void load_rows(float* dst, const float* src, int row0, int len) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = row0 + r < len ? src[(size_t)(row0 + r) * D + c] : 0.f;
  }
}

// kTile entries of a per-row f32 vector; entries past len become zeros.
__device__ void load_vec(float* dst, const float* src, int row0, int len) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) dst[i] = row0 + i < len ? src[row0 + i] : 0.f;
}

// s[i][j] = a[ty*4+i, :] . b[tx+16j, :] for two [kTile, D] tiles of stride D + 1.
template <int D>
__device__ __forceinline__ void dot_rows(float (&s)[kMicro][kMicro], const float* a, const float* b,
                                         int ty, int tx) {
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[kMicro], bv[kMicro];
#pragma unroll
    for (int i = 0; i < kMicro; ++i) av[i] = a[(ty * kMicro + i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < kMicro; ++j) bv[j] = b[(tx + kGrid * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
      for (int j = 0; j < kMicro; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// acc[i][j] += sum_k p[ty*4+i, k] * x[k, tx+16j]: p is [kTile, kTile] of
// stride kTileLd, x is [kTile, D] of stride D + 1.
template <int D>
__device__ __forceinline__ void accumulate_nn(float (&acc)[kMicro][D / kGrid], const float* p,
                                              const float* x, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    float pv[kMicro];
#pragma unroll
    for (int i = 0; i < kMicro; ++i) pv[i] = p[(ty * kMicro + i) * kTileLd + k];
#pragma unroll
    for (int j = 0; j < D / kGrid; ++j) {
      const float xv = x[k * (D + 1) + tx + kGrid * j];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) acc[i][j] = fmaf(pv[i], xv, acc[i][j]);
    }
  }
}

// acc[i][j] += sum_r p[r, ty*4+i] * x[r, tx+16j]: the transposed product.
template <int D>
__device__ __forceinline__ void accumulate_tn(float (&acc)[kMicro][D / kGrid], const float* p,
                                              const float* x, int ty, int tx) {
#pragma unroll 4
  for (int r = 0; r < kTile; ++r) {
    float pv[kMicro];
#pragma unroll
    for (int i = 0; i < kMicro; ++i) pv[i] = p[r * kTileLd + ty * kMicro + i];
#pragma unroll
    for (int j = 0; j < D / kGrid; ++j) {
      const float xv = x[r * (D + 1) + tx + kGrid * j];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) acc[i][j] = fmaf(pv[i], xv, acc[i][j]);
    }
  }
}

template <int D>
__device__ __forceinline__ void zero(float (&acc)[kMicro][D / kGrid]) {
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < D / kGrid; ++j) acc[i][j] = 0.f;
}

// Rows of the micro-tile that lie before `len` go to dst ([len, D]).
template <int D>
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[kMicro][D / kGrid],
                                           int row0, int len, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int row = row0 + ty * kMicro + i;
    if (row >= len) continue;
#pragma unroll
    for (int j = 0; j < D / kGrid; ++j) dst[(size_t)row * D + tx + kGrid * j] = acc[i][j];
  }
}

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * kTile * (D + 1) + kTile * kTileLd + 3 * kTile);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                     int lq, int lk, float scale, int causal) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * (D + 1);
  float* sV = sK + kTile * (D + 1);
  float* sS = sV + kTile * (D + 1);
  float* sM = sS + kTile * kTileLd;   // running max
  float* sL = sM + kTile;             // running denominator
  float* sCorr = sL + kTile;          // this step's rescale of the accumulator

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // longest causal rows first
  const size_t bh = blockIdx.y;
  q += bh * lq * D;
  o += bh * lq * D;
  lse += bh * lq;
  k += bh * lk * D;
  v += bh * lk * D;
  const int tx = threadIdx.x % kGrid, ty = threadIdx.x / kGrid;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_rows<D>(sQ, q, q0, lq);
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    sM[i] = kMaskValue;
    sL[i] = 0.f;
  }
  float acc[kMicro][D / kGrid];
  zero<D>(acc);

  const int nk = (lk + kTile - 1) / kTile;
  const int last = causal ? min(nk - 1, (q0 + kTile - 1) / kTile) : nk - 1;
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous step is done with sK, sV and sS
    load_rows<D>(sK, k, k0, lk);
    load_rows<D>(sV, v, k0, lk);
    __syncthreads();

    float s[kMicro][kMicro];
    dot_rows<D>(s, sQ, sK, ty, tx);
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      const int r = ty * kMicro + i;
#pragma unroll
      for (int j = 0; j < kMicro; ++j) {
        const int c = tx + kGrid * j;
        float x = s[i][j] * scale;
        if (causal && k0 + c > q0 + r) x = kMaskValue;
        if (k0 + c >= lk) x = -INFINITY;
        sS[r * kTileLd + c] = x;
      }
    }
    __syncthreads();

    // Online softmax: warp w updates rows w*8 .. w*8+7, two columns a lane.
    for (int rr = 0; rr < kTile / kWarps; ++rr) {
      const int r = warp * (kTile / kWarps) + rr;
      float* row = sS + r * kTileLd;
      float a = row[lane], b = row[lane + 32];
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(a, b)));
      a = expf(a - m_new);
      b = expf(b - m_new);
      const float sum = warp_sum(a + b);
      row[lane] = a;
      row[lane + 32] = b;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        sCorr[r] = corr;
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      const float corr = sCorr[ty * kMicro + i];
#pragma unroll
      for (int j = 0; j < D / kGrid; ++j) acc[i][j] *= corr;
    }
    accumulate_nn<D>(acc, sS, sV, ty, tx);
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int r = ty * kMicro + i;
    const float denom = fmaxf(sL[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / kGrid; ++j) acc[i][j] /= denom;
    if (tx == 0 && q0 + r < lq) lse[q0 + r] = sM[r] + logf(denom);
  }
  store_rows<D>(o, acc, q0, lq, ty, tx);
}

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * kTileLd + 2 * kTile);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int lq, int lk, float scale, int causal) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kTile * (D + 1);
  float* sK = sdO + kTile * (D + 1);
  float* sV = sK + kTile * (D + 1);
  float* sdS = sV + kTile * (D + 1);
  float* sLse = sdS + kTile * kTileLd;
  float* sDelta = sLse + kTile;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const size_t bh = blockIdx.y;
  q += bh * lq * D;
  dout += bh * lq * D;
  dq += bh * lq * D;
  lse += bh * lq;
  delta += bh * lq;
  k += bh * lk * D;
  v += bh * lk * D;
  const int tx = threadIdx.x % kGrid, ty = threadIdx.x / kGrid;

  load_rows<D>(sQ, q, q0, lq);
  load_rows<D>(sdO, dout, q0, lq);
  load_vec(sLse, lse, q0, lq);
  load_vec(sDelta, delta, q0, lq);
  float acc[kMicro][D / kGrid];
  zero<D>(acc);

  const int nk = (lk + kTile - 1) / kTile;
  const int last = causal ? min(nk - 1, (q0 + kTile - 1) / kTile) : nk - 1;
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_rows<D>(sK, k, k0, lk);
    load_rows<D>(sV, v, k0, lk);
    __syncthreads();

    float s[kMicro][kMicro], dp[kMicro][kMicro];
    dot_rows<D>(s, sQ, sK, ty, tx);
    dot_rows<D>(dp, sdO, sV, ty, tx);
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      const int r = ty * kMicro + i;
#pragma unroll
      for (int j = 0; j < kMicro; ++j) {
        const int c = tx + kGrid * j;
        float x = s[i][j] * scale;
        if (causal && k0 + c > q0 + r) x = kMaskValue;
        const float p = k0 + c < lk ? expf(x - sLse[r]) : 0.f;
        sdS[r * kTileLd + c] = p * (dp[i][j] - sDelta[r]) * scale;
      }
    }
    __syncthreads();
    accumulate_nn<D>(acc, sdS, sK, ty, tx);  // dQ += dS K
  }
  store_rows<D>(dq, acc, q0, lq, ty, tx);
}

template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * kTileLd + 2 * kTile);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int lq, int lk,
                         float scale, int causal) {
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * (D + 1);
  float* sQ = sV + kTile * (D + 1);
  float* sdO = sQ + kTile * (D + 1);
  float* sP = sdO + kTile * (D + 1);
  float* sdS = sP + kTile * kTileLd;
  float* sLse = sdS + kTile * kTileLd;
  float* sDelta = sLse + kTile;

  const int k0 = blockIdx.x * kTile;  // low k tiles walk the most q tiles: first
  const size_t bh = blockIdx.y;
  q += bh * lq * D;
  dout += bh * lq * D;
  lse += bh * lq;
  delta += bh * lq;
  k += bh * lk * D;
  v += bh * lk * D;
  dk += bh * lk * D;
  dv += bh * lk * D;
  const int tx = threadIdx.x % kGrid, ty = threadIdx.x / kGrid;

  load_rows<D>(sK, k, k0, lk);
  load_rows<D>(sV, v, k0, lk);
  float dk_acc[kMicro][D / kGrid], dv_acc[kMicro][D / kGrid];
  zero<D>(dk_acc);
  zero<D>(dv_acc);

  const int nq = (lq + kTile - 1) / kTile;
  for (int qt = causal ? k0 / kTile : 0; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_rows<D>(sQ, q, q0, lq);
    load_rows<D>(sdO, dout, q0, lq);
    load_vec(sLse, lse, q0, lq);
    load_vec(sDelta, delta, q0, lq);
    __syncthreads();

    float s[kMicro][kMicro], dp[kMicro][kMicro];
    dot_rows<D>(s, sQ, sK, ty, tx);   // rows: q, columns: k
    dot_rows<D>(dp, sdO, sV, ty, tx);
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      const int r = ty * kMicro + i;
#pragma unroll
      for (int j = 0; j < kMicro; ++j) {
        const int c = tx + kGrid * j;
        float x = s[i][j] * scale;
        if (causal && k0 + c > q0 + r) x = kMaskValue;
        const float p = (q0 + r < lq && k0 + c < lk) ? expf(x - sLse[r]) : 0.f;
        sP[r * kTileLd + c] = p;
        sdS[r * kTileLd + c] = p * (dp[i][j] - sDelta[r]) * scale;
      }
    }
    __syncthreads();
    accumulate_tn<D>(dv_acc, sP, sdO, ty, tx);  // dV += P^T dO
    accumulate_tn<D>(dk_acc, sdS, sQ, ty, tx);  // dK += dS^T Q
  }
  store_rows<D>(dk, dk_acc, k0, lk, ty, tx);
  store_rows<D>(dv, dv_acc, k0, lk, ty, tx);
}

int tiles(int len) { return (len + kTile - 1) / kTile; }

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                       int lq, int lk, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<D><<<dim3(tiles(lq), bh), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), lq, lk, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, void* dq, int bh, int lq, int lk,
                          float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dq_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D><<<dim3(tiles(lq), bh), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), lq, lk, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dk, void* dv, int bh, int lq,
                           int lk, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<D><<<dim3(tiles(lk), bh), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), lq, lk,
      scale, causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on tensor cores: the forward (K1), dQ (K2) and dK/dV (K3) for bf16
// inputs.
//
// All three are bound by their products at the training shape (the forward
// by bytes only if the products ran at the tensor cores' peak), so the
// design feeds the tensor cores and keeps everything else out of their way.
// A thread block is consumer warpgroups (K1 and K2: two; K3: two at D = 64,
// one at D = 128) and one producer warp. The producer's first lane asks the
// TMA for every tile the block reads, into a ring of two stages; each stage
// has a "full" mbarrier (the TMA completes it) and an "empty" one (the
// consumer threads arrive when their products have read it), so the next
// tile is in flight while this one computes. The consumers multiply with
// wgmma, f32 sums in registers, and run the softmax arithmetic on those
// registers. A product whose left operand is a probability tile (P) or a
// score gradient (dS) takes it from registers, rounded to bf16 (a TPU's
// default-precision f32 matmul is one bf16 pass too); everything else stays
// f32. Exponentials are ex2.approx with the scale folded into log2 units.

namespace sm90 {

using bf16 = __nv_bfloat16;
constexpr int kConsumers = 256;                // two warpgroups
constexpr int kBlockThreads = kConsumers + 32;  // and the producer warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// d = A B^T over the head dim D for one warpgroup (d is overwritten). A and
// B are K-major SW128 tiles cut into D / 64 panels of a_rows and b_rows
// rows; the warpgroup's 64 rows of A start at a.
template <int N, int D>
__device__ __forceinline__ void mma_over_d(float (&d)[N / 2], const bf16* a, int a_rows,
                                           const bf16* b, int b_rows) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int panel = kk / 4, off = (kk % 4) * 16;
    hopper::Wgmma<N>::ss(d, hopper::desc_sw128(a + panel * a_rows * 64 + off),
                         hopper::desc_sw128(b + panel * b_rows * 64 + off), kk > 0);
  }
}

// d += A B for one warpgroup: A is J k16 steps of bf16 registers (as
// fragment_to_a packs them); B is an MN-major SW128 tile of 16 J rows, cut
// into D / 64 panels of 64 columns.
template <int D, int J>
__device__ __forceinline__ void mma_accumulate(float (&d)[D / 2], const uint32_t (&a)[J][4],
                                               const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < J; ++kk)
    hopper::Wgmma<D>::rs(d, a[kk], hopper::desc_sw128(b + kk * 16 * 64, J * 16 * 128), 1);
}

// The producer's K/V stream of K1 and K2: tiles t = 0 .. ntiles - 1 of BN
// rows of one bh into the two-stage ring. A stage is refilled once the
// consumers have released (empty) the tile it held.
template <int D, int BN>
__device__ __forceinline__ void produce_kv(bf16 (&k)[2][BN * D], bf16 (&v)[2][BN * D],
                                           uint64_t (&full)[2], uint64_t (&empty)[2],
                                           const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                           int ntiles, int bh) {
  using namespace hopper;
  for (int t = 0; t < ntiles; ++t) {
    const int s = t & 1;
    if (t >= 2) mbar_wait(&empty[s], ((t >> 1) - 1) & 1);
    mbar_expect_tx(&full[s], 2 * BN * D * sizeof(bf16));
    for (int p = 0; p < D / 64; ++p) {
      tma_load_3d(k[s] + p * BN * 64, tm_k, &full[s], p * 64, t * BN, bh);
      tma_load_3d(v[s] + p * BN * 64, tm_v, &full[s], p * 64, t * BN, bh);
    }
  }
}

// K1, for _flash_kernel. Block: 128 q rows (64 a warpgroup) of one bh;
// loops over k tiles of BN rows up to the diagonal. Per tile, a warpgroup computes S = Q K^T
// (wgmma, both operands in shared memory, K-major), updates its rows'
// running max and denominator on the accumulator fragment (a row lives on
// the 4 lanes of a quad: two shuffles), and adds P V with P from registers
// and V read MN-major.
constexpr int kFwdRows = 128;

template <int D, int BN>
struct FwdSmem {
  alignas(1024) bf16 q[kFwdRows * D];  // D / 64 panels of [kFwdRows, 64]
  alignas(1024) bf16 k[2][BN * D];     // per stage: D / 64 panels of [BN, 64]
  alignas(1024) bf16 v[2][BN * D];
  uint64_t q_full, full[2], empty[2];
};

template <int D, int BN>
__global__ void __launch_bounds__(kBlockThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                           float* __restrict__ lse, int lq, int lk, float scale, int causal) {
  using namespace hopper;
  auto& sm = aligned_smem<FwdSmem<D, BN>>();
  constexpr int kPanels = D / 64;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFwdRows;  // longest causal rows first
  const int bh = blockIdx.y;
  const int nk = (lk + BN - 1) / BN;
  const int ntiles = causal ? min(nk, (q0 + kFwdRows - 1) / BN + 1) : nk;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(&sm.q_full, kFwdRows * D * sizeof(bf16));
      for (int p = 0; p < kPanels; ++p)
        tma_load_3d(sm.q + p * kFwdRows * 64, &tm_q, &sm.q_full, p * 64, q0, bh);
      produce_kv<D, BN>(sm.k, sm.v, sm.full, sm.empty, &tm_k, &tm_v, ntiles, bh);
    }
    return;
  }

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int row = q0 + wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;  // and row + 8
  const float c2 = scale * kLog2e;
  const bf16* q_wg = sm.q + wg * 64 * 64;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kMaskValue, kMaskValue};  // running max, log2 units
  float l[2] = {0.f, 0.f};                // this thread's share of the denominator

  mbar_wait(&sm.q_full, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t & 1;
    mbar_wait(&sm.full[s], (t >> 1) & 1);

    float sc[BN / 2];
    wgmma_fence();
    mma_over_d<BN, D>(sc, q_wg, kFwdRows, sm.k[s], BN);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // Scores in log2 units, masked, and the new running max of each row.
    const int col0 = t * BN + (lane % 4) * 2;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int r = row + (i % 4 >= 2 ? 8 : 0), c = col0 + (i / 4) * 8 + (i % 2);
      float x = sc[i] * c2;
      if (causal && c > r) x = kMaskValue;
      if (c >= lk) x = -INFINITY;
      sc[i] = x;
      mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], x);
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = ex2(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= corr[h];
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int h = (i % 4) / 2;
      sc[i] = ex2(sc[i] - m[h]);
      l[h] += sc[i];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i % 4) / 2];

    uint32_t pa[BN / 16][4];
    fragment_to_a<BN / 16>(pa, sc);
    wgmma_fence();
    mma_accumulate<D>(acc, pa, sm.v[s]);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(&sm.empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = row + 8 * h;
    const float denom = fmaxf(l[h], 1e-30f), inv = 1.f / denom;
    if (r >= lq) continue;
    uint32_t* out = reinterpret_cast<uint32_t*>(o + ((size_t)bh * lq + r) * D + (lane % 4) * 2);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      out[j * 4] = pack_bf16(acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
    if (lane % 4 == 0) lse[(size_t)bh * lq + r] = m[h] * kLn2 + logf(denom);
  }
}

// K2, for _bwd_dq_kernel. Bound by its three products (19.4 GFLOP at the
// training shape: 0.0196 ms at 989 TFLOP/s; its 63.7 MB of traffic take
// 0.0190 ms at 3.35 TB/s, so it needs the tensor cores and the memory both
// near their peaks). K1's skeleton with K3's arithmetic. Block: 128 q rows (64 a
// warpgroup) of one bh; Q and dO for them arrive once by TMA and stay
// resident; the producer streams K and V tiles of BN rows through the ring
// up to the diagonal. Per tile, a warpgroup computes
//   S = Q K^T, dP = dO V^T               (wgmma, shared memory, K-major; one
//                                         commit group)
//   P = exp(S scale - lse[row])          (registers; 0 where masked, past lk
//                                         or at rows >= lq)
//   dS = P (dP - delta[row]) scale       (registers)
//   dQ += dS K                           (A = dS as bf16 registers, K read
//                                         MN-major)
// so no tile goes through shared memory: the S and dP fragments are the
// A layout of the last product. lse and delta are per row, so each thread
// keeps its two rows' values in registers from the start. P is absolute
// (relative to lse), so where dS rounds to bf16 does not depend on BN.
constexpr int kDqRows = 128;

template <int D, int BN>
struct DqSmem {
  alignas(1024) bf16 q[kDqRows * D];     // D / 64 panels of [kDqRows, 64]
  alignas(1024) bf16 dout[kDqRows * D];
  alignas(1024) bf16 k[2][BN * D];       // per stage: D / 64 panels of [BN, 64]
  alignas(1024) bf16 v[2][BN * D];
  uint64_t qdo_full, full[2], empty[2];
};

template <int D, int BN>
__global__ void __launch_bounds__(kBlockThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              bf16* __restrict__ dq, int lq, int lk, float scale, int causal) {
  using namespace hopper;
  auto& sm = aligned_smem<DqSmem<D, BN>>();
  constexpr int kPanels = D / 64;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kDqRows;  // longest causal rows first
  const int bh = blockIdx.y;
  const int nk = (lk + BN - 1) / BN;
  const int ntiles = causal ? min(nk, (q0 + kDqRows - 1) / BN + 1) : nk;

  if (threadIdx.x == 0) {
    mbar_init(&sm.qdo_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(&sm.qdo_full, 2 * kDqRows * D * sizeof(bf16));
      for (int p = 0; p < kPanels; ++p) {
        tma_load_3d(sm.q + p * kDqRows * 64, &tm_q, &sm.qdo_full, p * 64, q0, bh);
        tma_load_3d(sm.dout + p * kDqRows * 64, &tm_do, &sm.qdo_full, p * 64, q0, bh);
      }
      produce_kv<D, BN>(sm.k, sm.v, sm.full, sm.empty, &tm_k, &tm_v, ntiles, bh);
    }
    return;
  }

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int row = q0 + wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;  // and row + 8
  const int wg_last = q0 + wg * 64 + 63;  // a causal tile starting past it is all masked
  const float c2 = scale * kLog2e;
  const bf16* q_wg = sm.q + wg * 64 * 64;
  const bf16* do_wg = sm.dout + wg * 64 * 64;

  float lse2[2], del[2];  // the two rows' lse (log2 units) and delta
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    lse2[h] = r < lq ? lse[(size_t)bh * lq + r] * kLog2e : 0.f;
    del[h] = r < lq ? delta[(size_t)bh * lq + r] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(&sm.qdo_full, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t & 1;
    mbar_wait(&sm.full[s], (t >> 1) & 1);
    if (!(causal && t * BN > wg_last)) {
      float sc[BN / 2], ds[BN / 2];
      wgmma_fence();
      mma_over_d<BN, D>(sc, q_wg, kDqRows, sm.k[s], BN);
      mma_over_d<BN, D>(ds, do_wg, kDqRows, sm.v[s], BN);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(ds);

      const int col0 = t * BN + (lane % 4) * 2;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int h = (i % 4) / 2, r = row + 8 * h, c = col0 + (i / 4) * 8 + (i % 2);
        const bool live = r < lq && c < lk && !(causal && c > r);
        const float p = live ? ex2(sc[i] * c2 - lse2[h]) : 0.f;
        ds[i] = p * (ds[i] - del[h]) * scale;  // ds held dP until here
      }
      uint32_t dsa[BN / 16][4];
      fragment_to_a<BN / 16>(dsa, ds);
      wgmma_fence();
      mma_accumulate<D>(acc, dsa, sm.k[s]);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    mbar_arrive(&sm.empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= lq) continue;
    uint32_t* out = reinterpret_cast<uint32_t*>(dq + ((size_t)bh * lq + r) * D + (lane % 4) * 2);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      out[j * 4] = pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// K3, for _bwd_dkv_kernel. Block: 64 * NWG k rows (64 a warpgroup) of one
// bh, resident in shared memory; loops over q tiles of 64 from the diagonal on, so dK and dV need
// no atomics. The scores are computed transposed, k rows by q columns, so
// that both accumulating products take their left operand from registers:
//   S^T = K Q^T, dP^T = V dO^T           (wgmma, shared memory, K-major)
//   P^T = exp(S^T scale - lse[col])       (registers; lse, delta per column)
//   dS^T = P^T (dP^T - delta[col]) scale
//   dV += P^T dO, dK += dS^T Q            (A = bf16 registers, B MN-major)
constexpr int kDkvQ = 64;

template <int D, int NWG>
struct DkvSmem {
  alignas(1024) bf16 k[64 * NWG * D];  // D / 64 panels of [64 NWG, 64]
  alignas(1024) bf16 v[64 * NWG * D];
  alignas(1024) bf16 q[2][kDkvQ * D];  // per stage: D / 64 panels of [kDkvQ, 64]
  alignas(1024) bf16 dout[2][kDkvQ * D];
  alignas(16) float lse[2][kDkvQ];
  alignas(16) float delta[2][kDkvQ];
  uint64_t kv_full, full[2], empty[2];
};

template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_do,
                               const __grid_constant__ CUtensorMap tm_lse,
                               const __grid_constant__ CUtensorMap tm_delta,
                               bf16* __restrict__ dk, bf16* __restrict__ dv, int lq, int lk,
                               float scale, int causal) {
  using namespace hopper;
  auto& sm = aligned_smem<DkvSmem<D, NWG>>();
  constexpr int kPanels = D / 64, kRows = 64 * NWG, kConsumerThreads = NWG * 128;
  const int k0 = blockIdx.x * kRows;  // low k tiles walk the most q tiles: first
  const int bh = blockIdx.y;
  const int nq = (lq + kDkvQ - 1) / kDkvQ;
  const int qt0 = causal ? k0 / kDkvQ : 0;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumerThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {  // the producer warp
    if (threadIdx.x == kConsumerThreads) {
      mbar_expect_tx(&sm.kv_full, 2 * kRows * D * sizeof(bf16));
      for (int p = 0; p < kPanels; ++p) {
        tma_load_3d(sm.k + p * kRows * 64, &tm_k, &sm.kv_full, p * 64, k0, bh);
        tma_load_3d(sm.v + p * kRows * 64, &tm_v, &sm.kv_full, p * 64, k0, bh);
      }
      for (int t = 0; t < nq - qt0; ++t) {
        const int s = t & 1, q0 = (qt0 + t) * kDkvQ;
        if (t >= 2) mbar_wait(&sm.empty[s], ((t >> 1) - 1) & 1);
        mbar_expect_tx(&sm.full[s], 2 * kDkvQ * D * sizeof(bf16) + 2 * kDkvQ * sizeof(float));
        for (int p = 0; p < kPanels; ++p) {
          tma_load_3d(sm.q[s] + p * kDkvQ * 64, &tm_q, &sm.full[s], p * 64, q0, bh);
          tma_load_3d(sm.dout[s] + p * kDkvQ * 64, &tm_do, &sm.full[s], p * 64, q0, bh);
        }
        tma_load_1d(sm.lse[s], &tm_lse, &sm.full[s], bh * lq + q0);
        tma_load_1d(sm.delta[s], &tm_delta, &sm.full[s], bh * lq + q0);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int krow = k0 + wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;  // and krow + 8
  const float c2 = scale * kLog2e;
  const bf16* k_wg = sm.k + wg * 64 * 64;
  const bf16* v_wg = sm.v + wg * 64 * 64;

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(&sm.kv_full, 0);
  for (int t = 0; t < nq - qt0; ++t) {
    const int s = t & 1, q0 = (qt0 + t) * kDkvQ;
    mbar_wait(&sm.full[s], (t >> 1) & 1);

    float st[kDkvQ / 2], dpt[kDkvQ / 2];
    wgmma_fence();
    mma_over_d<kDkvQ, D>(st, k_wg, kRows, sm.q[s], kDkvQ);
    mma_over_d<kDkvQ, D>(dpt, v_wg, kRows, sm.dout[s], kDkvQ);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

#pragma unroll
    for (int j = 0; j < kDkvQ / 8; ++j) {
      const int cl = j * 8 + (lane % 4) * 2;  // column in the tile
      const float2 lse2 = *reinterpret_cast<const float2*>(&sm.lse[s][cl]);
      const float2 del2 = *reinterpret_cast<const float2*>(&sm.delta[s][cl]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e, r = krow + (e >= 2 ? 8 : 0), c = q0 + cl + (e % 2);
        const float lse_c = e % 2 ? lse2.y : lse2.x, delta_c = e % 2 ? del2.y : del2.x;
        const bool live = c < lq && !(causal && r > c);
        const float p = live ? ex2(st[i] * c2 - lse_c * kLog2e) : 0.f;
        dpt[i] = p * (dpt[i] - delta_c) * scale;
        st[i] = p;
      }
    }
    uint32_t pa[kDkvQ / 16][4], dsa[kDkvQ / 16][4];
    fragment_to_a<kDkvQ / 16>(pa, st);
    fragment_to_a<kDkvQ / 16>(dsa, dpt);
    wgmma_fence();
    mma_accumulate<D>(dv_acc, pa, sm.dout[s]);
    mma_accumulate<D>(dk_acc, dsa, sm.q[s]);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    mbar_arrive(&sm.empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = krow + 8 * h;
    if (r >= lk) continue;
    const size_t at = ((size_t)bh * lk + r) * D + (lane % 4) * 2;
    uint32_t* out_k = reinterpret_cast<uint32_t*>(dk + at);
    uint32_t* out_v = reinterpret_cast<uint32_t*>(dv + at);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      out_k[j * 4] = pack_bf16(dk_acc[4 * j + 2 * h], dk_acc[4 * j + 2 * h + 1]);
      out_v[j * 4] = pack_bf16(dv_acc[4 * j + 2 * h], dv_acc[4 * j + 2 * h + 1]);
    }
  }
}

// K1's k-tile width: 128 where the registers allow (D = 64), else 64.
template <int D>
constexpr int fwd_block_k() { return D == 64 ? 128 : 64; }

// K3's consumer warpgroups: two at D = 64; one at D = 128, where dK, dV and
// the two score tiles take 192 f32 registers a thread.
template <int D>
constexpr int dkv_warpgroups() { return D == 64 ? 2 : 1; }

template <int D>
cudaError_t launch_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                            int bh, int lq, int lk, float scale, int causal,
                            cudaStream_t stream) {
  constexpr int BN = fwd_block_k<D>();
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = hopper::map_rows_bf16(&tq, q, bh, lq, D, kFwdRows)) != cudaSuccess) return err;
  if ((err = hopper::map_rows_bf16(&tk, k, bh, lk, D, BN)) != cudaSuccess) return err;
  if ((err = hopper::map_rows_bf16(&tv, v, bh, lk, D, BN)) != cudaSuccess) return err;
  constexpr size_t smem = sizeof(FwdSmem<D, BN>) + 1024;
  err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D, BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_fwd_wgmma_kernel<D, BN><<<dim3((lq + kFwdRows - 1) / kFwdRows, bh), kBlockThreads, smem,
                                  stream>>>(tq, tk, tv, static_cast<bf16*>(o),
                                            static_cast<float*>(lse), lq, lk, scale, causal);
  return cudaGetLastError();
}

// K2's k-tile width, at both head dims: dQ, S and dP hold D / 2 + BN f32
// registers a thread, so BN = 128 at D = 64 would start near 200.
constexpr int kDqBlockK = 64;

template <int D>
cudaError_t launch_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq, int bh, int lq,
                               int lk, float scale, int causal, cudaStream_t stream) {
  constexpr int BN = kDqBlockK;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = hopper::map_rows_bf16(&tq, q, bh, lq, D, kDqRows)) != cudaSuccess) return err;
  if ((err = hopper::map_rows_bf16(&tdo, dout, bh, lq, D, kDqRows)) != cudaSuccess) return err;
  if ((err = hopper::map_rows_bf16(&tk, k, bh, lk, D, BN)) != cudaSuccess) return err;
  if ((err = hopper::map_rows_bf16(&tv, v, bh, lk, D, BN)) != cudaSuccess) return err;
  constexpr size_t smem = sizeof(DqSmem<D, BN>) + 1024;
  err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D, BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wgmma_kernel<D, BN><<<dim3((lq + kDqRows - 1) / kDqRows, bh), kBlockThreads, smem,
                                     stream>>>(tq, tk, tv, tdo, static_cast<const float*>(lse),
                                               static_cast<const float*>(delta),
                                               static_cast<bf16*>(dq), lq, lk, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dk, void* dv, int bh,
                                int lq, int lk, float scale, int causal, cudaStream_t stream) {
  constexpr int NWG = dkv_warpgroups<D>(), kRows = 64 * NWG;
  CUtensorMap tq, tk, tv, tdo, tlse, tdelta;
  cudaError_t err;
  if ((err = hopper::map_rows_bf16(&tq, q, bh, lq, D, kDkvQ)) != cudaSuccess) return err;
  if ((err = hopper::map_rows_bf16(&tdo, dout, bh, lq, D, kDkvQ)) != cudaSuccess) return err;
  if ((err = hopper::map_rows_bf16(&tk, k, bh, lk, D, kRows)) != cudaSuccess) return err;
  if ((err = hopper::map_rows_bf16(&tv, v, bh, lk, D, kRows)) != cudaSuccess) return err;
  if ((err = hopper::map_vec_f32(&tlse, lse, (long long)bh * lq, kDkvQ)) != cudaSuccess)
    return err;
  if ((err = hopper::map_vec_f32(&tdelta, delta, (long long)bh * lq, kDkvQ)) != cudaSuccess)
    return err;
  constexpr size_t smem = sizeof(DkvSmem<D, NWG>) + 1024;
  err = cudaFuncSetAttribute(flash_bwd_dkv_wgmma_kernel<D, NWG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_wgmma_kernel<D, NWG><<<dim3((lk + kRows - 1) / kRows, bh), NWG * 128 + 32, smem,
                                       stream>>>(tq, tk, tv, tdo, tlse, tdelta,
                                                 static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                                                 lq, lk, scale, causal);
  return cudaGetLastError();
}

}  // namespace sm90

}  // namespace

// dtype codes: 0 = f32, 1 = bf16. f32 runs the f32-FMA kernels; bf16 runs
// the tensor-core kernels of namespace sm90. Each entry point
// returns the cudaError_t of the launch (0 on success); an unsupported
// dtype or head dimension returns cudaErrorInvalidValue and launches
// nothing.
#define RTT_DISPATCH(DTYPE, HEAD_DIM, F32_LAUNCH, BF16_LAUNCH, ...)               \
  switch ((DTYPE) * 1000 + (HEAD_DIM)) {                                        \
    case 0 * 1000 + 64: return F32_LAUNCH<64>(__VA_ARGS__);                     \
    case 0 * 1000 + 128: return F32_LAUNCH<128>(__VA_ARGS__);                   \
    case 1 * 1000 + 64: return BF16_LAUNCH<64>(__VA_ARGS__);                    \
    case 1 * 1000 + 128: return BF16_LAUNCH<128>(__VA_ARGS__);                  \
    default: return cudaErrorInvalidValue;                                      \
  }

extern "C" int rtt_flash_fwd(int dtype, int head_dim, const void* q, const void* k, const void* v,
                             void* o, void* lse, int bh, int lq, int lk, float scale, int causal,
                             void* stream) {
  RTT_DISPATCH(dtype, head_dim, launch_fwd, sm90::launch_fwd_bf16, q, k, v, o, lse, bh, lq, lk,
               scale, causal, static_cast<cudaStream_t>(stream));
}

extern "C" int rtt_flash_bwd_dq(int dtype, int head_dim, const void* q, const void* k,
                                const void* v, const void* dout, const void* lse,
                                const void* delta, void* dq, int bh, int lq, int lk, float scale,
                                int causal, void* stream) {
  RTT_DISPATCH(dtype, head_dim, launch_bwd_dq, sm90::launch_bwd_dq_bf16, q, k, v, dout, lse,
               delta, dq, bh, lq, lk, scale, causal, static_cast<cudaStream_t>(stream));
}

extern "C" int rtt_flash_bwd_dkv(int dtype, int head_dim, const void* q, const void* k,
                                 const void* v, const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int bh, int lq, int lk,
                                 float scale, int causal, void* stream) {
  RTT_DISPATCH(dtype, head_dim, launch_bwd_dkv, sm90::launch_bwd_dkv_bf16, q, k, v, dout, lse,
               delta, dk, dv, bh, lq, lk, scale, causal, static_cast<cudaStream_t>(stream));
}

extern "C" const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

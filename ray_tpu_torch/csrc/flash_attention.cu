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
// Numerics follow the TPU kernels: each tile is converted to f32 as it is
// loaded, every product, sum and softmax step is an f32 FMA, and outputs are
// rounded to the input dtype once, at the end. The causal mask is the
// reference's finite -1e30 on global row/column indices; columns past the
// end of the sequence get -inf (probability exactly 0); the logsumexp uses
// max(l, 1e-30) as the reference does.
//
// Design. This is the simple first version: right before fast. The TPU
// grid's sequential dimension, with scratch carried from one step to the
// next, becomes a loop inside one thread block:
//   - forward and dQ: one block per (bh, 64-row q tile), looping over the
//     k tiles up to the diagonal;
//   - dK/dV: one block per (bh, 64-row k tile), looping over the q tiles
//     from the diagonal on, so dK and dV are written without atomics, as in
//     the TPU split.
// 256 threads form a 16 x 16 grid; each thread owns a micro-tile of rows
// ty*4+i and columns tx+16*j. Tiles sit in dynamic shared memory as f32 rows
// padded by one float (no bank conflicts): at D = 64 the blocks take 67 KB
// (forward), 84 KB (dQ) and 100 KB (dK/dV), above the 48 KB static limit.
// The tile is fixed at 64 rows; the API's block_q/block_k only choose
// between this path and the reference, and the result does not depend on
// tiling beyond rounding.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s) at the GPT-2 125M
// training shape [96, 1024, 64] bf16 causal, counting each input read once
// and each output written once: forward 12.9 GFLOP / 50.7 MB -> 15 us, set by
// bytes; dQ 19.4 GFLOP -> 20 us and dK/dV 25.8 GFLOP -> 26 us, set by
// operations. These kernels use no tensor cores (f32 FMA on the CUDA cores,
// 67 TFLOP/s at most), read every operand from shared memory for each FMA
// pair, and reload K/V (or Q/dO) from L2 for every tile, so they run far
// from that bound. wgmma on bf16 tiles, TMA loads and a pipelined ring of
// tiles are the work of a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kTile = 64;                  // rows of a Q or K tile
constexpr int kThreads = 256;              // threads of a block
constexpr int kGrid = 16;                  // the threads form kGrid x kGrid
constexpr int kMicro = kTile / kGrid;      // rows (and tile columns) a thread owns
constexpr int kWarps = kThreads / 32;
constexpr int kTileLd = kTile + 1;         // row stride of a [kTile, kTile] tile
constexpr float kMaskValue = -1e30f;       // the reference's causal mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Rows [row0, row0 + kTile) of a contiguous [len, D] matrix into an f32 tile
// with row stride D + 1; rows past len become zeros.
template <typename T, int D>
__device__ void load_rows(float* dst, const T* src, int row0, int len) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = row0 + r < len ? to_f32(src[(size_t)(row0 + r) * D + c]) : 0.f;
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

// Rows of the micro-tile that lie before `len` go to dst ([len, D]) in T.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[kMicro][D / kGrid], int row0,
                                           int len, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int row = row0 + ty * kMicro + i;
    if (row >= len) continue;
#pragma unroll
    for (int j = 0; j < D / kGrid; ++j) dst[(size_t)row * D + tx + kGrid * j] = from_f32<T>(acc[i][j]);
  }
}

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * kTile * (D + 1) + kTile * kTileLd + 3 * kTile);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ lse, int lq, int lk, float scale,
                     int causal) {
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

  load_rows<T, D>(sQ, q, q0, lq);
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
    load_rows<T, D>(sK, k, k0, lk);
    load_rows<T, D>(sV, v, k0, lk);
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
  store_rows<T, D>(o, acc, q0, lq, ty, tx);
}

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * kTileLd + 2 * kTile);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq, int lq, int lk,
                        float scale, int causal) {
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

  load_rows<T, D>(sQ, q, q0, lq);
  load_rows<T, D>(sdO, dout, q0, lq);
  load_vec(sLse, lse, q0, lq);
  load_vec(sDelta, delta, q0, lq);
  float acc[kMicro][D / kGrid];
  zero<D>(acc);

  const int nk = (lk + kTile - 1) / kTile;
  const int last = causal ? min(nk - 1, (q0 + kTile - 1) / kTile) : nk - 1;
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_rows<T, D>(sK, k, k0, lk);
    load_rows<T, D>(sV, v, k0, lk);
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
  store_rows<T, D>(dq, acc, q0, lq, ty, tx);
}

template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * kTileLd + 2 * kTile);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         const T* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                         int lq, int lk, float scale, int causal) {
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

  load_rows<T, D>(sK, k, k0, lk);
  load_rows<T, D>(sV, v, k0, lk);
  float dk_acc[kMicro][D / kGrid], dv_acc[kMicro][D / kGrid];
  zero<D>(dk_acc);
  zero<D>(dv_acc);

  const int nq = (lq + kTile - 1) / kTile;
  for (int qt = causal ? k0 / kTile : 0; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_rows<T, D>(sQ, q, q0, lq);
    load_rows<T, D>(sdO, dout, q0, lq);
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
  store_rows<T, D>(dk, dk_acc, k0, lk, ty, tx);
  store_rows<T, D>(dv, dv_acc, k0, lk, ty, tx);
}

int tiles(int len) { return (len + kTile - 1) / kTile; }

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                       int lq, int lk, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T, D><<<dim3(tiles(lq), bh), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), lq, lk, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, void* dq, int bh, int lq, int lk,
                          float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dq_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, D><<<dim3(tiles(lq), bh), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), lq, lk, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dk, void* dv, int bh, int lq,
                           int lk, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<T, D><<<dim3(tiles(lk), bh), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), lq, lk, scale,
      causal);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = f32, 1 = bf16. Each entry point returns the
// cudaError_t of the launch (0 on success); an unsupported dtype or head
// dimension returns cudaErrorInvalidValue and launches nothing.
#define RTT_DISPATCH(DTYPE, HEAD_DIM, LAUNCH, ...)                              \
  switch ((DTYPE) * 1000 + (HEAD_DIM)) {                                        \
    case 0 * 1000 + 64: return LAUNCH<float, 64>(__VA_ARGS__);                  \
    case 0 * 1000 + 128: return LAUNCH<float, 128>(__VA_ARGS__);                \
    case 1 * 1000 + 64: return LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__);          \
    case 1 * 1000 + 128: return LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__);        \
    default: return cudaErrorInvalidValue;                                      \
  }

extern "C" int rtt_flash_fwd(int dtype, int head_dim, const void* q, const void* k, const void* v,
                             void* o, void* lse, int bh, int lq, int lk, float scale, int causal,
                             void* stream) {
  RTT_DISPATCH(dtype, head_dim, launch_fwd, q, k, v, o, lse, bh, lq, lk, scale, causal,
               static_cast<cudaStream_t>(stream));
}

extern "C" int rtt_flash_bwd_dq(int dtype, int head_dim, const void* q, const void* k,
                                const void* v, const void* dout, const void* lse,
                                const void* delta, void* dq, int bh, int lq, int lk, float scale,
                                int causal, void* stream) {
  RTT_DISPATCH(dtype, head_dim, launch_bwd_dq, q, k, v, dout, lse, delta, dq, bh, lq, lk, scale,
               causal, static_cast<cudaStream_t>(stream));
}

extern "C" int rtt_flash_bwd_dkv(int dtype, int head_dim, const void* q, const void* k,
                                 const void* v, const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int bh, int lq, int lk,
                                 float scale, int causal, void* stream) {
  RTT_DISPATCH(dtype, head_dim, launch_bwd_dkv, q, k, v, dout, lse, delta, dk, dv, bh, lq, lk,
               scale, causal, static_cast<cudaStream_t>(stream));
}

extern "C" const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

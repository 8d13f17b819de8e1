// Hopper (sm_90a) building blocks in inline PTX, for the tensor-core flash
// kernels of flash_attention.cu: mbarriers, TMA tile loads, shared-memory
// matrix descriptors and the warpgroup products (wgmma) they use.
//
// Shared-memory tiles are 128-byte swizzled (SW128), as a TMA load with
// CU_TENSOR_MAP_SWIZZLE_128B writes them: a tile of bf16 rows is cut into
// panels of 64 columns; in a panel each row is 128 bytes and the 16-byte
// chunks of row r sit at chunk index (c ^ r % 8). Every tile and panel
// starts on a 1024-byte boundary, so the swizzle phase is the row's.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, nothing is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A struct of tiles at the start of dynamic shared memory, aligned up to
// 1024 bytes (launch with sizeof(T) + 1024 bytes).
template <typename T>
__device__ __forceinline__ T& aligned_smem() {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t pad = (1024u - (smem_addr(smem_raw) & 1023u)) & 1023u;
  return *reinterpret_cast<T*>(smem_raw + pad);
}

// ---------------------------------------------------------------------------
// mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic for this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// Waits for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// TMA loads: one thread asks for a box; the hardware writes it (zeros out
// of bounds) and completes `bar`'s transaction count with its bytes.

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma

// Descriptor of an SW128 operand in shared memory. K-major (the product's
// K dimension runs along the 128-byte rows): 8-row groups 1024 bytes apart
// (SBO), LBO unused; a k16 step adds 32 bytes to the start address inside
// a panel. MN-major (rows are K): 8-row K groups 1024 bytes apart (SBO),
// and `lbo` bytes from one 64-column panel of M or N to the next.
__device__ __forceinline__ uint64_t desc_sw128(const void* tile, uint32_t lbo = 16) {
  const uint64_t addr = smem_addr(tile);
  return ((addr & 0x3FFFFull) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Two f32 to a packed bf16 pair, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

#define RTT_F8(d, i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define RTT_F32(d) RTT_F8(d, 0), RTT_F8(d, 8), RTT_F8(d, 16), RTT_F8(d, 24)
#define RTT_F64(d) RTT_F32(d), RTT_F8(d, 32), RTT_F8(d, 40), RTT_F8(d, 48), RTT_F8(d, 56)

// d[64 x N] (+)= A[64 x 16] B[16 x N] in bf16 with f32 sums, for one
// warpgroup. Thread t of the warpgroup holds, for each 8-column block j of
// d, d[4j + e] at row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2) and column
// 8j + 2 (t % 4) + e % 2. ss: A and B from shared memory, both K-major.
// rs: A from registers, in the layout of two adjacent 8-column blocks of
// d rounded to bf16 pairs (pack_bf16); B MN-major. `accumulate` = 0
// overwrites d.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t a, uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        : RTT_F32(d)
        : "l"(a), "l"(b), "r"(accumulate));
  }
  __device__ __forceinline__ static void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
        "}\n"
        : RTT_F32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void ss(float (&d)[64], uint64_t a, uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n"
        "}\n"
        : RTT_F64(d)
        : "l"(a), "l"(b), "r"(accumulate));
  }
  __device__ __forceinline__ static void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
        "}\n"
        : RTT_F64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};

#undef RTT_F8
#undef RTT_F32
#undef RTT_F64

// Packs the f32 fragment of a 64 x (16 J) product (as Wgmma leaves it) into
// the bf16 A operands of J k16 steps of an rs product.
template <int J>
__device__ __forceinline__ void fragment_to_a(uint32_t (&a)[J][4], const float (&d)[8 * J]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    a[j][0] = pack_bf16(d[8 * j + 0], d[8 * j + 1]);
    a[j][1] = pack_bf16(d[8 * j + 2], d[8 * j + 3]);
    a[j][2] = pack_bf16(d[8 * j + 4], d[8 * j + 5]);
    a[j][3] = pack_bf16(d[8 * j + 6], d[8 * j + 7]);
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps. cuTensorMapEncodeTiled is fetched through the
// runtime's entry-point query, so the library needs no -lcuda.

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A [n, len, d] bf16 tensor (contiguous) read in boxes of 64 columns x
// `rows` rows of one n, SW128. Rows past len read as zeros.
inline cudaError_t map_rows_bf16(CUtensorMap* map, const void* base, int n, int len, int d,
                                 int rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {cuuint64_t(d), cuuint64_t(len), cuuint64_t(n)};
  const cuuint64_t strides[2] = {cuuint64_t(d) * 2, cuuint64_t(len) * d * 2};
  const cuuint32_t box[3] = {64, cuuint32_t(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A flat f32 vector of `len` entries read in boxes of `box` entries;
// entries past len read as zeros.
inline cudaError_t map_vec_f32(CUtensorMap* map, const void* base, long long len, int box) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[1] = {cuuint64_t(len)};
  const cuuint64_t strides[1] = {0};  // rank 1: no stride is read
  const cuuint32_t boxes[1] = {cuuint32_t(box)};
  const cuuint32_t unit[1] = {1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(base),
                            dims, strides, boxes, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper

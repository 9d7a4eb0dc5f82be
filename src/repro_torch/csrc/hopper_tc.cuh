// Hopper's tensor-core machinery, shared by the bf16 flash kernels
// (csrc/flash_attn.cu's flash_fwd_tc and csrc/flash_attn_bwd.cu's
// flash_bwd_tc): mbarriers, TMA loads and stores, wgmma descriptors and
// products, the hi + lo split of an f32 fragment into two bf16 A operands,
// and the host's tensor-map encoder.
//
// Layout every helper assumes.  A bf16 tile lies in shared memory as
// panels of 64 columns × `rows` rows, 128 bytes a row, in the 128-byte
// swizzle TMA writes (16-byte chunk c of row r at chunk c ^ (r % 8)); each
// panel is 1024-byte aligned.  Tensor maps are 3-d (dh, S, heads), so a
// box never crosses into the next head and rows past S read as zero.
//
// wgmma's accumulator fragment of m64nN (f32): thread t of the warpgroup
// holds rows 16·(t / 32) + (t % 32) / 4 (registers with (i / 2) even) and
// that + 8 (odd), columns 8·(i / 4) + 2·(t % 4) + i % 2.  Register pair
// (8j + 2u, 8j + 2u + 1) of it is register u of the bf16 A fragment of
// columns 16j .. 16j + 15, so a product's result feeds the next product
// from registers (split_p).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int kPanel = 64;   // bf16 columns per 128-byte row

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
// A wait past 2^34 SM clocks (~9 s) traps: a load that never lands is a
// launch error, not a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// One box of a 3-d tensor map (dh, S, heads) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// `bytes` contiguous bytes of device memory into shared memory, both
// 16-byte aligned and a multiple of 16 long, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One box of shared memory into a 3-d tensor map (dh, S, heads).
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading byte offset (used only by an MN-major operand wider
// than one 64-column panel), stride byte offset 1024 (8 rows of 128 B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pin registers in place across the asynchronous wgmma: the compiler may
// neither move their writes past the fence nor reuse them before the wait.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define ACC8(c, d, i)                                                  \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]), c(d[i + 5]), \
      c(d[i + 6]), c(d[i + 7])
#define ACC32(c, d) ACC8(c, d, 0), ACC8(c, d, 8), ACC8(c, d, 16), ACC8(c, d, 24)
#define ACC64(c, d) ACC32(c, d), ACC8(c, d, 32), ACC8(c, d, 40), \
      ACC8(c, d, 48), ACC8(c, d, 56)
#define OPS64                                   \
  "%0, %1, %2, %3, %4, %5, %6, %7, "            \
  "%8, %9, %10, %11, %12, %13, %14, %15, "      \
  "%16, %17, %18, %19, %20, %21, %22, %23, "    \
  "%24, %25, %26, %27, %28, %29, %30, %31, "    \
  "%32, %33, %34, %35, %36, %37, %38, %39, "    \
  "%40, %41, %42, %43, %44, %45, %46, %47, "    \
  "%48, %49, %50, %51, %52, %53, %54, %55, "    \
  "%56, %57, %58, %59, %60, %61, %62, %63"
#define OPS32                                   \
  "%0, %1, %2, %3, %4, %5, %6, %7, "            \
  "%8, %9, %10, %11, %12, %13, %14, %15, "      \
  "%16, %17, %18, %19, %20, %21, %22, %23, "    \
  "%24, %25, %26, %27, %28, %29, %30, %31"

// d (64 × 128 f32) = a (64 × 16) · bᵀ (16 × 128), both K-major in shared
// memory; `first` drops d's old value.
__device__ __forceinline__ void wgmma_qk_first(float (&d)[64], uint64_t a,
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" OPS64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC64("=f", d)
      : "l"(a), "l"(b), "n"(0));
}
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" OPS64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC64("+f", d)
      : "l"(a), "l"(b), "n"(1));
}
// The same at 64 columns: d (64 × 64 f32).
__device__ __forceinline__ void wgmma_qk_first(float (&d)[32], uint64_t a,
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" OPS32
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32("=f", d)
      : "l"(a), "l"(b), "n"(0));
}
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" OPS32
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32("+f", d)
      : "l"(a), "l"(b), "n"(1));
}

// d (64 × N f32) += a (64 × 16 bf16, registers) · b (16 × N, MN-major in
// shared memory, 64 columns a panel, panels `lbo` bytes apart), N = 64 or
// 128.
__device__ __forceinline__ void wgmma_pv(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" OPS32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32("+f", d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}
__device__ __forceinline__ void wgmma_pv(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" OPS64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC64("+f", d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

// 2^x on the MUFU unit (relative error ~2^-22).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// An f32 accumulator fragment s of N / 8 16-column steps as two bf16 A
// fragments, s = hi + lo to ~16 significant bits: hi = bf16(s),
// lo = bf16(s − hi), both rounded to nearest even.
template <int N>
__device__ __forceinline__ void split_p(const float (&s)[N],
                                        uint32_t (&hi)[N / 8][4],
                                        uint32_t (&lo)[N / 8][4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float x0 = s[8 * j + 2 * u], x1 = s[8 * j + 2 * u + 1];
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(h2);
      hi[j][u] = bf16x2_bits(h2);
      lo[j][u] = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
    }
}

// Error codes past cudaError_t's range for the tensor-map encode.
constexpr int kNoEncoder = 0x10000;     // driver entry point not found
constexpr int kEncodeFailed = 0x20000;  // + the CUresult

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Tensor map of a (heads, S, dh) bf16 tensor as 3-d (dh, S, heads), boxes
// of 64 columns × `rows` rows, 128-byte swizzle; 0 or an error code.
int encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int heads,
           int S, int dh, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)dh, (cuuint64_t)S,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)dh * 2,
                                 (cuuint64_t)S * dh * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kPanel, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)r;
}

// The message of a launch's error code: the encoder's own, else CUDA's.
const char* tc_error_string(int err) {
  static char buf[96];
  if (err == kNoEncoder)
    return "cuTensorMapEncodeTiled not found through cudaGetDriverEntryPoint";
  if (err >= kEncodeFailed) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed (CUresult %d)",
             err - kEncodeFailed);
    return buf;
  }
  return cudaGetErrorString((cudaError_t)err);
}

}  // namespace

// Flash-attention forward for Hopper (sm_90a): bf16 on the tensor cores,
// f32 on the CUDA cores.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attn/kernel.py:
//   flash_fwd_pallas (kernel.py:86, body _flash_fwd_kernel) -> flash_attn_fwd
//
// What it computes, for q (BH, S, dh) and k, v (BHkv, S, dh) with
// BH = BHkv·G, in bf16 or f32.  Query head bh reads KV head bh / G:
//   s = q kᵀ · scale in f32, scale = 1/√dh;
//   causal: s[i][j] = -1e30 (not -inf) where key j > query i;
//   online softmax over KV tiles: m′ = max(m, rowmax s), p = exp(s − m′),
//   c = exp(m − m′), l′ = l·c + Σp, acc′ = acc·c + p·v;
//   o = acc / max(l, 1e-30) in q's type, lse = m + log max(l, 1e-30) in f32.
//
// What bounds it on this card.  At llama3-8b's prefill (B=1, S=512, H=32,
// Hkv=8, dh=128, bf16) the function reads q (4 MiB), k and v (1 MiB each)
// and writes o (4 MiB) and lse (64 KiB): ~10.5 MB, 3.1 µs at 3.35 TB/s.
// Its causal work, 4·dh·H·S(S+1)/2 = 2.15 GFLOP, is 2.2 µs at the bf16
// tensor-core peak (989 TFLOP/s), so the function is bound by bytes.  The
// kernel is not: 32 heads × 4 query tiles are one wave of 128 CTAs, so the
// longest CTA's chain of dependent steps sets the time, and on that chain
// the tensor cores do P·V twice (the split below): per 128-key tile a CTA
// needs ~3,100 tensor-core cycles where one bf16 P would need ~2,050.
//
// bf16 design (flash_fwd_tc): tensor cores fed by TMA, warp-specialised.
// - A CTA owns 128 query rows of one head: two consumer warpgroups of 64
//   rows each, and a producer warpgroup whose one thread issues the TMA
//   loads (setmaxnreg moves registers from the producer, 40, to the
//   consumers, 232).  A 64-row tail past S leaves the second consumer
//   idle: it is masked, not refused.
// - Q is loaded once by TMA and stays in shared memory, unscaled bf16.
//   K and V come in 128-key tiles through a 3-stage ring (230 KB at
//   dh = 128), filled by TMA with the 128-byte swizzle; "full" mbarriers
//   (expect-tx) tell the consumers a stage arrived, "empty" ones (one
//   arrival per consumer thread) give it back to the producer.  Tensor
//   maps are 3-d (dh, S, heads), so rows past S read as zero and never
//   cross into the next head.  They are encoded on the host with
//   cuTensorMapEncodeTiled, got through cudaGetDriverEntryPoint (no
//   -lcuda).
// - S = Q·Kᵀ is wgmma m64n128k16 (bf16 × bf16 → f32, both operands from
//   shared memory, K-major).  A product of two bf16 values is exact in
//   f32, so leaving the scale to the f32 scores differs from the
//   reference's scale-before by one f32 rounding: p = 2^(s·c − m·c) with
//   c = scale·log2 e, m kept in units of the unscaled scores.
// - The online softmax runs in registers on wgmma's accumulator fragment:
//   a thread holds rows r and r + 8 of its warp's 16, so row max and row
//   sum reduce over the 4 lanes that share a row (shfl_xor 1, 2).
// - P·V keeps the reference's f32 p: p is split into hi = bf16(p) and
//   lo = bf16(p − hi), and two wgmma m64n(dh)k16 per 16 keys (P from
//   registers as the A operand, V from shared memory, MN-major) add both
//   into the same f32 accumulator: p to ~16 significant bits.  The
//   accumulator fragment of Q·Kᵀ is, pair by pair, the A fragment of P·V,
//   so P never goes through shared memory.
// - Tile j's Q·Kᵀ and tile j − 1's P·V are issued together; the softmax
//   of tile j runs while P·V does, and tile j − 1's stage goes back to
//   the producer when its P·V is in.
// - A causal CTA stops at the diagonal, and blockIdx.y runs the query
//   tiles from the last (longest) to the first, so the wave does not end
//   on a lone diagonal-heavy CTA.
// - o = acc · (1 / max(l, 1e-30)) is rounded to nearest-even bf16, staged
//   in the warpgroup's Q panels in the swizzle TMA reads and stored by
//   TMA; lse in f32.
//
// f32 design (flash_fwd_f32): the CUDA-core kernel of the first port,
// kept because f32 has no tensor-core path here (TF32 would round q, k and
// v to 10 mantissa bits, and no kernel of the port uses it).  One CTA per
// (bh, 64-row q tile) of 256 threads; 64 query rows (scaled, as in the
// reference) and each 64-key tile of K and V staged through shared memory
// in f32 (113.5 KB at dh=128, rows at an odd stride so the score loop's
// column reads are free of bank conflicts); f32 FMA for both products.
// What bounds it is the f32 FMA rate and the shared-memory reads that feed
// it.  S must be a multiple of 64 for both kernels (the wrapper checks).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;   // 8 warps; a 16×16 grid for the tile products
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 64;         // query rows per CTA
constexpr int kBKV = 64;        // keys per KV tile
constexpr int kLDP = kBKV + 1;  // row stride of the score tile

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

// Dynamic shared memory of one CTA, in floats: Q and K tiles at an odd
// stride, the V tile, the score tile, and m, l, c per query row.
constexpr size_t smem_floats(int dh) {
  return (size_t)kBQ * (dh + 1) + (size_t)kBKV * (dh + 1) +
         (size_t)kBKV * dh + (size_t)kBQ * kLDP + 3 * (size_t)kBQ;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int S, int G, float scale,
              int causal) {
  constexpr int LD = DH + 1;
  constexpr int NC = DH / 16;   // output columns per thread
  constexpr int RW = kBQ / kWarps;  // softmax rows per warp
  extern __shared__ float smem[];
  float* sQ = smem;             // kBQ × LD
  float* sK = sQ + kBQ * LD;    // kBKV × LD
  float* sV = sK + kBKV * LD;   // kBKV × DH
  float* sP = sV + kBKV * DH;   // kBQ × kLDP: scores, then probabilities
  float* sM = sP + kBQ * kLDP;  // running row max
  float* sL = sM + kBQ;         // running row sum
  float* sC = sL + kBQ;         // this tile's correction exp(m − m′)

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const float* gq = q + ((size_t)bh * S + q0) * DH;
  const size_t kv_base = (size_t)(bh / G) * S * DH;

  for (int idx = tid; idx < kBQ * DH; idx += kThreads) {
    const int r = idx / DH, c = idx - r * DH;
    sQ[r * LD + c] = gq[idx] * scale;
  }
  if (tid < kBQ) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }
  float acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < NC; ++b) acc[a][b] = 0.f;

  // causal: the first tile whose first key lies after this CTA's last query
  const int n_kv = S / kBKV;
  const int kv_end = causal ? min(n_kv, (q0 + kBQ - 1) / kBKV + 1) : n_kv;

  for (int kj = 0; kj < kv_end; ++kj) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    const float* gk = k + kv_base + (size_t)kj * kBKV * DH;
    const float* gv = v + kv_base + (size_t)kj * kBKV * DH;
    for (int idx = tid; idx < kBKV * DH; idx += kThreads) {
      const int r = idx / DH, c = idx - r * DH;
      sK[r * LD + c] = gk[idx];
      sV[idx] = gv[idx];
    }
    __syncthreads();

    // scores: thread (ty, tx) owns rows ty + 16a and columns tx + 16b
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = sQ[(ty + 16 * a) * LD + d];
#pragma unroll
      for (int b = 0; b < 4; ++b) kb[b] = sK[(tx + 16 * b) * LD + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = ty + 16 * a, c = tx + 16 * b;
        const bool masked = causal && kj * kBKV + c > q0 + r;
        sP[r * kLDP + c] = masked ? kNegInf : s[a][b];
      }
    __syncthreads();

    // online softmax: warp w owns rows RW·w .. RW·w + RW − 1, a lane owns
    // columns lane and lane + 32 of each
    for (int rr = 0; rr < RW; ++rr) {
      const int r = warp * RW + rr;
      float* row = sP + r * kLDP;
      const float x0 = row[lane], x1 = row[lane + 32];
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      row[lane] = p0;
      row[lane + 32] = p1;
      const float psum = warp_sum(p0 + p1);
      __syncwarp();  // every lane has read sM[r] before lane 0 writes it
      if (lane == 0) {
        const float c = expf(m_prev - m_new);
        sL[r] = sL[r] * c + psum;
        sM[r] = m_new;
        sC[r] = c;
      }
    }
    __syncthreads();

    // acc = acc·c + P·V: thread (ty, tx) owns rows ty + 16a, columns tx + 16b
    float pv[4][NC];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < NC; ++b) pv[a][b] = 0.f;
#pragma unroll 4
    for (int j = 0; j < kBKV; ++j) {
      float pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = sP[(ty + 16 * a) * kLDP + j];
#pragma unroll
      for (int b = 0; b < NC; ++b) {
        const float vb = sV[j * DH + tx + 16 * b];
#pragma unroll
        for (int a = 0; a < 4; ++a) pv[a][b] = fmaf(pa[a], vb, pv[a][b]);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float c = sC[ty + 16 * a];
#pragma unroll
      for (int b = 0; b < NC; ++b) acc[a][b] = acc[a][b] * c + pv[a][b];
    }
  }

  // sM and sL were last written before the loop's final __syncthreads
  float* go = o + ((size_t)bh * S + q0) * DH;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    const float l = fmaxf(sL[r], 1e-30f);
#pragma unroll
    for (int b = 0; b < NC; ++b) go[r * DH + tx + 16 * b] = acc[a][b] / l;
  }
  if (tid < kBQ)
    lse[(size_t)bh * S + q0 + tid] = sM[tid] + logf(fmaxf(sL[tid], 1e-30f));
}

// Opt `kern` in to `smem` bytes of dynamic shared memory on the current
// card, once per card (bit `device` of *done; cards past 32 every call).
template <typename Kernel>
int opt_in(Kernel kern, size_t smem, unsigned* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 32 && (*done >> dev & 1u)) return 0;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess && dev < 32) *done |= 1u << dev;
  return (int)e;
}

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int BH, int S, int G, float scale, int causal,
               cudaStream_t stream) {
  static unsigned done = 0;
  auto kern = flash_fwd_f32<DH>;
  const size_t smem = smem_floats(DH) * sizeof(float);
  const int e = opt_in(kern, smem, &done);
  if (e) return e;
  const dim3 grid(S / kBQ, BH);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, G, scale,
      causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: wgmma and TMA
// ---------------------------------------------------------------------------

constexpr int kTcRows = 64;                 // query rows per consumer
constexpr int kConsumers = 2;               // consumer warpgroups per CTA
constexpr int kTcBQ = kTcRows * kConsumers; // query rows per CTA
constexpr int kTcBKV = 128;                 // keys per KV tile
constexpr int kStages = 3;                  // K/V ring depth
constexpr int kTcThreads = 128 * (kConsumers + 1);
constexpr int kPanel = 64;                  // bf16 columns per 128-byte row
constexpr uint32_t kQBox = kTcRows * 128;   // bytes of a 64-row Q panel
constexpr uint32_t kKVBox = kTcBKV * 128;   // bytes of a 128-row K/V panel

// Dynamic shared memory of one bf16 CTA (bytes): Q [consumer][panel],
// K and V [stage][panel], each panel 1024-byte aligned for the 128-byte
// swizzle, then the mbarriers (q_full, full[stages], empty[stages]), plus
// 1 KB to align the base.
template <int DH>
struct TcSmem {
  static constexpr int kPanels = DH / kPanel;
  static constexpr uint32_t q = 0;
  static constexpr uint32_t k = q + kConsumers * kPanels * kQBox;
  static constexpr uint32_t v = k + kStages * kPanels * kKVBox;
  static constexpr uint32_t bar = v + kStages * kPanels * kKVBox;
  static constexpr uint32_t bytes = bar + 8 * (1 + 2 * kStages) + 1024;
};

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

// acc += hi·V + lo·V for the V tile at shared address sv: 16 keys and all
// dh columns per wgmma, one commit group.
template <int N>
__device__ __forceinline__ void issue_pv(float (&acc)[N],
                                         const uint32_t (&hi)[8][4],
                                         const uint32_t (&lo)[8][4],
                                         uint32_t sv) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint64_t db = smem_desc(sv + j * 2048, kKVBox);
    wgmma_pv(acc, hi[j], db);
    wgmma_pv(acc, lo[j], db);
  }
  wgmma_commit();
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// s (64 × 128 f32) = Q·Kᵀ for the Q panels at sq and the K panels at sk,
// 16 columns of dh per wgmma (within a 64-column panel the descriptor
// advances 32 bytes: the swizzle is on address bits); one commit group.
template <int DH>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t sq,
                                         uint32_t sk) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    const uint64_t da = smem_desc(sq + (kk / 4) * kQBox + off, 16);
    const uint64_t db = smem_desc(sk + (kk / 4) * kKVBox + off, 16);
    if (kk == 0)
      wgmma_qk_first(s, da, db);
    else
      wgmma_qk(s, da, db);
  }
  wgmma_commit();
}

// The online softmax of one tile of unscaled scores s on wgmma's
// accumulator fragment: a thread holds rows row0 (registers with i/2
// even) and row0 + 8 (i/2 odd), columns key0 + 8·(i/4) + col + i%2, and
// the 4 lanes of a row reduce with shfl_xor 1, 2.  Masks s (-1e30), turns
// it into p = 2^(s·c − m′·c), updates m (unscaled) and l, and returns
// each row's correction 2^((m − m′)·c) for the accumulator.  Maxima and
// sums go through 4 partials a row to keep dependency chains short.
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             int key0, int row0, int col,
                                             int S, int causal, bool edge,
                                             float c) {
  if (edge) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int key = key0 + (i / 4) * 8 + col + (i % 2);
      const int row = row0 + ((i / 2) % 2) * 8;
      if ((causal && key > row) || key >= S) s[i] = kNegInf;
    }
  }
  float part[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u) part[r][u] = m[r];
#pragma unroll
  for (int i = 0; i < 64; ++i)
    part[(i / 2) % 2][(i / 4) % 4] =
        fmaxf(part[(i / 2) % 2][(i / 4) % 4], s[i]);
  float mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = fmaxf(fmaxf(part[r][0], part[r][1]),
                     fmaxf(part[r][2], part[r][3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    corr[r] = exp2_approx((m[r] - mx) * c);
    m[r] = mx;
    mc[r] = mx * c;
#pragma unroll
    for (int u = 0; u < 4; ++u) part[r][u] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = exp2_approx(fmaf(s[i], c, -mc[(i / 2) % 2]));
    part[(i / 2) % 2][(i / 4) % 4] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = (part[r][0] + part[r][1]) + (part[r][2] + part[r][3]);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l[r] = l[r] * corr[r] + sum;
  }
}

// p = hi + lo in bf16.  Register pair (8j + 2u, 8j + 2u + 1) of s is
// register u of the A fragment of keys 16j .. 16j + 15.
__device__ __forceinline__ void split_p(const float (&s)[64],
                                        uint32_t (&hi)[8][4],
                                        uint32_t (&lo)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float x0 = s[8 * j + 2 * u], x1 = s[8 * j + 2 * u + 1];
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(h2);
      hi[j][u] = bf16x2_bits(h2);
      lo[j][u] = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
    }
}

template <int DH>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const __grid_constant__ CUtensorMap to, float* __restrict__ lse,
             int S, int G, float scale, int causal) {
  using L = TcSmem<DH>;
  constexpr int P = L::kPanels;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023) & ~1023u;
  const uint32_t q_full = base + L::bar;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcBQ;  // longest first
  const int active = min(kConsumers, (S - q0) / kTcRows);
  const int last_row = q0 + active * kTcRows - 1;
  const int n_kv = causal ? last_row / kTcBKV + 1
                          : (S + kTcBKV - 1) / kTcBKV;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 128 * active);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x != kConsumers * 128) return;
    mbar_expect_tx(q_full, active * P * kQBox);
    for (int c = 0; c < active; ++c)
      for (int h = 0; h < P; ++h)
        tma_load(base + L::q + (c * P + h) * kQBox, &tq, q_full, h * kPanel,
                 q0 + c * kTcRows, bh);
    const int bkv = bh / G;
    int stage = 0;
    uint32_t phase = 0;
    for (int kj = 0; kj < n_kv; ++kj) {
      mbar_wait(empty0 + 8 * stage, phase ^ 1);
      const uint32_t full = full0 + 8 * stage;
      mbar_expect_tx(full, 2 * P * kKVBox);
      for (int h = 0; h < P; ++h) {
        const uint32_t off = (stage * P + h) * kKVBox;
        tma_load(base + L::k + off, &tk, full, h * kPanel, kj * kTcBKV, bkv);
        tma_load(base + L::v + off, &tv, full, h * kPanel, kj * kTcBKV, bkv);
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {
    // consumer warpgroup wg: query rows q0 + 64·wg .. + 63.  Tile kj's
    // Q·Kᵀ and tile kj − 1's P·V are issued together, and the softmax of
    // tile kj runs while P·V does.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    if (wg >= active) return;
    const int t = threadIdx.x % 128, lane = t % 32;
    const int first = q0 + wg * kTcRows;
    const int lrow = (t / 32) * 16 + lane / 4;  // and lrow + 8, of 64
    const int row0 = first + lrow;
    const int col = (lane % 4) * 2;   // + 8·(i / 4) + (i % 2) in a tile
    const uint32_t sq = base + L::q + wg * P * kQBox;
    const float c = scale * 1.4426950408889634f;  // p = 2^(s·c − m·c)

    float acc[DH / 2];   // columns 8·(i / 4) + col + (i % 2)
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
    float s[64];
    uint32_t hi[8][4], lo[8][4];   // p of the previous tile, in two halves
    auto edge = [&](int kj) {      // a tile with masked entries
      return (causal && kj * kTcBKV + kTcBKV - 1 > first) ||
             kj * kTcBKV + kTcBKV > S;
    };

    mbar_wait(q_full, 0);
    mbar_wait(full0, 0);
    wgmma_fence();
    issue_qk<DH>(s, sq, base + L::k);
    wgmma_wait<0>();
    pin(s);
    softmax_tile(s, m, l, corr, 0, row0, col, S, causal, edge(0), c);
    split_p(s, hi, lo);   // acc is 0: no correction
    int prev = 0, stage = 1;   // kStages > 1
    uint32_t phase = 0;
    for (int kj = 1; kj < n_kv; ++kj) {
      mbar_wait(full0 + 8 * stage, phase);
      pin(acc);
      pin(hi);
      pin(lo);
      wgmma_fence();
      issue_qk<DH>(s, sq, base + L::k + stage * P * kKVBox);
      issue_pv(acc, hi, lo, base + L::v + prev * P * kKVBox);
      wgmma_wait<1>();   // s is in; the previous tile's P·V runs on
      pin(s);
      softmax_tile(s, m, l, corr, kj * kTcBKV, row0, col, S, causal, edge(kj),
                   c);
      wgmma_wait<0>();   // the previous tile's P·V is in
      pin(acc);
      pin(hi);
      pin(lo);
      mbar_arrive(empty0 + 8 * prev);
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) acc[i] *= corr[(i / 2) % 2];
      split_p(s, hi, lo);
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    pin(acc);
    pin(hi);
    pin(lo);
    wgmma_fence();
    issue_pv(acc, hi, lo, base + L::v + prev * P * kKVBox);
    wgmma_wait<0>();
    pin(acc);
    pin(hi);
    pin(lo);

    // o = acc · (1 / l) in bf16, staged in this warpgroup's Q panels (no
    // longer read) in the 128-byte swizzle TMA reads, then stored by TMA
    const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
#pragma unroll
    for (int i = 0; i < DH / 2; i += 2) {
      const int row = lrow + 8 * ((i / 2) % 2);
      const int cc = (i / 4) * 8 + col;
      const uint32_t at = sq + (cc / kPanel) * kQBox + row * 128 +
                          ((((cc % kPanel) / 8) ^ (row % 8)) * 16) +
                          (cc % 8) * 2;
      const float r = inv[(i / 2) % 2];
      asm volatile("st.shared.b32 [%0], %1;" ::"r"(at),
                   "r"(bf16x2_bits(__floats2bfloat162_rn(acc[i] * r,
                                                         acc[i + 1] * r)))
                   : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    if (t == 0) {
      for (int h = 0; h < P; ++h)
        tma_store(&to, sq + h * kQBox, h * kPanel, first, bh);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
    if (lane % 4 == 0) {
      const size_t at = (size_t)bh * S + row0;
      lse[at] = m[0] * scale + logf(fmaxf(l[0], 1e-30f));
      lse[at + 8] = m[1] * scale + logf(fmaxf(l[1], 1e-30f));
    }
    if (t == 0)   // shared memory must outlive the store's reads
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
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

template <int DH>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* lse, int BH, int BHkv, int S, int G, float scale,
              int causal, cudaStream_t stream) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  CUtensorMap tq, tk, tv, to;
  int err = encode(fn, &tq, q, BH, S, DH, kTcRows);
  if (!err) err = encode(fn, &tk, k, BHkv, S, DH, kTcBKV);
  if (!err) err = encode(fn, &tv, v, BHkv, S, DH, kTcBKV);
  if (!err) err = encode(fn, &to, o, BH, S, DH, kTcRows);
  if (err) return err;
  static unsigned done = 0;
  auto kern = flash_fwd_tc<DH>;
  const size_t smem = TcSmem<DH>::bytes;
  err = opt_in(kern, smem, &done);
  if (err) return err;
  const dim3 grid(BH, (S + kTcBQ - 1) / kTcBQ);
  kern<<<grid, kTcThreads, smem, stream>>>(
      tq, tk, tv, to, lse, S, G, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// S must be a multiple of this (both kernels' query and key tiles).
int flash_attn_tile() { return kBQ > kBKV ? kBQ : kBKV; }

// Dynamic shared memory one CTA needs at head dimension dh (bytes), the
// larger of the two kernels'.
size_t flash_attn_smem_bytes(int dh) {
  const size_t f32 = smem_floats(dh) * sizeof(float);
  const size_t tc = dh == 64    ? TcSmem<64>::bytes
                    : dh == 128 ? TcSmem<128>::bytes
                                : 0;
  return f32 > tc ? f32 : tc;
}

// Shared memory a CTA may opt in to on `device` (bytes), or -1.
int flash_attn_max_smem(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

const char* flash_attn_error_string(int err) {
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

// o (BH, S, dh) and lse (BH, S) of q (BH, S, dh), k and v (BHkv, S, dh);
// bf16 != 0 for bfloat16 q, k, v and o (tensor cores), else float32.
int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                   float* lse, int BH, int BHkv, int S, int dh, int bf16,
                   int causal, float scale, void* stream) {
  if (BHkv <= 0 || BH % BHkv != 0 || S % kBQ != 0 || S % kBKV != 0)
    return (int)cudaErrorInvalidValue;
  const int G = BH / BHkv;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dh == 64)
    return bf16 ? launch_tc<64>(q, k, v, o, lse, BH, BHkv, S, G, scale,
                                causal, st)
                : launch_f32<64>(q, k, v, o, lse, BH, S, G, scale, causal,
                                 st);
  if (dh == 128)
    return bf16 ? launch_tc<128>(q, k, v, o, lse, BH, BHkv, S, G, scale,
                                 causal, st)
                : launch_f32<128>(q, k, v, o, lse, BH, S, G, scale, causal,
                                  st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

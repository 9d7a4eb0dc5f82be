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
// f32 design (flash_fwd_f32): the CUDA cores, register-blocked.  f32 has
// no tensor-core path here: TF32 would round q, k and v to 10 mantissa
// bits, and no kernel of the port uses it.  At smollm-135m's training
// shape (B=8, S=1024, H=9, Hkv=3, dh=64, causal) the function's 9.67 GFLOP
// take 0.144 ms at the f32 peak (67 TFLOP/s), its ~57 MB 0.017 ms at
// 3.35 TB/s: it is bound by the FMA rate, and so is the kernel.
// - A CTA of 256 threads owns 128 query rows of one head.  A thread holds
//   8 rows × 8 keys of the scores at dh = 64 (128-key KV tiles) or 8 × 4
//   at dh = 128 (64-key tiles: a 128-key K ring would not fit), and 8 rows
//   × dh/16 columns of o (csrc/flash_f32.cuh: the layout, the products,
//   their shared-memory wavefronts, 8 to 12.8 FFMAs each).
// - Q, times scale·log2 e, is loaded once, transposed.  K comes through a
//   2-stage cp.async ring (tile j + 1 in flight while j is computed); V,
//   one tile, is copied while its tile's scores and softmax are computed
//   and waited for before P·V.  Two barriers a KV tile: the ring's, and
//   P's and V's.  Shared memory 204,800 B at dh = 64 and 196,608 B at
//   dh = 128, one CTA (8 warps) a SM.
// - The online softmax runs in registers, in base 2 (p = 2^(s − m), s and
//   m in units of log2 e): the 16 threads of a row side are a half warp
//   and reduce the row's max and sum with shfl_xor; m, l and the
//   correction never leave registers.  P is written once to shared memory
//   (transposed) and read once by P·V.
// - A query tail past S (S a multiple of 64, not of 128) is zero in Q and
//   never stored; keys past S are zero-filled by the copy and masked to
//   -1e30 like keys past the diagonal.  Causal CTAs stop at the diagonal;
//   blockIdx.y runs the query tiles from the last (longest) to the first
//   and blockIdx.x the heads, so every head's longest tile is in the first
//   wave.  At the training shape: 72 heads × 8 query tiles = 576 CTAs,
//   4.4 waves over 132 SMs.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <stdio.h>

#include "flash_f32.cuh"
#include "hopper_tc.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;   // a 16 × 16 grid of 8-row patches
constexpr int kBQ = 128;        // query rows per CTA

// Keys per KV tile: 128 at dh = 64 (a patch of 8 rows × 8 keys a
// thread), 64 at dh = 128 (8 × 4: a 128-key K ring would not fit).
__host__ __device__ constexpr int kv_tile(int dh) {
  return dh == 64 ? 128 : 64;
}

// Dynamic shared memory of one CTA, in floats: Q transposed (dh × 128),
// the K ring (2 tiles), the V tile and P transposed (a tile's keys × 128
// rows), rows padded at dh = 64 (csrc/flash_f32.cuh).
constexpr size_t smem_floats(int dh) {
  return (size_t)dh * kBQ + 3 * (size_t)kv_tile(dh) * row_floats(dh, dh) +
         (size_t)kv_tile(dh) * row_floats(kBQ, dh);
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int S, int G, float scale,
              int causal) {
  constexpr int NC = DH / 16;   // output columns a thread
  constexpr int BKV = kv_tile(DH), NB = BKV / 16;
  constexpr int TILE = BKV * row_floats(DH, DH);  // a K or V tile
  extern __shared__ __align__(16) float smem[];
  float* sQt = smem;                    // DH × kBQ
  float* sK = sQt + DH * kBQ;           // 2 tiles of BKV × DH
  float* sV = sK + 2 * TILE;            // BKV × DH
  float* sPt = sV + TILE;               // BKV × kBQ

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest first
  const int rows = min(kBQ, S - q0);
  const size_t kv_base = (size_t)(bh / G) * S * DH;
  const float* gk = k + kv_base;
  const float* gv = v + kv_base;
  const int n_kv = (S + BKV - 1) / BKV;
  const int kv_end = causal ? min(n_kv, (q0 + rows - 1) / BKV + 1) : n_kv;

  // the first K tile is in flight while Q is staged
  stage_rows_upto<DH, kThreads, BKV>(sK, gk, S);
  cp_async_commit();
  // q · scale · log2 e: the softmax runs in base 2 (m in units of log2 e)
  stage_t<kBQ, DH, kThreads>(sQt, q + ((size_t)bh * S + q0) * DH, rows,
                             scale * kLog2e);

  float acc[8][NC], m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int kj = 0; kj < kv_end; ++kj) {
    const int st = kj & 1, key0 = kj * BKV;
    cp_async_wait_all();
    __syncthreads();  // K tile kj is in; tile kj − 1's V, P, K stage free
    // V of this tile (waited for before P·V), then the next K tile
    stage_rows_upto<DH, kThreads, BKV>(sV, gv + (size_t)key0 * DH,
                                       S - key0);
    cp_async_commit();
    if (kj + 1 < kv_end)
      stage_rows_upto<DH, kThreads, BKV>(sK + (st ^ 1) * TILE,
                                         gk + (size_t)(key0 + BKV) * DH,
                                         S - key0 - BKV);
    cp_async_commit();
    const float* cK = sK + st * TILE;

    float s[8][NB];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int n = 0; n < NB; ++n) s[i][n] = 0.f;
    mma_tb<kBQ, DH, NB>(s, sQt, cK, ty, tx);

    // online softmax over the row side, in registers; keys past the
    // diagonal or past S are masked
    const bool edge = (causal && key0 + BKV - 1 > q0) || key0 + BKV > S;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = q0 + row_of<kBQ>(i, ty);
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const int key = key0 + tx + 16 * n;
        if (edge && ((causal && key > row) || key >= S)) s[i][n] = kNegInf;
        mx = fmaxf(mx, s[i][n]);
      }
      const float m_new = fmaxf(m[i], half_max(mx));
      const float c = exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        s[i][n] = exp2f(s[i][n] - m_new);
        sum += s[i][n];
      }
      l[i] = l[i] * c + half_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) acc[i][cc] *= c;
    }
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const float p[8] = {s[0][n], s[1][n], s[2][n], s[3][n],
                          s[4][n], s[5][n], s[6][n], s[7][n]};
      put_col<kBQ, DH>(sPt, tx + 16 * n, ty, p);
    }
    cp_async_wait<1>();  // this tile's V (the next K may still be coming)
    __syncthreads();     // P is whole, V is in
    mma_tn<kBQ, DH, BKV>(acc, sPt, sV, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row_of<kBQ>(i, ty);
    if (r >= rows) continue;
    const float lm = fmaxf(l[i], 1e-30f);
    float* go = o + ((size_t)bh * S + q0 + r) * DH;
#pragma unroll
    for (int h = 0; h < NC / 4; ++h)
      st4(go + 64 * h + 4 * tx,
          make_float4(acc[i][4 * h] / lm, acc[i][4 * h + 1] / lm,
                      acc[i][4 * h + 2] / lm, acc[i][4 * h + 3] / lm));
    if (tx == 0) lse[(size_t)bh * S + q0 + r] = m[i] / kLog2e + logf(lm);
  }
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
  const dim3 grid(BH, (S + kBQ - 1) / kBQ);
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

// S must be a multiple of this (both kernels' granularity; a query or key
// tile past S is masked).
int flash_attn_tile() { return kStream; }

// The f32 kernel's launch plan at (dh, S, BH): out[0..5] = threads, query
// rows a CTA, dynamic shared memory (bytes), grid.x (heads), grid.y
// (query tiles) and resident CTAs a SM on the current card.  Returns a
// CUDA error code (0 on success).
int flash_attn_f32_plan(int dh, int S, int BH, int* out) {
  if ((dh != 64 && dh != 128) || S <= 0 || S % kStream || BH <= 0)
    return (int)cudaErrorInvalidValue;
  out[0] = kThreads;
  out[1] = kBQ;
  out[2] = (int)(smem_floats(dh) * sizeof(float));
  out[3] = BH;
  out[4] = (S + kBQ - 1) / kBQ;
  static unsigned d64 = 0, d128 = 0;
  out[5] = dh == 64 ? occupancy(flash_fwd_f32<64>, kThreads, out[2], &d64)
                    : occupancy(flash_fwd_f32<128>, kThreads, out[2], &d128);
  return out[5] < 0 ? (int)cudaErrorInvalidValue : 0;
}

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

const char* flash_attn_error_string(int err) { return tc_error_string(err); }

// o (BH, S, dh) and lse (BH, S) of q (BH, S, dh), k and v (BHkv, S, dh);
// bf16 != 0 for bfloat16 q, k, v and o (tensor cores), else float32.
int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                   float* lse, int BH, int BHkv, int S, int dh, int bf16,
                   int causal, float scale, void* stream) {
  if (BHkv <= 0 || BH % BHkv != 0 || S % kStream != 0)
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

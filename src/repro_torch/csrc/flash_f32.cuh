// The f32 flash-attention kernels' shared machinery (csrc/flash_attn.cu's
// flash_fwd_f32, csrc/flash_attn_bwd.cu's flash_bwd_f32 in both its
// roles): staging into shared memory and the two register-blocked tile
// products every product of both files is written in.
//
// Thread layout.  A CTA of NT threads (256, or 128 where a tile at
// dh = 128 would not fit) is a (NT / 16) × 16 grid: ty = tid / 16 picks a
// "row side" of 8 values, tx = tid % 16 a "column side".  Lanes 0-15 and
// 16-31 of a warp are one ty each, so the 16 threads that share a row side
// are half a warp and reduce over it with shfl_xor 1, 2, 4, 8.
// - Row side of a tile of R rows: rows (i / 4)·R/2 + 4·ty + i % 4, i < 8:
//   two runs of 4, each one 16-byte shared load.
// - Column side against a streamed tile: rows tx + 16·n, n < 4 (64 rows)
//   or n < 8 (128 rows).
// - Output columns of dh: (c / 4)·64 + 4·tx + c % 4, c < dh / 16: one
//   16-byte load or store a run of 4.
//
// Layouts.  A tile the CTA keeps for its whole life (q and dO in the dQ
// role and the forward, k and v in the dK/dV role) is stored transposed,
// dh × R, so its row side is read along rows.  A streamed tile is stored
// as it lies in device memory, row-major, padded by 16 bytes a row at
// dh = 64 or with 16-byte chunk c of row r at chunk c ^ (r % 8) at
// dh = 128 (sw): either puts 8 consecutive rows' copies of a chunk in 8
// different bank groups, so the 16 rows of a column side, or a row's 16
// chunks of output columns, load in 2 wavefronts (256 bytes, the least).
// The P and dS tiles that pass between threads are laid out the same way.
//
// The products (all f32 FMA, no tensor-core instruction):
// - mma_tb: C[8][NB] += Σ_d At[d][row side] · B[column side][d], At a
//   kept tile (transposed), B a streamed one (NB = 4: the backward; 8:
//   the forward at dh = 64).  Per 4 steps of d a thread loads NB 16-byte
//   chunks of B and 8 of At for 32·NB FMAs: per warp 2·NB + 8 wavefronts
//   (B 2 each, At 1 each, the warp's two ty broadcast) for 32·NB FFMA
//   instructions, 8 a wavefront at NB = 4, 10.7 at NB = 8.
// - mma_tn: C[8][dh/16] += Σ_k A[k][row side] · B[k][output columns],
//   A a row-major tile of P or dS (R wide), B a streamed one.  Per k: 2
//   chunks of A (1 wavefront) and dh/64 of B (2 wavefronts each) for
//   8·dh/16 FMAs: 10.7 FFMAs a wavefront at dh = 64, 12.8 at dh = 128.
// An SM issues 4 warp FFMAs and serves 1 shared-memory wavefront a clock,
// so at 8 or more a wavefront the products are bound by the FMA rate.
//
// Staging.  Streamed f32 tiles go through a 2-stage ring filled by 16-byte
// cp.async.cg (one commit group a tile; the forward's V has one stage,
// copied while its tile's scores are computed): tile j + 1 is copied while
// tile j is computed, and a tile costs one barrier.  Kept tiles are loaded
// once, through registers, transposed, scaled and zero past the last valid
// row.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;   // exp(x) = 2^(x · log2 e)
// Rows of the backward's streamed tiles, and the granularity of S: every
// S that is a multiple of it is taken, a larger tile masking its tail.
constexpr int kStream = 64;

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

// Resident CTAs a SM of `kern` at `threads` threads and `smem` bytes of
// dynamic shared memory on the current card, or -1.
template <typename Kernel>
int occupancy(Kernel kern, int threads, size_t smem, unsigned* done) {
  int n = -1;
  if (opt_in(kern, smem, done)) return -1;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, threads,
                                                       smem) == cudaSuccess
             ? n
             : -1;
}

// A value of either input type as f32 (the backward's D pass).
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Reduce over the 16 lanes of a half warp (the threads of one row side).
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Row-major tiles at dh = 64 are padded to W + 4 floats a row; at
// dh = 128 a pad would not fit the backward's shared memory (the dK/dV
// role's 230,400 B), so tiles are XOR-swizzled instead.  Both put 8
// consecutive rows' copies of a chunk in 8 different bank groups; the pad
// also keeps every address of an unrolled loop a constant offset from one
// register.
__host__ __device__ constexpr bool padded(int dh) { return dh == 64; }

// Floats a row of a row-major tile w wide takes at head dimension dh.
__host__ __device__ constexpr int row_floats(int w, int dh) {
  return padded(dh) ? w + 4 : w;
}

// Float index of element (r, c), c a multiple of 4, of a row-major tile W
// floats wide (W / 4 >= 8 chunks) at head dimension DH.
template <int W, int DH>
__device__ __forceinline__ int sw(int r, int c) {
  return padded(DH) ? r * (W + 4) + c
                    : r * W + ((((c >> 2) ^ (r & 7))) << 2);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ float comp(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// 4 consecutive values of device memory.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src)
               : "memory");
}
// The same, or 16 zero bytes (nothing read) where `keep` is false.
__device__ __forceinline__ void cp_async16_or_zero(float* dst,
                                                   const void* src,
                                                   bool keep) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(keep ? 16 : 0)
               : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

// A streamed tile: ROWS rows of DH contiguous values at `src` into the
// row-major tile `dst` (sw), by cp.async (the caller commits the group).
// Thread t copies chunk t % (DH / 4) of rows t / (DH / 4) + j·NT / (DH / 4),
// so every address of the unrolled copy is a constant offset from the
// first.
template <int DH, int NT, int ROWS = kStream>
__device__ __forceinline__ void stage_rows(float* dst, const float* src) {
  constexpr int CH = DH / 4, STEP = NT / CH;
  static_assert(NT % CH == 0, "a row's chunks within one pass");
  const int r0 = threadIdx.x / CH, c = (threadIdx.x % CH) * 4;
#pragma unroll
  for (int j = 0; j < ROWS / STEP; ++j) {
    const int r = r0 + j * STEP;
    cp_async16(dst + sw<DH, DH>(r, c), src + r * DH + c);
  }
}
// The same for a tile that may run past the last row: rows at and past
// `valid` are zero and are not read.
template <int DH, int NT, int ROWS>
__device__ __forceinline__ void stage_rows_upto(float* dst, const float* src,
                                                int valid) {
  constexpr int CH = DH / 4, STEP = NT / CH;
  static_assert(NT % CH == 0, "a row's chunks within one pass");
  const int r0 = threadIdx.x / CH, c = (threadIdx.x % CH) * 4;
#pragma unroll
  for (int j = 0; j < ROWS / STEP; ++j) {
    const int r = r0 + j * STEP;
    const bool keep = r < valid;
    cp_async16_or_zero(dst + sw<DH, DH>(r, c), src + (keep ? r * DH + c : 0),
                       keep);
  }
}

// kStream f32 values (a tile's lse or D) by cp.async, threads 16·slot to
// 16·slot + 15.
template <int NT>
__device__ __forceinline__ void stage_vec(float* dst, const float* src,
                                          int slot) {
  const int t = threadIdx.x - 16 * slot;
  if (t >= 0 && t < kStream / 4) cp_async16(dst + 4 * t, src + 4 * t);
}

// A kept tile: R rows of DH values at `src`, times `mul`, into `dst`
// transposed (DH × R); rows at and past `valid` are zero.  Consecutive
// threads take consecutive rows, so the stores are free of bank
// conflicts.
template <int R, int DH, int NT>
__device__ __forceinline__ void stage_t(float* dst, const float* src,
                                        int valid, float mul) {
  for (int i = threadIdx.x; i < R * (DH / 4); i += NT) {
    const int r = i % R, c = (i / R) * 4;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) f = load4(src + (size_t)r * DH + c);
    dst[(c + 0) * R + r] = f.x * mul;
    dst[(c + 1) * R + r] = f.y * mul;
    dst[(c + 2) * R + r] = f.z * mul;
    dst[(c + 3) * R + r] = f.w * mul;
  }
}

// Row side i of a tile of R rows (see the layout note above).
template <int R>
__device__ __forceinline__ int row_of(int i, int ty) {
  return (i >> 2) * (R / 2) + 4 * ty + (i & 3);
}

// acc[i][n] += Σ_d at[d·R + row_of(i)] · b[row tx + 16n][d], n < NB: at
// a kept tile (DH × R), b a streamed tile (16·NB rows × DH, sw).
template <int R, int DH, int NB = 4>
__device__ __forceinline__ void mma_tb(float (&acc)[8][NB], const float* at,
                                       const float* b, int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < DH; d += 4) {
    float4 bv[NB];
#pragma unroll
    for (int n = 0; n < NB; ++n) bv[n] = ld4(b + sw<DH, DH>(tx + 16 * n, d));
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      const float4 a0 = ld4(at + (d + dd) * R + 4 * ty);
      const float4 a1 = ld4(at + (d + dd) * R + R / 2 + 4 * ty);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const float bn = comp(bv[n], dd);
        acc[0][n] = fmaf(a0.x, bn, acc[0][n]);
        acc[1][n] = fmaf(a0.y, bn, acc[1][n]);
        acc[2][n] = fmaf(a0.z, bn, acc[2][n]);
        acc[3][n] = fmaf(a0.w, bn, acc[3][n]);
        acc[4][n] = fmaf(a1.x, bn, acc[4][n]);
        acc[5][n] = fmaf(a1.y, bn, acc[5][n]);
        acc[6][n] = fmaf(a1.z, bn, acc[6][n]);
        acc[7][n] = fmaf(a1.w, bn, acc[7][n]);
      }
    }
  }
}

// acc[i][c] += Σ_k a[k][row_of(i)] · b[k][column c], k < K: a a
// row-major tile R wide (K rows, sw), b a streamed tile (K × DH, sw).
template <int R, int DH, int K = kStream>
__device__ __forceinline__ void mma_tn(float (&acc)[8][DH / 16],
                                       const float* a, const float* b,
                                       int ty, int tx) {
  constexpr int NCH = DH / 64;  // 4-column runs a thread
#pragma unroll 16
  for (int k = 0; k < K; ++k) {
    const float4 a0 = ld4(a + sw<R, DH>(k, 4 * ty));
    const float4 a1 = ld4(a + sw<R, DH>(k, R / 2 + 4 * ty));
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int h = 0; h < NCH; ++h) {
      const float4 bv = ld4(b + sw<DH, DH>(k, 64 * h + 4 * tx));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][4 * h + 0] = fmaf(av[i], bv.x, acc[i][4 * h + 0]);
        acc[i][4 * h + 1] = fmaf(av[i], bv.y, acc[i][4 * h + 1]);
        acc[i][4 * h + 2] = fmaf(av[i], bv.z, acc[i][4 * h + 2]);
        acc[i][4 * h + 3] = fmaf(av[i], bv.w, acc[i][4 * h + 3]);
      }
    }
  }
}

// Store the 8 values v[0..7] of column n of a thread's patch into row j
// = tx + 16n of a row-major tile R wide (sw), at the thread's row side.
template <int R, int DH>
__device__ __forceinline__ void put_col(float* t, int j, int ty,
                                        const float (&v)[8]) {
  st4(t + sw<R, DH>(j, 4 * ty), make_float4(v[0], v[1], v[2], v[3]));
  st4(t + sw<R, DH>(j, R / 2 + 4 * ty), make_float4(v[4], v[5], v[6], v[7]));
}

}  // namespace

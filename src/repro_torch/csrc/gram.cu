// Gram matrix K = X Xᵀ of each stream's sketch buffer, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gram/kernel.py:39
// (gram_pallas, body _gram_kernel): K = X Xᵀ for X (m, d), d streamed in
// 512-column blocks into an f32 accumulator, output in X's dtype.
//
// What it computes, for every stream b of an (S, m, d) slab X in f32 or
// bf16: K_b = X_b X_bᵀ (m, m), accumulated in f32 and written in X's
// dtype (round to nearest even for bf16), as repro/kernels/gram/ref.py.
//
// What bounds it on this card: K is symmetric, so the function needs
// m(m+1)/2 dot products of length d, m(m+1)·d operations, against
// reading X once and writing K once.  At the split dump step's shape
// (m = 256, d = 300, f32) that is 19.7 MFLOP for 0.57 MB a stream,
// ~34 FLOP per byte, above the f32 ridge of 67 TFLOP/s / 3.35 TB/s = 20:
// the f32 FMA rate bounds a fleet launch (no TF32: the caller compares λ̂
// against θ).  A kernel gets near that rate only if shared memory feeds
// the FMAs faster than they retire and the copies hide behind them.
//
// Design.  The Pallas kernel ran its d-blocks in order on one core with K
// resident in VMEM; here one CTA owns one 64×64 tile of K's upper
// triangle (blockIdx.y) of one stream (blockIdx.x) and loops over d
// itself.  It writes its tile and, off the diagonal, the mirror, so K is
// exactly symmetric and the lower triangle costs no operations (a
// diagonal tile computes both of its halves).  Ragged m and d need no
// padding: copies past them read zero and stores past m are skipped.
// - A register-tiled SGEMM inner loop: each thread accumulates an 8×8
//   patch (rows ty + side·j, columns tx + side·c) in f32 FMA.  The two
//   panels are stored row-major with d contiguous (the layout of X, so
//   16-byte copies land as they are), and a 16-byte shared read gives 4
//   steps of d for one row: per 4 steps a thread does 8 reads of its
//   columns and 8 of its rows for 256 FMAs.  Row strides are an odd
//   number of 16-byte units, so the reads of a warp's distinct rows are
//   free of bank conflicts; threads that share rows read them as
//   broadcasts.
// - The d-chunks are double-buffered and copied with cp.async, so the
//   next chunk's copy runs while this chunk's FMAs do: 16-byte copies
//   where every row is 16-byte aligned (f32 with d % 4 == 0, bf16 with
//   d % 8 == 0), 4-byte copies where rows are 4-byte aligned (f32 at any
//   d, bf16 at even d), zero-filled past m and d through cp.async's
//   source size.  bf16 rows at odd d are 2-byte aligned only, which no
//   cp.async takes: they go through plain loads into the same buffers.
// - bf16 stays bf16 in shared memory (a raw copy) and is widened to f32
//   as it is read.
// - Tiles are 64×64 (64 threads, 32 columns of d per chunk).  At m = 256
//   they give 10 CTAs a stream and waste 24 % of their FMAs on diagonal
//   tiles' lower halves; 128-row tiles (3 CTAs a stream, 49 % waste) were
//   slower at (S, m, d) = (256, 256, 300) on the H100 (PERF.md).  The
//   kernel runs at 4 CTAs an SM and may take ~230 registers a thread,
//   which the compiler spends on loading ahead; capped at 168 (6 CTAs an
//   SM) it spilled and ran slower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "tile_copy.cuh"

namespace {

constexpr int kTile = 64;                   // rows and columns of a tile
constexpr int kSide = kTile / 8;            // threads per side
constexpr int kThreads = kSide * kSide;
constexpr int kChunk = 32;                  // columns of d a chunk

// Row stride of a panel in elements: an odd number of 16-byte units.
template <typename T>
constexpr int kLdOf = kChunk + 16 / (int)sizeof(T);

// Rows [r0, r0 + kTile) of X, columns [k0, k0 + kChunk), into the panel s
// (row-major, stride kLdOf<T>).  BYTES = 16 or 4: cp.async of that width;
// BYTES = 0: plain loads and stores.  A thread keeps one column group and
// walks its rows with one pointer.
template <typename T, int BYTES>
__device__ __forceinline__ void load_panel(const T* __restrict__ X, T* s,
                                           int r0, int k0, int m, int d) {
  constexpr int kLd = kLdOf<T>;
  constexpr int E = BYTES ? BYTES / (int)sizeof(T) : 1;  // elements a copy
  constexpr int per_row = kChunk / E;
  constexpr int step = kThreads / per_row;           // rows a pass
  const int e = (threadIdx.x % per_row) * E;
  const int nk = max(0, min(E, d - (k0 + e)));   // valid elements a copy
  int r = threadIdx.x / per_row;
  const T* src = X + (size_t)(r0 + r) * d + k0 + e;
  T* dst = s + r * kLd + e;
  for (; r < kTile; r += step, src += (size_t)step * d, dst += step * kLd) {
    const int n = r0 + r < m ? nk : 0;
    if constexpr (BYTES == 0)
      *dst = n ? *src : from_f32<T>(0.f);
    else
      cp_async<BYTES>((uint32_t)__cvta_generic_to_shared(dst), n ? src : X,
                      n * (int)sizeof(T));
  }
}

template <typename T, int BYTES>
__global__ void __launch_bounds__(kThreads, 4)
gram_kernel(const T* __restrict__ X, T* __restrict__ K, int m, int d,
            int nt) {
  constexpr int kLd = kLdOf<T>;
  // [buffer][panel a, b]
  __shared__ __align__(16) T smem[2][2][kTile * kLd];
  int ti, tj;
  tile_of(blockIdx.y, nt, &ti, &tj);
  const bool diag = ti == tj;
  const int bi = ti * kTile, bj = tj * kTile;
  const size_t b = blockIdx.x;
  const T* Xb = X + b * (size_t)m * d;
  const int ty = threadIdx.x / kSide, tx = threadIdx.x % kSide;
  const int n_chunks = (d + kChunk - 1) / kChunk;

  auto issue = [&](int chunk) {
    T* buf = smem[chunk & 1][0];
    load_panel<T, BYTES>(Xb, buf, bi, chunk * kChunk, m, d);
    if (!diag)
      load_panel<T, BYTES>(Xb, smem[chunk & 1][1], bj, chunk * kChunk, m, d);
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  float acc[8][8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[j][c] = 0.f;

  issue(0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks)
      issue(ch + 1);  // into the buffer chunk ch − 1 was read from
    else
      asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 1;" ::: "memory");  // chunk ch landed
    __syncthreads();
    const T* pa = smem[ch & 1][0];
    const T* pb = diag ? pa : smem[ch & 1][1];
#pragma unroll 1
    for (int k = 0; k < kChunk; k += 4) {
      float y[8][4];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        load4(pb + (tx + kSide * c) * kLd + k, y[c]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float x[4];
        load4(pa + (ty + kSide * j) * kLd + k, x);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            acc[j][c] = fmaf(x[kk], y[c][kk], acc[j][c]);
      }
    }
    __syncthreads();  // this buffer is free for chunk ch + 2
  }

  T* Kb = K + b * (size_t)m * m;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int i = bi + ty + kSide * j, jj = bj + tx + kSide * c;
      if (i < m && jj < m) {
        const T v = from_f32<T>(acc[j][c]);
        Kb[(size_t)i * m + jj] = v;
        if (!diag) Kb[(size_t)jj * m + i] = v;
      }
    }
  }
}

int tiles(int m) {
  const int nt = (m + kTile - 1) / kTile;
  return nt * (nt + 1) / 2;
}

template <typename T>
int launch(const void* X, void* K, int S, int m, int d, cudaStream_t stream) {
  const int nt = (m + kTile - 1) / kTile;
  const dim3 grid(S, tiles(m));
  const T* x = static_cast<const T*>(X);
  T* k = static_cast<T*>(K);
  switch (copy_bytes(X, (size_t)d * sizeof(T), 16 | 4)) {
    case 16:
      gram_kernel<T, 16><<<grid, kThreads, 0, stream>>>(x, k, m, d, nt);
      break;
    case 4:
      gram_kernel<T, 4><<<grid, kThreads, 0, stream>>>(x, k, m, d, nt);
      break;
    default:
      gram_kernel<T, 0><<<grid, kThreads, 0, stream>>>(x, k, m, d, nt);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Upper-triangle tiles of K one stream needs (gram_xxt's grid y extent).
int gram_tiles(int m) { return tiles(m); }

const char* gram_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K (S, m, m) = X Xᵀ per stream; bf16 != 0 for bf16 X and K, else f32.
int gram_xxt(const void* X, void* K, int S, int m, int d, int bf16,
             void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(X, K, S, m, d, st)
              : launch<float>(X, K, S, m, d, st);
}

}  // extern "C"

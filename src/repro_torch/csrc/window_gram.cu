// Exact window covariance G = AᵀA of each stream's window, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/window_gram/kernel.py:34
// (window_gram_pallas, body _wgram_kernel): G = AᵀA for A (n, d) with n
// streamed in 256-row blocks into a (d, d) f32 accumulator in VMEM.
//
// What it computes, for every stream b of an (S, n, d) slab A in f32 or
// bf16: G_b = A_bᵀ A_b (d, d), accumulated and written in f32, as
// repro/kernels/window_gram/ref.py.  It is the ground truth of the
// paper's covariance error ‖A_WᵀA_W − BᵀB‖₂ (Problem 1, Theorem 3.1).
//
// What bounds it on this card: G is symmetric, so the function needs
// d(d+1)/2 dot products of length n, d(d+1)·n operations, against
// reading A once and writing G once.  At the exact-window check's shape
// (n = N = 1024, d = 300, f32) that is 92 MFLOP for 1.6 MB a stream,
// ~58 FLOP per byte, above the f32 ridge of 20: the f32 FMA rate bounds
// it (no TF32: the error it feeds is held to a bound of 4εN).  A kernel
// gets near that rate only if shared memory feeds the FMAs faster than
// they retire and the copies hide behind them.
//
// Design.  The Pallas kernel ran its n-blocks in order on one core with
// G resident in VMEM; here one CTA owns one 64×64 tile of G's upper
// triangle of one stream and loops over n itself.  It is csrc/gram.cu's
// register-tiled SGEMM with the reduction on A's row axis instead of its
// contiguous axis, which suits the outer product better:
// - A chunk of 16 rows × a 64-column panel lies in shared memory as it
//   lies in A (row-major, 64 columns a row), so a 16-byte read gives 4
//   consecutive columns of one row k.  Each thread accumulates an 8×8
//   patch in f32 FMA, rows ty·4 + {0..3} and 32 + ty·4 + {0..3} of the
//   tile, columns tx·4 + {0..3} and 32 + tx·4 + {0..3}: per k two 16-byte
//   reads a side, 4 reads for 64 FMAs.  A quarter warp reads 8
//   consecutive 16-byte units of one row (no bank conflict), and the
//   threads that share rows read them as a broadcast.
// - The n-chunks are double-buffered and copied with cp.async, so the
//   next chunk's copy runs while this chunk's FMAs do: 16-byte copies
//   where every row is 16-byte aligned (f32 with d % 4 == 0, bf16 with
//   d % 8 == 0), 8-byte where rows are 8-byte aligned (bf16 with
//   d % 4 == 0, as at d = 300), 4-byte where they are 4-byte aligned (f32
//   at any d, bf16 at even d), zero-filled past n and d through
//   cp.async's source size.  bf16 rows at odd d are 2-byte aligned only,
//   which no cp.async takes: they go through plain loads into the same
//   buffers.  bf16 stays bf16 in shared memory (a raw copy) and is
//   widened to f32 as it is read.
// - The grid's x axis walks the tiles of one stream (y walks the
//   streams), so the CTAs that run together share their streams' rows in
//   L2 and A leaves device memory about once.
// - The finished tile goes through shared memory (reusing the panels) and
//   leaves in coalesced rows twice: as it is and, off the diagonal, as
//   its mirror, so G is exactly symmetric and the lower triangle costs no
//   operations (a diagonal tile computes both of its halves, whose FMAs
//   run in the same order).  Ragged n and d need no padding: copies past
//   them read zero and stores past d are skipped.
// - 64 threads a CTA and 8 CTAs an SM (≤ 128 registers a thread, 16.6 KB
//   of shared memory a CTA).  At d = 300 a stream has 15 tiles, which
//   run 61,440 FMAs a row of A against the 45,150 the symmetric result
//   needs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "tile_copy.cuh"

namespace {

constexpr int kTile = 64;                   // rows and columns of a tile
constexpr int kSide = kTile / 8;            // threads per side
constexpr int kThreads = kSide * kSide;
constexpr int kChunk = 16;                  // rows of A a chunk
constexpr int kMinBlocks = 8;               // CTAs an SM
constexpr int kLdG = kTile + 1;             // stride of the staged tile

// Rows [r0, r0 + kChunk) of A, columns [c0, c0 + kTile), into the panel s
// (row-major, stride kTile).  BYTES = 16, 8 or 4: cp.async of that width;
// BYTES = 0: plain loads and stores.  A thread keeps one column group and
// walks its rows with one pointer.
template <typename T, int BYTES>
__device__ __forceinline__ void load_panel(const T* __restrict__ A, T* s,
                                           int r0, int c0, int n, int d) {
  constexpr int E = BYTES ? BYTES / (int)sizeof(T) : 1;  // elements a copy
  constexpr int per_row = kTile / E;
  constexpr int step = kThreads / per_row;               // rows a pass
  static_assert(kThreads % per_row == 0 && kChunk % step == 0, "copies");
  const int e = threadIdx.x % per_row * E;
  const int nk = max(0, min(E, d - (c0 + e)));           // valid elements
  int r = threadIdx.x / per_row;
  const T* src = A + (size_t)(r0 + r) * d + c0 + e;
  T* dst = s + r * kTile + e;
#pragma unroll
  for (int p = 0; p < kChunk / step; ++p) {
    const int nv = r0 + r < n ? nk : 0;
    if constexpr (BYTES == 0)
      *dst = nv ? *src : from_f32<T>(0.f);
    else
      cp_async<BYTES>((uint32_t)__cvta_generic_to_shared(dst), nv ? src : A,
                      nv * (int)sizeof(T));
    r += step;
    src += (size_t)step * d;
    dst += step * kTile;
  }
}

template <typename T, int BYTES>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
window_gram_kernel(const T* __restrict__ A, float* __restrict__ G, int n,
                   int d, int nt) {
  constexpr int kPanel = kChunk * kTile;                 // elements
  constexpr int kPanels = 4 * kPanel * (int)sizeof(T);   // [buffer][a, b]
  constexpr int kStaged = kTile * kLdG * (int)sizeof(float);
  __shared__ __align__(16) unsigned char raw[kPanels > kStaged ? kPanels
                                                               : kStaged];
  T* panels = reinterpret_cast<T*>(raw);
  int ti, tj;
  tile_of(blockIdx.x, nt, &ti, &tj);
  const bool diag = ti == tj;
  const int bi = ti * kTile, bj = tj * kTile;
  const size_t b = blockIdx.y;
  const T* Ab = A + b * (size_t)n * d;
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const int n_chunks = (n + kChunk - 1) / kChunk;

  auto issue = [&](int ch) {
    T* buf = panels + (ch & 1) * 2 * kPanel;
    load_panel<T, BYTES>(Ab, buf, ch * kChunk, bi, n, d);
    if (!diag) load_panel<T, BYTES>(Ab, buf + kPanel, ch * kChunk, bj, n, d);
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (n_chunks) issue(0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks)
      issue(ch + 1);  // into the buffer chunk ch − 1 was read from
    else
      asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 1;" ::: "memory");  // chunk ch landed
    __syncthreads();
    const T* pa = panels + (ch & 1) * 2 * kPanel;
    const T* pb = diag ? pa : pa + kPanel;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      float x[8], y[8];
      load4(pa + k * kTile + ty * 4, x);
      load4(pa + k * kTile + 32 + ty * 4, x + 4);
      load4(pb + k * kTile + tx * 4, y);
      load4(pb + k * kTile + 32 + tx * 4, y + 4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
    __syncthreads();  // this buffer is free for chunk ch + 2
  }

  // the tile through shared memory, then out in coalesced rows
  float* st = reinterpret_cast<float*>(raw);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      st[(ty * 4 + i % 4 + i / 4 * 32) * kLdG + tx * 4 + j % 4 + j / 4 * 32] =
          acc[i][j];
  __syncthreads();
  float* Gb = G + b * (size_t)d * d;
  const int hi = min(kTile, d - bi), wj = min(kTile, d - bj);
  for (int idx = threadIdx.x; idx < kTile * kTile; idx += kThreads) {
    const int i = idx / kTile, j = idx % kTile;
    if (i < hi && j < wj) Gb[(size_t)(bi + i) * d + bj + j] = st[i * kLdG + j];
  }
  if (!diag)
    for (int idx = threadIdx.x; idx < kTile * kTile; idx += kThreads) {
      const int j = idx / kTile, i = idx % kTile;
      if (i < hi && j < wj)
        Gb[(size_t)(bj + j) * d + bi + i] = st[i * kLdG + j];
    }
}

template <typename T>
int launch(const void* A, float* G, int S, int n, int d,
           cudaStream_t stream) {
  const int nt = (d + kTile - 1) / kTile;
  const dim3 grid(nt * (nt + 1) / 2, S);  // upper-triangle tiles, streams
  const T* a = static_cast<const T*>(A);
  switch (copy_bytes(A, (size_t)d * sizeof(T), 16 | 8 | 4)) {
    case 16:
      window_gram_kernel<T, 16><<<grid, kThreads, 0, stream>>>(a, G, n, d, nt);
      break;
    case 8:
      window_gram_kernel<T, 8><<<grid, kThreads, 0, stream>>>(a, G, n, d, nt);
      break;
    case 4:
      window_gram_kernel<T, 4><<<grid, kThreads, 0, stream>>>(a, G, n, d, nt);
      break;
    default:
      window_gram_kernel<T, 0><<<grid, kThreads, 0, stream>>>(a, G, n, d, nt);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* window_gram_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// G (S, d, d) f32 = AᵀA per stream; bf16 != 0 for bf16 A, else f32.
int window_gram_ata(const void* A, float* G, int S, int n, int d, int bf16,
                    void* stream) {
  return bf16 ? launch<__nv_bfloat16>(A, G, S, n, d, (cudaStream_t)stream)
              : launch<float>(A, G, S, n, d, (cudaStream_t)stream);
}

}  // extern "C"

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
// ~58 FLOP per byte, above the f32 ridge of 20: the f32 rate bounds it
// (no TF32: the error it feeds is held to a bound of 4εN).
//
// Design.  The Pallas kernel ran its n-blocks in order on one core with
// G resident in VMEM; here one CTA owns one 64×64 tile of G's upper
// triangle (blockIdx.y) of one stream (blockIdx.x) and walks n in 32-row
// chunks: both 64-column panels of the chunk go to shared memory as they
// lie in A (row-major, so the loads are coalesced and the stores, at an
// odd stride, free of bank conflicts; a diagonal tile loads its panel
// once), and each thread accumulates a 4×4 register patch in f32 FMA.
// The CTA writes its tile and, off the diagonal, the mirror, so G is
// exactly symmetric.  Ragged n and d need no padding: loads past them
// read zero and stores past d are skipped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTile = 64;
constexpr int kChunk = 32;
constexpr int kThreads = 256;
constexpr int kLd = kTile + 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// (ti, tj), ti ≤ tj, of upper-triangle tile number t of an nt × nt grid.
__device__ __forceinline__ void tile_of(int t, int nt, int* ti, int* tj) {
  int i = 0;
  while (t >= nt - i) {
    t -= nt - i;
    ++i;
  }
  *ti = i;
  *tj = i + t;
}

// Rows [r0, r0 + 32) of A, columns [c0, c0 + 64), into s[r][c] as f32.
template <typename T>
__device__ __forceinline__ void load_panel(const T* __restrict__ A, float* s,
                                           int r0, int c0, int n, int d) {
  for (int idx = threadIdx.x; idx < kTile * kChunk; idx += kThreads) {
    const int r = idx / kTile, c = idx % kTile;
    const int gr = r0 + r, gc = c0 + c;
    s[r * kLd + c] =
        (gr < n && gc < d) ? to_f32(A[(size_t)gr * d + gc]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_gram_kernel(const T* __restrict__ A, float* __restrict__ G, int n,
                   int d, int nt) {
  __shared__ float sa[kChunk * kLd];
  __shared__ float sb[kChunk * kLd];
  int ti, tj;
  tile_of(blockIdx.y, nt, &ti, &tj);
  const bool diag = ti == tj;
  const int bi = ti * kTile, bj = tj * kTile;
  const size_t b = blockIdx.x;
  const T* Ab = A + b * (size_t)n * d;
  const float* pb = diag ? sa : sb;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  float acc[4][4] = {};
  for (int r0 = 0; r0 < n; r0 += kChunk) {
    load_panel(Ab, sa, r0, bi, n, d);
    if (!diag) load_panel(Ab, sb, r0, bj, n, d);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kChunk; ++k) {
      float x[4], y[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        x[a] = sa[k * kLd + ty + 16 * a];
        y[a] = pb[k * kLd + tx + 16 * a];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(x[a], y[c], acc[a][c]);
    }
    __syncthreads();
  }

  float* Gb = G + b * (size_t)d * d;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = bi + ty + 16 * a, j = bj + tx + 16 * c;
      if (i < d && j < d) {
        Gb[(size_t)i * d + j] = acc[a][c];
        if (!diag) Gb[(size_t)j * d + i] = acc[a][c];
      }
    }
  }
}

template <typename T>
int launch(const void* A, float* G, int S, int n, int d,
           cudaStream_t stream) {
  const int nt = (d + kTile - 1) / kTile;
  const dim3 grid(S, nt * (nt + 1) / 2);
  window_gram_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(A), G, n, d, nt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Upper-triangle tiles of G one stream needs (the grid's y extent).
int window_gram_tiles(int d) {
  const int nt = (d + kTile - 1) / kTile;
  return nt * (nt + 1) / 2;
}

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

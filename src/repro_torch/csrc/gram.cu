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
// the f32 rate bounds a fleet launch (no TF32: the caller compares λ̂
// against θ).
//
// Design.  The Pallas kernel ran its d-blocks in order on one core with K
// resident in VMEM; here one CTA owns one 64×64 tile of K's upper
// triangle (blockIdx.y) of one stream (blockIdx.x), so a (256, 256, 300)
// slab gives 2,560 CTAs for 132 SMs.  The CTA streams d in 32-column
// chunks through shared memory (both 64-row panels, stored k-major with
// an odd stride so the transposing store and the reads are free of bank
// conflicts; a diagonal tile loads its panel once) and accumulates a 4×4
// register patch per thread in f32 FMA.  It writes its tile and, off the
// diagonal, the mirror, so K is exactly symmetric and the lower triangle
// costs no operations.  Ragged m and d need no padding: loads past them
// read zero and stores past m are skipped.

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
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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

// Rows [r0, r0 + 64) of X, columns [k0, k0 + 32), into s[k][r] as f32.
template <typename T>
__device__ __forceinline__ void load_panel(const T* __restrict__ X, float* s,
                                           int r0, int k0, int m, int d) {
  for (int idx = threadIdx.x; idx < kTile * kChunk; idx += kThreads) {
    const int r = idx / kChunk, k = idx % kChunk;
    const int gr = r0 + r, gk = k0 + k;
    s[k * kLd + r] =
        (gr < m && gk < d) ? to_f32(X[(size_t)gr * d + gk]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gram_kernel(const T* __restrict__ X, T* __restrict__ K, int m, int d,
            int nt) {
  __shared__ float sa[kChunk * kLd];
  __shared__ float sb[kChunk * kLd];
  int ti, tj;
  tile_of(blockIdx.y, nt, &ti, &tj);
  const bool diag = ti == tj;
  const int bi = ti * kTile, bj = tj * kTile;
  const size_t b = blockIdx.x;
  const T* Xb = X + b * (size_t)m * d;
  const float* pb = diag ? sa : sb;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < d; k0 += kChunk) {
    load_panel(Xb, sa, bi, k0, m, d);
    if (!diag) load_panel(Xb, sb, bj, k0, m, d);
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

  T* Kb = K + b * (size_t)m * m;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = bi + ty + 16 * a, j = bj + tx + 16 * c;
      if (i < m && j < m) {
        const T v = from_f32<T>(acc[a][c]);
        Kb[(size_t)i * m + j] = v;
        if (!diag) Kb[(size_t)j * m + i] = v;
      }
    }
  }
}

template <typename T>
int launch(const void* X, void* K, int S, int m, int d, cudaStream_t stream) {
  const int nt = (m + kTile - 1) / kTile;
  const dim3 grid(S, nt * (nt + 1) / 2);
  gram_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(X), static_cast<T*>(K), m, d, nt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Upper-triangle tiles of K one stream needs (the grid's y extent).
int gram_tiles(int m) {
  const int nt = (m + kTile - 1) / kTile;
  return nt * (nt + 1) / 2;
}

const char* gram_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K (S, m, m) = X Xᵀ per stream; bf16 != 0 for bf16 X and K, else f32.
int gram_xxt(const void* X, void* K, int S, int m, int d, int bf16,
             void* stream) {
  return bf16 ? launch<__nv_bfloat16>(X, K, S, m, d, (cudaStream_t)stream)
              : launch<float>(X, K, S, m, d, (cudaStream_t)stream);
}

}  // extern "C"

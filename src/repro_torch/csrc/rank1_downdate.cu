// Rank-1 downdate D′ = D − (D v) vᵀ of each stream's sketch buffer, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/rank1_downdate/kernel.py:43 (rank1_downdate_pallas,
// body _downdate_kernel), which made two passes over d-blocks (first
// p = D v into a VMEM column, then D − p vᵀ) to keep its VMEM working set
// at one block whatever d is.
//
// What it computes, for every stream b of an (S, m, d) slab D in f32 or
// bf16 and v (S, d) in f32: p = D_b v_b, D′_b = D_b − p v_bᵀ, in f32, written
// in D's dtype (round to nearest even for bf16), as
// repro/kernels/rank1_downdate/ref.py.
//
// What bounds it on this card: 4·m·d operations against reading D and v
// once and writing D′ once, under 1 FLOP per byte: device memory bounds
// it.  At the split dump step's shape (S = 256, m = 256, d = 300, f32)
// that is 157 MB, ~0.047 ms at 3.35 TB/s.
//
// Design.  One warp per row of D (8 rows of one stream per CTA; the
// stream is blockIdx.x, the group of rows blockIdx.y):
// the warp forms the row's dot product with v in a strided loop and a
// shuffle sum, then writes the row minus p·v.  The second pass over the
// row reads it back from L1 (a 300-float row is 1.2 KB), so D is read
// from device memory once, which is what the two-pass grid of the TPU
// kernel could not do.  v is read through the read-only cache.  Ragged m
// and d need no padding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerCta = kThreads / 32;

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rank1_downdate_kernel(const T* __restrict__ D, const float* __restrict__ v,
                      T* __restrict__ out, int m, int d) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.y * kRowsPerCta + (threadIdx.x >> 5);
  if (i >= m) return;
  const size_t b = blockIdx.x;
  const T* row = D + (b * m + i) * (size_t)d;
  const float* vb = v + b * (size_t)d;
  T* orow = out + (b * m + i) * (size_t)d;

  float p = 0.f;
  for (int k = lane; k < d; k += 32) p = fmaf(to_f32(row[k]), __ldg(vb + k), p);
  p = warp_sum(p);
  for (int k = lane; k < d; k += 32)
    orow[k] = from_f32<T>(to_f32(row[k]) - p * __ldg(vb + k));
}

template <typename T>
int launch(const void* D, const float* v, void* out, int S, int m, int d,
           cudaStream_t stream) {
  const dim3 grid(S, (m + kRowsPerCta - 1) / kRowsPerCta);
  rank1_downdate_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(D), v, static_cast<T*>(out), m, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* rank1_downdate_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// out (S, m, d) = D − (D v) vᵀ per stream; bf16 != 0 for bf16 D and out.
int rank1_downdate(const void* D, const float* v, void* out, int S, int m,
                   int d, int bf16, void* stream) {
  return bf16 ? launch<__nv_bfloat16>(D, v, out, S, m, d,
                                      (cudaStream_t)stream)
              : launch<float>(D, v, out, S, m, d, (cudaStream_t)stream);
}

}  // extern "C"

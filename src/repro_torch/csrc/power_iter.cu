// Power iteration for the top eigenpair of each stream's PSD Gram K, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/power_iter/kernel.py:42
// (power_iter_pallas, body _power_kernel), which held the whole (m, m) K
// in VMEM for every step.
//
// What it computes, for every stream b of an (S, m, m) f32 slab K:
// u₀ = 1/√m; `iters` times w = K u, u = w / √max(Σw², 1e-30) (or, with
// floor_norm != 0, w / max(‖w‖, 1e-30): the reference's inline krylov
// floor, repro/core/dsfd.py:200); then λ̂ = Σ (K u)·u.  -> λ̂ (S,), û (S, m)
//
// What bounds it on this card: the function needs K read once (m²·4 B a
// stream) and (iters + 1)·2m² operations, ~13 FLOP per byte at 24 steps,
// under the f32 ridge of 20: device memory bounds it.  But every step
// needs all of K, and at m = 256 one stream's K is 256 KB (1 MiB at
// m = 512), more than the 227 KB of shared memory a block may have, so K
// cannot stay resident as it did in VMEM or as D and K do in
// fused_tick.cu.
//
// Design.  One CTA per stream, 16 warps, u and w in shared memory, one
// warp per row of K (w_i = Σ_j K_ij u_j with coalesced row reads and a
// shuffle sum).  The CTA copies the first R rows of K into shared memory
// once, R as many as fit under the card's opt-in limit (all of them up to
// m = 240), and reads the remaining m − R rows from device memory (mostly
// L2) at every step.  A cluster of 2-8 CTAs holding K's row slices in
// distributed shared memory would keep all of K on chip; that is later
// work.  All arithmetic is plain f32 FMA, no TF32.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Sum over the block; every thread returns the same value.
__device__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  __syncthreads();  // `red` may still be read by the previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) t += red[i];
  return t;
}

// w = K u: one warp per row, rows [0, R) from shared memory.
__device__ void matvec(const float* __restrict__ gK, const float* sK,
                       const float* su, float* sw, int m, int R) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < m; i += kWarps) {
    const float* row = i < R ? sK + (size_t)i * m : gK + (size_t)i * m;
    float acc = 0.f;
    for (int j = lane; j < m; j += 32) acc = fmaf(row[j], su[j], acc);
    acc = warp_sum(acc);
    if (lane == 0) sw[i] = acc;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
power_iter_kernel(const float* __restrict__ K, float* __restrict__ lam_out,
                  float* __restrict__ u_out, int m, int R, int iters,
                  int floor_norm) {
  extern __shared__ float smem[];
  float* sK = smem;                    // R × m
  float* su = sK + (size_t)R * m;      // m
  float* sw = su + m;                  // m
  float* red = sw + m;                 // kWarps
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const float* gK = K + b * (size_t)m * m;

  for (size_t idx = tid; idx < (size_t)R * m; idx += kThreads) sK[idx] = gK[idx];
  const float u0 = 1.0f / sqrtf((float)m);
  for (int i = tid; i < m; i += kThreads) su[i] = u0;
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    matvec(gK, sK, su, sw, m, R);
    float ss = 0.f;
    for (int j = tid; j < m; j += kThreads) ss = fmaf(sw[j], sw[j], ss);
    ss = block_sum(ss, red);
    const float nrm = floor_norm ? fmaxf(sqrtf(ss), 1e-30f)
                                 : sqrtf(fmaxf(ss, 1e-30f));
    for (int j = tid; j < m; j += kThreads) su[j] = sw[j] / nrm;
    __syncthreads();
  }
  matvec(gK, sK, su, sw, m, R);
  float ss = 0.f;
  for (int j = tid; j < m; j += kThreads) ss = fmaf(sw[j], su[j], ss);
  const float lam = block_sum(ss, red);
  if (tid == 0) lam_out[b] = lam;
  for (int i = tid; i < m; i += kThreads) u_out[b * m + i] = su[i];
}

int max_smem(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

}  // namespace

extern "C" {

// Rows of an (m, m) K that the kernel keeps in shared memory on `device`,
// or -1 if the card's limit cannot be read or u and w do not fit.
int power_iter_resident_rows(int m, int device) {
  const int have = max_smem(device);
  if (have < 0) return -1;
  // u, w and the reduction first, then as many rows of K as fit
  const long rest = (long)have - (long)sizeof(float) * (2L * m + kWarps);
  if (rest < 0) return -1;
  const long fit = rest / ((long)m * (long)sizeof(float));
  return (int)(fit < 0 ? 0 : (fit < m ? fit : m));
}

const char* power_iter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int power_iter_topvec(const float* K, float* lam_out, float* u_out, int S,
                      int m, int iters, int floor_norm, int device,
                      void* stream) {
  const int R = power_iter_resident_rows(m, device);
  if (R < 0) return (int)cudaErrorInvalidDevice;
  const size_t smem =
      sizeof(float) * ((size_t)R * m + 2 * (size_t)m + kWarps);
  cudaError_t e = cudaFuncSetAttribute(
      power_iter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  power_iter_kernel<<<S, kThreads, smem, (cudaStream_t)stream>>>(
      K, lam_out, u_out, m, R, iters, floor_norm);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Fused DS-FD krylov tick for Hopper (sm_90a): one CTA per stream.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/fused_tick/kernel.py:
//   gram_power_pallas (kernel.py:66, body _gram_power_kernel)  -> fused_tick_gram_power
//   fused_step_pallas (kernel.py:110, body _fused_step_kernel) -> fused_tick_step
//
// What each computes, for every stream b of an (S, m, d) f32 slab D:
//   gram_power: K = D Dᵀ, then `iters` power steps from the uniform
//               u₀ = 1/√m (w = uK; u = w / √max(Σw², 1e-30)), and
//               λ̂ = Σ (uK)·u.                              -> λ̂ (S,), û (S, m)
//   step:       σ = √max(λ̂, 1e-30); v = ûD/σ, renormalised with the
//               same 1e-30 floor on Σv²; snap = σv; D′ = D − (Dv)vᵀ;
//               then gram_power on D′.  -> snap (S, d), D′ (S, m, d), λ̂′, û′
// With floor_norm != 0 every normalisation floors the norm instead,
// w / max(‖w‖, 1e-30): the reference's inline (use_pallas=False) path.
//
// What bounds it on this card: at the main path's shape (m = 2ℓ = 64,
// d = 300) one stream moves 2·m·d·4 B = 154 KB (read D, write D′), and the
// function needs m(m+1)·d = 1.25 MFLOP for the symmetric Gram (m(m+1)/2
// dot products of length d) plus ~0.3 MFLOP for the rest: about 10 FLOP
// per byte, under the H100's f32 ridge of 67 TFLOP/s / 3.35 TB/s = 20, so
// device memory bounds a full fleet launch.  (The Gram below forms all m²
// entries, twice the operations the function needs; at this intensity
// that costs time only once the kernel nears its memory bound.)
// The Pallas kernel kept D and K resident in VMEM for the whole step; the
// design here does the same with shared memory: the CTA reads D from device
// memory once, forms K = DDᵀ (m² floats) next to it, runs the 24
// matvec/normalise steps on K in shared memory and writes only the outputs,
// so the bytes moved are the minimum the function needs.  At m = 64,
// d = 300 that is ~96 KB of dynamic shared memory (above the 48 KB default,
// hence cudaFuncAttributeMaxDynamicSharedMemorySize), two CTAs per SM.
// Rows of D are stored with an odd stride so the Gram's column reads are
// free of bank conflicts.  All arithmetic is plain f32 FMA (no TF32):
// the caller compares λ̂ against θ, and a tensor-core product in TF32
// could flip that decision.  Ragged m and d need no padding: every loop
// is bounded by the true m and d.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
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

// K = D Dᵀ from shared memory.  A 16×16 thread grid computes 4×4
// register patches of each 64×64 tile of K.
__device__ void gram(const float* sD, float* sK, int m, int d, int ld) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int bi = 0; bi < m; bi += 64) {
    for (int bj = 0; bj < m; bj += 64) {
      const float* ra[4];
      const float* rb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        ra[a] = sD + min(bi + ty + 16 * a, m - 1) * ld;
        rb[a] = sD + min(bj + tx + 16 * a, m - 1) * ld;
      }
      float acc[4][4] = {};
      for (int k = 0; k < d; ++k) {
        float x[4], y[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          x[a] = ra[a][k];
          y[a] = rb[a][k];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(x[a], y[c], acc[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = bi + ty + 16 * a, j = bj + tx + 16 * c;
          if (i < m && j < m) sK[i * m + j] = acc[a][c];
        }
      }
    }
  }
  __syncthreads();
}

// w = u K.  For m ≤ kThreads the sum over i is split into kThreads/m
// partial sums per output, combined in a second pass.
__device__ void matvec(const float* sK, const float* su, float* sw,
                       float* part, int m) {
  const int tid = threadIdx.x;
  if (m <= kThreads) {
    const int parts = kThreads / m;
    const int chunk = (m + parts - 1) / parts;
    if (tid < parts * m) {
      const int j = tid % m, p = tid / m;
      const int lo = p * chunk, hi = min(m, lo + chunk);
      float acc = 0.f;
      for (int i = lo; i < hi; ++i) acc = fmaf(su[i], sK[i * m + j], acc);
      part[p * m + j] = acc;
    }
    __syncthreads();
    if (tid < m) {
      float acc = 0.f;
      for (int p = 0; p < parts; ++p) acc += part[p * m + tid];
      sw[tid] = acc;
    }
  } else {
    for (int j = tid; j < m; j += kThreads) {
      float acc = 0.f;
      for (int i = 0; i < m; ++i) acc = fmaf(su[i], sK[i * m + j], acc);
      sw[j] = acc;
    }
  }
  __syncthreads();
}

// The divisor that normalises a vector with squared norm `ss`: the fused
// floor √max(ss, 1e-30), or the inline floor max(√ss, 1e-30).
__device__ __forceinline__ float floored_norm(float ss, int floor_norm) {
  return floor_norm ? fmaxf(sqrtf(ss), 1e-30f) : sqrtf(fmaxf(ss, 1e-30f));
}

// Power iteration on K from the uniform start; leaves û in `su` and
// returns λ̂ = Σ (ûK)·û.
__device__ float power(const float* sK, float* su, float* sw, float* part,
                       float* red, int m, int iters, int floor_norm) {
  const int tid = threadIdx.x;
  const float u0 = 1.0f / sqrtf((float)m);
  for (int i = tid; i < m; i += kThreads) su[i] = u0;
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    matvec(sK, su, sw, part, m);
    float ss = 0.f;
    for (int j = tid; j < m; j += kThreads) ss = fmaf(sw[j], sw[j], ss);
    const float nrm = floored_norm(block_sum(ss, red), floor_norm);
    for (int j = tid; j < m; j += kThreads) su[j] = sw[j] / nrm;
    __syncthreads();
  }
  matvec(sK, su, sw, part, m);
  float ss = 0.f;
  for (int j = tid; j < m; j += kThreads) ss = fmaf(sw[j], su[j], ss);
  return block_sum(ss, red);
}

template <bool kStep>
__global__ void __launch_bounds__(kThreads)
fused_tick_kernel(const float* __restrict__ D, const float* __restrict__ lam_in,
                  const float* __restrict__ u_in, float* __restrict__ snap,
                  float* __restrict__ D_out, float* __restrict__ lam_out,
                  float* __restrict__ u_out, int m, int d, int iters,
                  int floor_norm) {
  extern __shared__ float smem[];
  const int ld = d | 1;  // odd row stride: conflict-free Gram reads
  float* sD = smem;               // m × ld
  float* sK = sD + m * ld;        // m × m
  float* su = sK + m * m;         // m
  float* sw = su + m;             // m
  float* sp = sw + m;             // m
  float* sv = sp + m;             // d
  float* part = sv + d;           // kThreads
  float* red = part + kThreads;   // kWarps
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const size_t md = (size_t)m * d;

  const float* g = D + b * md;
  for (int idx = tid; idx < m * d; idx += kThreads) {
    const int i = idx / d, k = idx - i * d;
    sD[i * ld + k] = g[idx];
  }
  if (kStep)
    for (int i = tid; i < m; i += kThreads) su[i] = u_in[b * m + i];
  __syncthreads();

  if (kStep) {
    const float sigma = sqrtf(fmaxf(lam_in[b], 1e-30f));
    float ss = 0.f;
    for (int j = tid; j < d; j += kThreads) {
      float acc = 0.f;
      for (int i = 0; i < m; ++i) acc = fmaf(su[i], sD[i * ld + j], acc);
      const float vj = acc / sigma;
      sv[j] = vj;
      ss = fmaf(vj, vj, ss);
    }
    const float nrm = floored_norm(block_sum(ss, red), floor_norm);
    float* gs = snap + b * d;
    for (int j = tid; j < d; j += kThreads) {
      const float vj = sv[j] / nrm;
      sv[j] = vj;
      gs[j] = sigma * vj;
    }
    __syncthreads();
    // p = D v, one warp per row
    const int lane = tid & 31, warp = tid >> 5;
    for (int i = warp; i < m; i += kWarps) {
      float acc = 0.f;
      for (int k = lane; k < d; k += 32) acc = fmaf(sD[i * ld + k], sv[k], acc);
      acc = warp_sum(acc);
      if (lane == 0) sp[i] = acc;
    }
    __syncthreads();
    float* go = D_out + b * md;
    for (int idx = tid; idx < m * d; idx += kThreads) {
      const int i = idx / d, k = idx - i * d;
      const float x = sD[i * ld + k] - sp[i] * sv[k];
      sD[i * ld + k] = x;
      go[idx] = x;
    }
    __syncthreads();
  }

  gram(sD, sK, m, d, ld);
  const float lam = power(sK, su, sw, part, red, m, iters, floor_norm);
  if (tid == 0) lam_out[b] = lam;
  for (int i = tid; i < m; i += kThreads) u_out[b * m + i] = su[i];
}

template <bool kStep>
int launch(const float* D, const float* lam, const float* u, float* snap,
           float* D_out, float* lam_out, float* u_out, int S, int m, int d,
           int iters, int floor_norm, size_t smem, cudaStream_t stream) {
  auto kern = fused_tick_kernel<kStep>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<S, kThreads, smem, stream>>>(D, lam, u, snap, D_out, lam_out, u_out,
                                      m, d, iters, floor_norm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs for an (m, d) buffer.
size_t fused_tick_smem_bytes(int m, int d) {
  const size_t ld = (size_t)(d | 1);
  return sizeof(float) * ((size_t)m * ld + (size_t)m * m + 3 * (size_t)m +
                          (size_t)d + kThreads + kWarps);
}

// Shared memory a CTA may opt in to on `device` (bytes), or -1.
int fused_tick_max_smem(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

const char* fused_tick_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int fused_tick_gram_power(const float* D, float* lam_out, float* u_out, int S,
                          int m, int d, int iters, int floor_norm,
                          void* stream) {
  return launch<false>(D, nullptr, nullptr, nullptr, nullptr, lam_out, u_out,
                       S, m, d, iters, floor_norm, fused_tick_smem_bytes(m, d),
                       (cudaStream_t)stream);
}

int fused_tick_step(const float* D, const float* lam, const float* u,
                    float* snap, float* D_out, float* lam_out, float* u_out,
                    int S, int m, int d, int iters, int floor_norm,
                    void* stream) {
  return launch<true>(D, lam, u, snap, D_out, lam_out, u_out, S, m, d, iters,
                      floor_norm, fused_tick_smem_bytes(m, d),
                      (cudaStream_t)stream);
}

}  // extern "C"

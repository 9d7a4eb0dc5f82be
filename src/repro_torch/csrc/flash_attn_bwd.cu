// Flash-attention backward for Hopper (sm_90a), f32 on the CUDA cores for
// both input types.
//
// Replaces the backward of the flash op in
// src/repro/kernels/flash_attn/ops.py: _bwd (ops.py:58), the custom VJP
// registered on flash_attention (ops.py:136).  In the reference it is pure
// JAX, two tile-recompute passes; it has no pallas_call of its own.
//
// What it computes, from the forward's residuals q (BH, S, dh), k, v
// (BHkv, S, dh), o (BH, S, dh), lse (BH, S) f32 and the incoming dO
// (BH, S, dh), BH = BHkv·G, query head bh reading KV head bh / G, all in
// f32 (bf16 inputs widened with __bfloat162float):
//   qs = q · scale, scale = 1/√dh;  s = qs kᵀ;  causal: s = -1e30 where
//   key j > query i;  P = exp(s − lse)  (masked entries underflow to 0);
//   D = rowsum(dO ∘ o);  dP = dO vᵀ;  dS = P ∘ (dP − D);
//   dQ = dS k · scale;  dK = Σ_group dSᵀ qs;  dV = Σ_group Pᵀ dO;
// outputs in the inputs' type (round to nearest even for bf16).  The
// forward's own lse is used, never recomputed.
//
// What bounds it on this card.  At smollm-135m's training shape (B=8,
// H=9, Hkv=3, S=1024, dh=64, causal, f32) the five products S, dP, dV,
// dQ and dK take 2·S²·dh each, halved by the mask, over 72 query heads:
// 24.2 GFLOP, 0.36 ms at the f32 peak of 67 TFLOP/s.  The bytes (q, o,
// dO, dq at 18.9 MB each, k, v, dk, dv at 6.3 MB each, lse) are ~101 MB,
// 0.03 ms at 3.35 TB/s.  So the function is bound by operations, on the
// CUDA cores: TF32 would round q, k, v and dO to 10 mantissa bits, and no
// kernel of the port uses it.
//
// Design: deterministic, no atomics, three launches on one stream.
// - D: a warp per row sums dO ∘ o into an f32 scratch (BH, S) that the
//   wrapper allocates.
// - dQ: a CTA per (q head, 64-row q tile), 256 threads.  Q (scaled), dO,
//   lse and D of the tile stay in shared memory; the CTA walks the 64-key
//   tiles of K and V up to the diagonal.  Per tile: S and dP in one loop
//   over dh (thread (ty, tx) owns rows ty + 16a and columns tx + 16b),
//   P and dS in registers, dS through shared memory, then dQ += dS·K into
//   a 4 × dh/16 register patch.  The heaviest tiles (nearest the end)
//   launch first.
// - dK, dV: a CTA per (KV head, 64-row KV tile).  K and V stay in shared
//   memory; the CTA walks the G query heads of its group and, for each,
//   the q tiles from the diagonal down, recomputing S and dP, and sums
//   dV += Pᵀ dO and dK += dSᵀ qs in registers.  The group's sum never
//   leaves the CTA, so no reduction across CTAs is needed.
// - Rows of every tile sit at an odd stride (dh + 1, 65) in shared memory,
//   so the column reads of the products are free of bank conflicts.
// - Masked tiles above the diagonal are skipped; inside the diagonal tile
//   the mask sets s to -1e30 and exp(-1e30 − lse) is exactly 0.
// - Shared memory: 165,888 B at dh = 128 (the dK/dV pass), within what a
//   block may opt in to (flash_attn_bwd_smem_bytes).  S must be a multiple
//   of 64 (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;   // a 16×16 grid of threads over a 64×64 tile
constexpr int kTile = 64;       // query rows and keys per tile
constexpr int kLDP = kTile + 1; // row stride of the P and dS tiles

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Dynamic shared memory (floats) of the dQ pass: Q, dO, K, V tiles at an
// odd stride, the dS tile, lse and D per query row.
constexpr size_t dq_floats(int dh) {
  return 4 * (size_t)kTile * (dh + 1) + (size_t)kTile * kLDP + 2 * kTile;
}

// The dK/dV pass: K, V, Q, dO tiles, the P and dS tiles, lse and D.
constexpr size_t dkv_floats(int dh) {
  return 4 * (size_t)kTile * (dh + 1) + 2 * (size_t)kTile * kLDP +
         2 * kTile;
}

// rows × DH elements of `src` (row-major, DH wide) into `dst` at stride
// DH + 1, times `mul`, widened to f32.
template <int DH, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, float mul) {
  for (int idx = threadIdx.x; idx < kTile * DH; idx += kThreads) {
    const int r = idx / DH, c = idx - r * DH;
    dst[r * (DH + 1) + c] = widen(src[idx]) * mul;
  }
}

// D = rowsum(dO ∘ o): one warp a row.
template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dot(const T* __restrict__ o, const T* __restrict__ dout,
              float* __restrict__ D, int rows) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* po = o + (size_t)row * DH;
  const T* pd = dout + (size_t)row * DH;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < DH; c += 32) acc = fmaf(widen(pd[c]), widen(po[c]), acc);
  acc = warp_sum(acc);
  if (lane == 0) D[row] = acc;
}

// s = qs kᵀ and dp = dO vᵀ for thread (ty, tx)'s 4×4 patch: rows
// ty + 16a of sQ and sO (queries), rows tx + 16b of sK and sV (keys).
template <int DH>
__device__ __forceinline__ void scores(const float* sQ, const float* sO,
                                       const float* sK, const float* sV,
                                       int ty, int tx, float s[4][4],
                                       float dp[4][4]) {
  constexpr int LD = DH + 1;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = dp[a][b] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qa[a] = sQ[(ty + 16 * a) * LD + d];
      oa[a] = sO[(ty + 16 * a) * LD + d];
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      kb[b] = sK[(tx + 16 * b) * LD + d];
      vb[b] = sV[(tx + 16 * b) * LD + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
        dp[a][b] = fmaf(oa[a], vb[b], dp[a][b]);
      }
  }
}

template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ lse,
             const T* __restrict__ dout, const float* __restrict__ D,
             T* __restrict__ dq, int S, int G, float scale, int causal) {
  constexpr int LD = DH + 1;
  constexpr int NC = DH / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sO = sQ + kTile * LD;
  float* sK = sO + kTile * LD;
  float* sV = sK + kTile * LD;
  float* sS = sV + kTile * LD;
  float* sL = sS + kTile * kLDP;
  float* sD = sL + kTile;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int nq = S / kTile;
  const int qi = nq - 1 - blockIdx.x;    // the longest rows first
  const int q0 = qi * kTile;
  const int bh = blockIdx.y;
  const size_t qoff = ((size_t)bh * S + q0) * DH;
  const size_t kv_base = (size_t)(bh / G) * S * DH;

  stage<DH>(sQ, q + qoff, scale);
  stage<DH>(sO, dout + qoff, 1.f);
  if (tid < kTile) {
    sL[tid] = lse[(size_t)bh * S + q0 + tid];
    sD[tid] = D[(size_t)bh * S + q0 + tid];
  }
  float acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < NC; ++b) acc[a][b] = 0.f;

  const int kv_end = causal ? qi + 1 : nq;
  for (int kj = 0; kj < kv_end; ++kj) {
    __syncthreads();  // the previous tile's K and dS are no longer read
    stage<DH>(sK, k + kv_base + (size_t)kj * kTile * DH, 1.f);
    stage<DH>(sV, v + kv_base + (size_t)kj * kTile * DH, 1.f);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores<DH>(sQ, sO, sK, sV, ty, tx, s, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = ty + 16 * a, c = tx + 16 * b;
        const bool masked = causal && kj * kTile + c > q0 + r;
        const float p = expf((masked ? kNegInf : s[a][b]) - sL[r]);
        sS[r * kLDP + c] = p * (dp[a][b] - sD[r]);
      }
    __syncthreads();
    // dQ += dS · K: rows ty + 16a, columns tx + 16b of dh
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float da[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) da[a] = sS[(ty + 16 * a) * kLDP + j];
#pragma unroll
      for (int b = 0; b < NC; ++b) {
        const float kb = sK[j * LD + tx + 16 * b];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][b] = fmaf(da[a], kb, acc[a][b]);
      }
    }
  }
  T* out = dq + qoff;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < NC; ++b)
      narrow(out + (ty + 16 * a) * DH + tx + 16 * b, acc[a][b] * scale);
}

template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ lse,
              const T* __restrict__ dout, const float* __restrict__ D,
              T* __restrict__ dk, T* __restrict__ dv, int S, int G,
              float scale, int causal) {
  constexpr int LD = DH + 1;
  constexpr int NC = DH / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * LD;
  float* sQ = sV + kTile * LD;
  float* sO = sQ + kTile * LD;
  float* sP = sO + kTile * LD;
  float* sS = sP + kTile * kLDP;
  float* sL = sS + kTile * kLDP;
  float* sD = sL + kTile;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int nq = S / kTile;
  const int kj = blockIdx.x;             // the longest walks first
  const int k0 = kj * kTile;
  const int bhkv = blockIdx.y;
  const size_t koff = ((size_t)bhkv * S + k0) * DH;

  stage<DH>(sK, k + koff, 1.f);
  stage<DH>(sV, v + koff, 1.f);
  float gk[4][NC], gv[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < NC; ++b) gk[a][b] = gv[a][b] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int bh = bhkv * G + g;
    for (int qi = causal ? kj : 0; qi < nq; ++qi) {
      const int q0 = qi * kTile;
      const size_t qoff = ((size_t)bh * S + q0) * DH;
      __syncthreads();  // the previous tile's Q, dO, P and dS are read
      stage<DH>(sQ, q + qoff, scale);
      stage<DH>(sO, dout + qoff, 1.f);
      if (tid < kTile) {
        sL[tid] = lse[(size_t)bh * S + q0 + tid];
        sD[tid] = D[(size_t)bh * S + q0 + tid];
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      scores<DH>(sQ, sO, sK, sV, ty, tx, s, dp);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int r = ty + 16 * a, c = tx + 16 * b;
          const bool masked = causal && k0 + c > q0 + r;
          const float p = expf((masked ? kNegInf : s[a][b]) - sL[r]);
          sP[r * kLDP + c] = p;
          sS[r * kLDP + c] = p * (dp[a][b] - sD[r]);
        }
      __syncthreads();
      // dV += Pᵀ dO, dK += dSᵀ qs: key rows ty + 16a, columns tx + 16b
#pragma unroll 2
      for (int r = 0; r < kTile; ++r) {
        float pa[4], da[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pa[a] = sP[r * kLDP + ty + 16 * a];
          da[a] = sS[r * kLDP + ty + 16 * a];
        }
#pragma unroll
        for (int b = 0; b < NC; ++b) {
          const float ob = sO[r * LD + tx + 16 * b];
          const float qb = sQ[r * LD + tx + 16 * b];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            gv[a][b] = fmaf(pa[a], ob, gv[a][b]);
            gk[a][b] = fmaf(da[a], qb, gk[a][b]);
          }
        }
      }
    }
  }
  T* ok = dk + koff;
  T* ov = dv + koff;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < NC; ++b) {
      const int at = (ty + 16 * a) * DH + tx + 16 * b;
      narrow(ok + at, gk[a][b]);
      narrow(ov + at, gv[a][b]);
    }
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

template <int DH, typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, float* D, void* dq, void* dk,
           void* dv, int BH, int BHkv, int S, float scale, int causal,
           cudaStream_t stream) {
  static unsigned done_dq = 0, done_dkv = 0;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const int G = BH / BHkv;
  const int rows = BH * S;
  const int warps = kThreads / 32;
  flash_bwd_dot<DH, T><<<(rows + warps - 1) / warps, kThreads, 0, stream>>>(
      static_cast<const T*>(o), tdo, D, rows);
  int e = (int)cudaGetLastError();
  if (e) return e;

  auto kdq = flash_bwd_dq<DH, T>;
  const size_t smem_dq = dq_floats(DH) * sizeof(float);
  if ((e = opt_in(kdq, smem_dq, &done_dq))) return e;
  kdq<<<dim3(S / kTile, BH), kThreads, smem_dq, stream>>>(
      tq, tk, tv, lse, tdo, D, static_cast<T*>(dq), S, G, scale, causal);
  if ((e = (int)cudaGetLastError())) return e;

  auto kdkv = flash_bwd_dkv<DH, T>;
  const size_t smem_dkv = dkv_floats(DH) * sizeof(float);
  if ((e = opt_in(kdkv, smem_dkv, &done_dkv))) return e;
  kdkv<<<dim3(S / kTile, BHkv), kThreads, smem_dkv, stream>>>(
      tq, tk, tv, lse, tdo, D, static_cast<T*>(dk), static_cast<T*>(dv), S,
      G, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// S must be a multiple of this (the query and key tiles).
int flash_attn_bwd_tile() { return kTile; }

// Dynamic shared memory the larger of the two tiled passes needs at head
// dimension dh (bytes).
size_t flash_attn_bwd_smem_bytes(int dh) {
  const size_t a = dq_floats(dh), b = dkv_floats(dh);
  return (a > b ? a : b) * sizeof(float);
}

// Shared memory a CTA may opt in to on `device` (bytes), or -1.
int flash_attn_bwd_max_smem(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

const char* flash_attn_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dq (BH, S, dh), dk and dv (BHkv, S, dh) from q, o, dout (BH, S, dh),
// k, v (BHkv, S, dh) and lse (BH, S) f32; D is an f32 scratch of (BH, S).
// bf16 != 0 for bfloat16 tensors, else float32.
int flash_attn_bwd(const void* q, const void* k, const void* v,
                   const void* o, const float* lse, const void* dout,
                   float* D, void* dq, void* dk, void* dv, int BH, int BHkv,
                   int S, int dh, int bf16, int causal, float scale,
                   void* stream) {
  if (BHkv <= 0 || BH % BHkv != 0 || S % kTile != 0 || BH > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define FLASH_BWD_ARGS \
  q, k, v, o, lse, dout, D, dq, dk, dv, BH, BHkv, S, scale, causal, st
  if (dh == 64)
    return bf16 ? launch<64, __nv_bfloat16>(FLASH_BWD_ARGS)
                : launch<64, float>(FLASH_BWD_ARGS);
  if (dh == 128)
    return bf16 ? launch<128, __nv_bfloat16>(FLASH_BWD_ARGS)
                : launch<128, float>(FLASH_BWD_ARGS);
#undef FLASH_BWD_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

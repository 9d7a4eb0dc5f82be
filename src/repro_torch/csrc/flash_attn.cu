// Flash-attention forward for Hopper (sm_90a): one CTA per (bh, q-tile).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attn/kernel.py:
//   flash_fwd_pallas (kernel.py:86, body _flash_fwd_kernel) -> flash_attn_fwd
//
// What it computes, for q (BH, S, dh) and k, v (BHkv, S, dh) with
// BH = BHkv·G, in bf16 or f32.  Query head bh reads KV head bh / G:
//   s = (q·scale) kᵀ in f32, the scale 1/√dh applied to q before the dot;
//   causal: s[i][j] = -1e30 (not -inf) where key j > query i;
//   online softmax over KV tiles: m′ = max(m, rowmax s), p = exp(s − m′),
//   c = exp(m − m′), l′ = l·c + Σp, acc′ = acc·c + p·v;
//   o = acc / max(l, 1e-30) in q's type, lse = m + log max(l, 1e-30) in f32.
//
// What bounds it on this card.  At llama3-8b's prefill (B=1, S=512, H=32,
// Hkv=8, dh=128, bf16) the function reads q (4 MiB), k and v (1 MiB each)
// and writes o (4 MiB) and lse (64 KiB): ~10.5 MB, 3.1 µs at 3.35 TB/s.
// Its causal work, 4·dh·H·S(S+1)/2 = 2.15 GFLOP, is 2.2 µs on the bf16
// tensor cores (989 TFLOP/s), so the function itself is bound by bytes.
// This first kernel computes in f32 on the CUDA cores, as the Pallas
// kernel's f32 upcasts do (67 TFLOP/s: 32 µs for the same work), and its
// inner loops read their operands from shared memory, so what bounds THIS
// kernel is operations: the f32 FMA rate and the shared-memory reads that
// feed it.  Tensor cores (wgmma, with TMA loads) are the next step.
//
// Design.  The Pallas grid walked the KV axis sequentially with acc, m and
// l in VMEM scratch; here a loop inside the CTA takes the place of that
// axis.  The CTA loads its 64 query rows once (scaled, as f32) into shared
// memory and keeps them for the whole KV sweep; each 64-key tile of K and
// V is staged through shared memory once; m, l and the per-row correction
// live in shared memory and the (64, dh) accumulator in registers, in f32.
// A causal CTA stops at the diagonal: tiles whose first key lies after its
// last query are never loaded.  S must be a multiple of 64 (the wrapper
// checks).  The shared memory (65.5 KB at dh=64, 113.5 KB at dh=128) is
// above the 48 KB default, so the launch opts in to dynamic shared memory.
// Rows of Q and K are stored with an odd stride so the score loop's column
// reads are free of bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;   // 8 warps; a 16×16 grid for the tile products
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 64;         // query rows per CTA
constexpr int kBKV = 64;        // keys per KV tile
constexpr int kLDP = kBKV + 1;  // row stride of the score tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as XLA's astype
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Dynamic shared memory of one CTA, in floats: Q and K tiles at an odd
// stride, the V tile, the score tile, and m, l, c per query row.
constexpr size_t smem_floats(int dh) {
  return (size_t)kBQ * (dh + 1) + (size_t)kBKV * (dh + 1) +
         (size_t)kBKV * dh + (size_t)kBQ * kLDP + 3 * (size_t)kBQ;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int G, float scale,
                 int causal) {
  constexpr int LD = DH + 1;
  constexpr int NC = DH / 16;   // output columns per thread
  constexpr int RW = kBQ / kWarps;  // softmax rows per warp
  extern __shared__ float smem[];
  float* sQ = smem;             // kBQ × LD
  float* sK = sQ + kBQ * LD;    // kBKV × LD
  float* sV = sK + kBKV * LD;   // kBKV × DH
  float* sP = sV + kBKV * DH;   // kBQ × kLDP: scores, then probabilities
  float* sM = sP + kBQ * kLDP;  // running row max
  float* sL = sM + kBQ;         // running row sum
  float* sC = sL + kBQ;         // this tile's correction exp(m − m′)

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const T* gq = q + ((size_t)bh * S + q0) * DH;
  const size_t kv_base = (size_t)(bh / G) * S * DH;

  for (int idx = tid; idx < kBQ * DH; idx += kThreads) {
    const int r = idx / DH, c = idx - r * DH;
    sQ[r * LD + c] = to_f32(gq[idx]) * scale;
  }
  if (tid < kBQ) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }
  float acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < NC; ++b) acc[a][b] = 0.f;

  // causal: the first tile whose first key lies after this CTA's last query
  const int n_kv = S / kBKV;
  const int kv_end = causal ? min(n_kv, (q0 + kBQ - 1) / kBKV + 1) : n_kv;

  for (int kj = 0; kj < kv_end; ++kj) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    const T* gk = k + kv_base + (size_t)kj * kBKV * DH;
    const T* gv = v + kv_base + (size_t)kj * kBKV * DH;
    for (int idx = tid; idx < kBKV * DH; idx += kThreads) {
      const int r = idx / DH, c = idx - r * DH;
      sK[r * LD + c] = to_f32(gk[idx]);
      sV[idx] = to_f32(gv[idx]);
    }
    __syncthreads();

    // scores: thread (ty, tx) owns rows ty + 16a and columns tx + 16b
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = sQ[(ty + 16 * a) * LD + d];
#pragma unroll
      for (int b = 0; b < 4; ++b) kb[b] = sK[(tx + 16 * b) * LD + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = ty + 16 * a, c = tx + 16 * b;
        const bool masked = causal && kj * kBKV + c > q0 + r;
        sP[r * kLDP + c] = masked ? kNegInf : s[a][b];
      }
    __syncthreads();

    // online softmax: warp w owns rows RW·w .. RW·w + RW − 1, a lane owns
    // columns lane and lane + 32 of each
    for (int rr = 0; rr < RW; ++rr) {
      const int r = warp * RW + rr;
      float* row = sP + r * kLDP;
      const float x0 = row[lane], x1 = row[lane + 32];
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      row[lane] = p0;
      row[lane + 32] = p1;
      const float psum = warp_sum(p0 + p1);
      __syncwarp();  // every lane has read sM[r] before lane 0 writes it
      if (lane == 0) {
        const float c = expf(m_prev - m_new);
        sL[r] = sL[r] * c + psum;
        sM[r] = m_new;
        sC[r] = c;
      }
    }
    __syncthreads();

    // acc = acc·c + P·V: thread (ty, tx) owns rows ty + 16a, columns tx + 16b
    float pv[4][NC];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < NC; ++b) pv[a][b] = 0.f;
#pragma unroll 4
    for (int j = 0; j < kBKV; ++j) {
      float pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = sP[(ty + 16 * a) * kLDP + j];
#pragma unroll
      for (int b = 0; b < NC; ++b) {
        const float vb = sV[j * DH + tx + 16 * b];
#pragma unroll
        for (int a = 0; a < 4; ++a) pv[a][b] = fmaf(pa[a], vb, pv[a][b]);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float c = sC[ty + 16 * a];
#pragma unroll
      for (int b = 0; b < NC; ++b) acc[a][b] = acc[a][b] * c + pv[a][b];
    }
  }

  // sM and sL were last written before the loop's final __syncthreads
  T* go = o + ((size_t)bh * S + q0) * DH;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    const float l = fmaxf(sL[r], 1e-30f);
#pragma unroll
    for (int b = 0; b < NC; ++b)
      store(go + r * DH + tx + 16 * b, acc[a][b] / l);
  }
  if (tid < kBQ)
    lse[(size_t)bh * S + q0 + tid] = sM[tid] + logf(fmaxf(sL[tid], 1e-30f));
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int BH, int S, int G, float scale, int causal,
           cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, DH>;
  const size_t smem = smem_floats(DH) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(S / kBQ, BH);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, G, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Query rows and keys per tile: S must be a multiple of both.
int flash_attn_tile() { return kBQ > kBKV ? kBQ : kBKV; }

// Dynamic shared memory one CTA needs at head dimension dh (bytes).
size_t flash_attn_smem_bytes(int dh) {
  return smem_floats(dh) * sizeof(float);
}

// Shared memory a CTA may opt in to on `device` (bytes), or -1.
int flash_attn_max_smem(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

const char* flash_attn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// o (BH, S, dh) and lse (BH, S) of q (BH, S, dh), k and v (BHkv, S, dh);
// bf16 != 0 for bfloat16 q, k, v and o, else float32.
int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                   float* lse, int BH, int BHkv, int S, int dh, int bf16,
                   int causal, float scale, void* stream) {
  if (BHkv <= 0 || BH % BHkv != 0 || S % kBQ != 0 || S % kBKV != 0)
    return (int)cudaErrorInvalidValue;
  const int G = BH / BHkv;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dh == 64)
    return bf16 ? launch<__nv_bfloat16, 64>(q, k, v, o, lse, BH, S, G, scale,
                                            causal, st)
                : launch<float, 64>(q, k, v, o, lse, BH, S, G, scale, causal,
                                    st);
  if (dh == 128)
    return bf16 ? launch<__nv_bfloat16, 128>(q, k, v, o, lse, BH, S, G,
                                             scale, causal, st)
                : launch<float, 128>(q, k, v, o, lse, BH, S, G, scale,
                                     causal, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

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
// Design: deterministic, no atomics, two launches on one stream, seven
// products (S and dP are computed for dQ and again for dK and dV: 38.1
// GFLOP executed at the training shape, with the diagonal tiles' masked
// parts, for the 24.2 the bound counts).  The five-product alternative,
// S and dP once with dQ accumulated across key tiles in a fixed order,
// was not built: its dQ partial products do not fit the dK/dV role's
// registers at dh = 128 (249 a thread already).
// - D = rowsum(dO ∘ o), a warp a row, into an f32 scratch (BH, S) that
//   the wrapper allocates: its own pass, since the dK/dV role needs D of
//   every query row it visits from its first step.
// - One grid for both roles (flash_bwd_f32).  Its first BHkv·tiles CTAs
//   compute dK and dV of a (KV head, key tile), key tile 0 (the longest
//   walk) first; the other BH·tiles compute dQ of a (query head, query
//   tile), the last (longest) query tiles first.  The scheduler hands the
//   CTAs out in that order as SMs free up, so the short dQ CTAs fill in
//   behind the long dK/dV ones: at the training shape 192 + 576 CTAs, 5.8
//   waves over 132 SMs at one CTA a SM, where two grids left the dK/dV
//   grid's last of 1.5 waves on a few SMs.
// - Both roles are register-blocked (csrc/flash_f32.cuh: each thread an
//   8 × 4 patch of S and dP and an 8 × dh/16 patch of its gradients,
//   16-byte shared loads, 8 or more FFMAs a shared-memory wavefront) and
//   stream their tiles through a 2-stage cp.async ring (f32; bf16 tiles
//   are widened through registers), one barrier for the ring and one for
//   P and dS a tile.  P = exp(s − lse) is taken as 2^((s − lse)·log2 e):
//   s − lse is rounded once in natural units, as the plain version's is,
//   and only the small difference is scaled (2^(s·log2 e − lse·log2 e)
//   would round two terms of ~30 at a peaked softmax).  256 threads and
//   128-row kept tiles at dh = 64, 128 and 64 at dh = 128 (what fits
//   227 KB of shared memory).
// - dQ: Q (times scale) and dO stay in shared memory, transposed;
//   the CTA walks the 64-key tiles of K and V up to the diagonal: S and dP
//   in registers, P and dS in registers, dS once through shared memory
//   (transposed), dQ += dS·K in registers.
// - dK, dV: K and V stay in shared memory, transposed; the CTA walks the
//   G query heads of its group and, for each, the 64-row q tiles from the
//   diagonal down, streaming Q, dO, lse and D: Sᵀ and dPᵀ in registers, P
//   and dS once through shared memory, dV += Pᵀ dO and dK += dSᵀ q in
//   registers.  The group's sum never leaves the CTA, so no reduction
//   across CTAs is needed, and every output is the same sum in the same
//   order on every call: the backward is bitwise repeatable.
// - Shared memory: 203,776 B at dh = 64 and 230,400 B at dh = 128 (the
//   dK/dV role's; dQ's 169,984 and 213,504).
// - Masked tiles above the diagonal are skipped; inside a diagonal tile
//   the mask sets s to -1e30 and exp(-1e30 − lse) is exactly 0.  A query
//   or key tile past S (S a multiple of 64, not of the tile) is zero in
//   shared memory and never stored.  S must be a multiple of 64 (the
//   wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "flash_f32.cuh"

namespace {

// Threads of a CTA of either role at head dimension DH; its row side
// covers 8 · NT / 16 rows (query rows in dQ, keys in dK/dV).
__host__ __device__ constexpr int threads_for(int dh) {
  return dh == 64 ? 256 : 128;
}
__host__ __device__ constexpr int rows_for(int dh) {
  return threads_for(dh) / 2;
}

// Dynamic shared memory (floats) of the dQ role: Q and dO transposed, the
// K and V rings, dS transposed, lse and D of the tile's rows.
constexpr size_t dq_floats(int dh) {
  return 2 * (size_t)dh * rows_for(dh) +
         4 * (size_t)kStream * row_floats(dh, dh) +
         (size_t)kStream * row_floats(rows_for(dh), dh) +
         2 * (size_t)rows_for(dh);
}

// The dK/dV role: K and V transposed, the Q and dO rings, P and dS, and
// the lse and D rings.
constexpr size_t dkv_floats(int dh) {
  return 2 * (size_t)dh * rows_for(dh) +
         4 * (size_t)kStream * row_floats(dh, dh) +
         2 * (size_t)kStream * row_floats(rows_for(dh), dh) +
         4 * (size_t)kStream;
}

// Bytes of dynamic shared memory of the kernel that runs both roles.
constexpr size_t smem_bytes(int dh) {
  return (dq_floats(dh) > dkv_floats(dh) ? dq_floats(dh) : dkv_floats(dh)) *
         sizeof(float);
}

// D = rowsum(dO ∘ o): one warp a row.
template <int DH, typename T>
__global__ void __launch_bounds__(256)
flash_bwd_dot(const T* __restrict__ o, const T* __restrict__ dout,
              float* __restrict__ D, int rows) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* po = o + (size_t)row * DH;
  const T* pd = dout + (size_t)row * DH;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < DH; c += 32)
    acc = fmaf(widen(pd[c]), widen(po[c]), acc);
  acc = warp_sum(acc);
  if (lane == 0) D[row] = acc;
}

// dQ of query head bh's query tile qt (BQ rows).
template <int DH, typename T>
__device__ __forceinline__ void dq_tile(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ lse,
    const T* __restrict__ dout, const float* __restrict__ D,
    T* __restrict__ dq, int S, int G, float scale, int causal, int bh,
    int qt) {
  constexpr int NT = threads_for(DH), BQ = rows_for(DH), NC = DH / 16;
  constexpr int TILE = kStream * row_floats(DH, DH);  // a K or V tile
  extern __shared__ __align__(16) float smem[];
  float* sQt = smem;                    // DH × BQ
  float* sOt = sQt + DH * BQ;           // DH × BQ
  float* sK = sOt + DH * BQ;            // 2 tiles of kStream × DH
  float* sV = sK + 2 * TILE;            // 2 tiles of kStream × DH
  float* sSt = sV + 2 * TILE;           // kStream × BQ
  float* sL = sSt + kStream * row_floats(BQ, DH);  // BQ
  float* sD = sL + BQ;                  // BQ

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = qt * BQ;
  const int rows = min(BQ, S - q0);
  const size_t qoff = ((size_t)bh * S + q0) * DH;
  const size_t kv_base = (size_t)(bh / G) * S * DH;
  const T* gk = k + kv_base;
  const T* gv = v + kv_base;
  const int n_kv = S / kStream;
  const int kv_end = causal ? min(n_kv, (q0 + rows - 1) / kStream + 1)
                            : n_kv;

  stage_rows<DH, NT>(sK, gk);
  stage_rows<DH, NT>(sV, gv);
  cp_async_commit();
  // q · scale, so s is in natural units and P = 2^((s − lse)·log2 e)
  stage_t<BQ, DH, NT>(sQt, q + qoff, rows, scale);
  stage_t<BQ, DH, NT>(sOt, dout + qoff, rows, 1.f);
  for (int r = tid; r < BQ; r += NT) {
    sL[r] = r < rows ? lse[(size_t)bh * S + q0 + r] : 0.f;
    sD[r] = r < rows ? D[(size_t)bh * S + q0 + r] : 0.f;
  }

  float acc[8][NC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  for (int kj = 0; kj < kv_end; ++kj) {
    const int st = kj & 1;
    cp_async_wait_all();
    __syncthreads();  // tile kj is in; tile kj − 1's stage and dS are free
    if (kj + 1 < kv_end) {
      const size_t off = (size_t)(kj + 1) * kStream * DH;
      stage_rows<DH, NT>(sK + (st ^ 1) * TILE, gk + off);
      stage_rows<DH, NT>(sV + (st ^ 1) * TILE, gv + off);
    }
    cp_async_commit();
    const float* cK = sK + st * TILE;
    const float* cV = sV + st * TILE;

    float s[8][4], dp[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n) s[i][n] = dp[i][n] = 0.f;
    mma_tb<BQ, DH>(s, sQt, cK, ty, tx);
    const bool diag = causal && kj * kStream + kStream - 1 > q0;
    const float4 l0 = ld4(sL + 4 * ty), l1 = ld4(sL + BQ / 2 + 4 * ty);
    const float lv[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = q0 + row_of<BQ>(i, ty);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const bool masked = diag && kj * kStream + tx + 16 * n > row;
        s[i][n] = exp2f(((masked ? kNegInf : s[i][n]) - lv[i]) * kLog2e);
      }
    }
    mma_tb<BQ, DH>(dp, sOt, cV, ty, tx);
    const float4 d0 = ld4(sD + 4 * ty), d1 = ld4(sD + BQ / 2 + 4 * ty);
    const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      float ds[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) ds[i] = s[i][n] * (dp[i][n] - dv[i]);
      put_col<BQ, DH>(sSt, tx + 16 * n, ty, ds);
    }
    __syncthreads();  // dS is whole
    mma_tn<BQ, DH>(acc, sSt, cK, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row_of<BQ>(i, ty);
    if (r >= rows) continue;
    T* out = dq + qoff + (size_t)r * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      narrow(out + 64 * (c >> 2) + 4 * tx + (c & 3), acc[i][c] * scale);
  }
}

// dK and dV of KV head bhkv's key tile kt (BK keys).
template <int DH, typename T>
__device__ __forceinline__ void dkv_tile(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ lse,
    const T* __restrict__ dout, const float* __restrict__ D,
    T* __restrict__ dk, T* __restrict__ dv, int S, int G, float scale,
    int causal, int bhkv, int kt) {
  constexpr int NT = threads_for(DH), BK = rows_for(DH), NC = DH / 16;
  constexpr int TILE = kStream * row_floats(DH, DH);  // a Q or dO tile
  constexpr int PT = kStream * row_floats(BK, DH);    // the P or dS tile
  extern __shared__ __align__(16) float smem[];
  float* sKt = smem;                    // DH × BK
  float* sVt = sKt + DH * BK;           // DH × BK
  float* sQ = sVt + DH * BK;            // 2 tiles of kStream × DH
  float* sO = sQ + 2 * TILE;            // 2 tiles of kStream × DH
  float* sP = sO + 2 * TILE;            // kStream × BK
  float* sS = sP + PT;                  // kStream × BK
  float* sL = sS + PT;                  // 2 × kStream
  float* sD = sL + 2 * kStream;         // 2 × kStream

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = kt * BK;
  const int keys = min(BK, S - k0);
  const size_t koff = ((size_t)bhkv * S + k0) * DH;
  const int nq = S / kStream;
  const int q_first = causal ? k0 / kStream : 0;
  const int per_head = nq - q_first;
  const int steps = G * per_head;

  // step t: query head bhkv·G + t / per_head, q tile q_first + t % per_head
  auto issue = [&](int t, int stage) {
    const int bh = bhkv * G + t / per_head;
    const int q0 = (q_first + t % per_head) * kStream;
    const size_t off = ((size_t)bh * S + q0) * DH;
    stage_rows<DH, NT>(sQ + stage * TILE, q + off);
    stage_rows<DH, NT>(sO + stage * TILE, dout + off);
    stage_vec<NT>(sL + stage * kStream, lse + (size_t)bh * S + q0, 0);
    stage_vec<NT>(sD + stage * kStream, D + (size_t)bh * S + q0, 1);
  };
  issue(0, 0);
  cp_async_commit();
  stage_t<BK, DH, NT>(sKt, k + koff, keys, 1.f);
  stage_t<BK, DH, NT>(sVt, v + koff, keys, 1.f);

  float gk[8][NC], gv[8][NC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) gk[i][c] = gv[i][c] = 0.f;

  for (int t = 0; t < steps; ++t) {
    const int st = t & 1;
    cp_async_wait_all();
    __syncthreads();  // step t is in; step t − 1's stage, P and dS are free
    if (t + 1 < steps) issue(t + 1, st ^ 1);
    cp_async_commit();
    const float* cQ = sQ + st * TILE;
    const float* cO = sO + st * TILE;
    const float* cL = sL + st * kStream;
    const float* cD = sD + st * kStream;
    const int q0 = (q_first + t % per_head) * kStream;

    // Sᵀ, then dPᵀ (keys on the row side, the q tile's rows tx + 16n on
    // the other), with dS from this thread's own P read back (no barrier
    // needed), so S's registers are free during dPᵀ;
    // P = 2^((s·scale − lse)·log2 e), s·scale − lse rounded once
    const bool diag = causal && k0 + BK - 1 > q0;
    float s[8][4], dp[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n) s[i][n] = dp[i][n] = 0.f;
    mma_tb<BK, DH>(s, sKt, cQ, ty, tx);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int j = tx + 16 * n;
      const float lr = cL[j];
      float p[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const bool masked = diag && k0 + row_of<BK>(i, ty) > q0 + j;
        p[i] = exp2f((masked ? kNegInf : fmaf(s[i][n], scale, -lr)) *
                     kLog2e);
      }
      put_col<BK, DH>(sP, j, ty, p);
    }
    mma_tb<BK, DH>(dp, sVt, cO, ty, tx);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int j = tx + 16 * n;
      const float dr = cD[j];
      const float4 p0 = ld4(sP + sw<BK, DH>(j, 4 * ty));
      const float4 p1 = ld4(sP + sw<BK, DH>(j, BK / 2 + 4 * ty));
      const float ds[8] = {
          p0.x * (dp[0][n] - dr), p0.y * (dp[1][n] - dr),
          p0.z * (dp[2][n] - dr), p0.w * (dp[3][n] - dr),
          p1.x * (dp[4][n] - dr), p1.y * (dp[5][n] - dr),
          p1.z * (dp[6][n] - dr), p1.w * (dp[7][n] - dr)};
      put_col<BK, DH>(sS, j, ty, ds);
    }
    __syncthreads();  // P and dS are whole
    mma_tn<BK, DH>(gv, sP, cO, ty, tx);
    mma_tn<BK, DH>(gk, sS, cQ, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row_of<BK>(i, ty);
    if (r >= keys) continue;
    T* ok = dk + koff + (size_t)r * DH;
    T* ov = dv + koff + (size_t)r * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 64 * (c >> 2) + 4 * tx + (c & 3);
      narrow(ok + col, gk[i][c] * scale);
      narrow(ov + col, gv[i][c]);
    }
  }
}

// The two roles as one grid: blocks [0, n_dkv) take (KV head, key
// tile) for dK and dV, key tile 0 (the longest walk) first; the rest take
// (query head, query tile) for dQ, the last (longest) query tiles first.
// The scheduler hands out blocks in that order as SMs free up, so dQ's
// short CTAs fill in behind dK/dV's long ones.
template <int DH, typename T>
__global__ void __launch_bounds__(DH == 64 ? 256 : 128, 1)
flash_bwd_f32(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ lse,
              const T* __restrict__ dout, const float* __restrict__ D,
              T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
              int S, int BH, int BHkv, float scale, int causal) {
  const int tiles = (S + rows_for(DH) - 1) / rows_for(DH);
  const int n_dkv = BHkv * tiles;
  const int b = blockIdx.x;
  if (b < n_dkv)
    dkv_tile<DH, T>(q, k, v, lse, dout, D, dk, dv, S, BH / BHkv, scale,
                    causal, b % BHkv, b / BHkv);
  else
    dq_tile<DH, T>(q, k, v, lse, dout, D, dq, S, BH / BHkv, scale, causal,
                   (b - n_dkv) % BH, tiles - 1 - (b - n_dkv) / BH);
}

template <int DH, typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, float* D, void* dq, void* dk,
           void* dv, int BH, int BHkv, int S, float scale, int causal,
           cudaStream_t stream) {
  static unsigned done = 0;
  const T* tdo = static_cast<const T*>(dout);
  const int rows = BH * S;
  flash_bwd_dot<DH, T><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const T*>(o), tdo, D, rows);
  int e = (int)cudaGetLastError();
  if (e) return e;
  auto kern = flash_bwd_f32<DH, T>;
  const size_t smem = smem_bytes(DH);
  if ((e = opt_in(kern, smem, &done))) return e;
  const int tiles = (S + rows_for(DH) - 1) / rows_for(DH);
  kern<<<(BH + BHkv) * tiles, threads_for(DH), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lse, tdo, D, static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), S, BH, BHkv, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// S must be a multiple of this (the streamed tiles; a query or key tile
// past S is masked).
int flash_attn_bwd_tile() { return kStream; }

// Dynamic shared memory of the tiled kernel at head dimension dh (bytes):
// the larger of its two roles'.
size_t flash_attn_bwd_smem_bytes(int dh) { return smem_bytes(dh); }

// The tiled kernel's launch plan at (dh, S, BH, BHkv): out[0..5] =
// threads, rows of a kept tile (query rows of dQ, keys of dK/dV), dynamic
// shared memory (bytes), dK/dV CTAs, dQ CTAs (the grid is both, dK/dV
// first) and resident CTAs a SM on the current card (f32).  Returns a
// CUDA error code (0 on success).
int flash_attn_bwd_plan(int dh, int S, int BH, int BHkv, int* out) {
  if ((dh != 64 && dh != 128) || S <= 0 || S % kStream || BHkv <= 0 ||
      BH % BHkv)
    return (int)cudaErrorInvalidValue;
  static unsigned d64 = 0, d128 = 0;
  const int R = rows_for(dh), NT = threads_for(dh);
  const size_t smem = smem_bytes(dh);
  const int occ =
      dh == 64 ? occupancy(flash_bwd_f32<64, float>, NT, smem, &d64)
               : occupancy(flash_bwd_f32<128, float>, NT, smem, &d128);
  const int tiles = (S + R - 1) / R;
  const int plan[6] = {NT, R, (int)smem, BHkv * tiles, BH * tiles, occ};
  for (int i = 0; i < 6; ++i) out[i] = plan[i];
  return occ < 0 ? (int)cudaErrorInvalidValue : 0;
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
  if (BHkv <= 0 || BH % BHkv != 0 || S % kStream != 0)
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

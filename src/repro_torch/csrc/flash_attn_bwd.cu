// Flash-attention backward for Hopper (sm_90a): bf16 on the tensor cores
// (wgmma fed by TMA), f32 on the CUDA cores.
//
// Replaces the backward of the flash op in
// src/repro/kernels/flash_attn/ops.py: _bwd (ops.py:58), the custom VJP
// registered on flash_attention (ops.py:136).  In the reference it is pure
// JAX, two tile-recompute passes; it has no pallas_call of its own.
//
// What it computes, from the forward's residuals q (BH, S, dh), k, v
// (BHkv, S, dh), o (BH, S, dh), lse (BH, S) f32 and the incoming dO
// (BH, S, dh), BH = BHkv·G, query head bh reading KV head bh / G, in f32:
//   qs = q · scale, scale = 1/√dh;  s = qs kᵀ;  causal: s = -1e30 where
//   key j > query i;  P = exp(s − lse)  (masked entries underflow to 0);
//   D = rowsum(dO ∘ o);  dP = dO vᵀ;  dS = P ∘ (dP − D);
//   dQ = dS k · scale;  dK = Σ_group dSᵀ qs;  dV = Σ_group Pᵀ dO;
// outputs in the inputs' type (round to nearest even for bf16).  The
// forward's own lse is used, never recomputed.  Both designs are
// deterministic, without atomics: every output is the same sum in the same
// order on every call, so the backward is bitwise repeatable.  Both run
// D = rowsum(dO ∘ o) first, a warp a row, into an f32 scratch (BH, S) that
// the wrapper allocates (flash_bwd_dot): its own pass, since the dK/dV
// role needs D of every query row it visits from its first step.  Both
// run two roles in one grid: its first BHkv·tiles CTAs compute dK and dV
// of a (KV head, key tile), key tile 0 (the longest walk) first; the other
// BH·tiles compute dQ of a (query head, query tile), the last (longest)
// query tiles first.  The scheduler hands the CTAs out in that order as
// SMs free up, so the short dQ CTAs fill in behind the long dK/dV ones.
// The group's sum of dK and dV never leaves its CTA.  S must be a multiple
// of 64 (the wrapper checks); masked tiles above the diagonal are skipped.
//
// bf16 design (flash_bwd_tc).  What bounds it: at grok-1's train step
// (B=4, S=512, H=48, Hkv=8, dh=128, causal) the five products take 32.28
// GFLOP, 0.033 ms at the bf16 tensor-core peak (989 TFLOP/s); the bytes
// (q, o, dO, dq at 25.2 MB each, k, v, dk, dv at 4.2 MB each, lse) are
// ~118 MB, 0.035 ms at 3.35 TB/s: the function is bound by bytes, barely.
// The kernel executes 10 products' worth (S and dP in both roles, and
// dV, dK, dQ twice, the split below): ~65 GFLOP at that shape.  With 128
// dK/dV CTAs, key tile 0's walks 6 heads × 512 query rows (~0.6 GFLOP),
// 0.08 ms at one SM's share of the peak: that CTA, not the function's
// bound, sets the least time of this design.
// - A CTA is two consumer warpgroups of 64 kept rows each (keys in the
//   dK/dV role, query rows in dQ) and a producer warpgroup whose one thread
//   issues every TMA load (setmaxnreg: producer 40 registers, consumers
//   232).  A 64-row tail past S leaves the second consumer idle.
// - Kept tiles (K and V, or Q and dO) are loaded once; streamed tiles of 64
//   rows (Q and dO with their rows' lse and D, or K and V) come through a
//   3-stage ring with full and empty mbarriers, as the forward's K and V.
//   Tensor maps are 3-d (dh, S, heads), 64 × 64 boxes in the 128-byte
//   swizzle; lse and D by 256-byte bulk copies.  166,456 B of shared
//   memory at dh = 128, 84,536 B at dh = 64: one CTA a SM.
// - dK/dV role: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ are wgmma m64n64k16 (bf16 ×
//   bf16 → f32, both operands K-major in shared memory).  A product of two
//   bf16 values is exact in f32, so scaling the f32 scores after the
//   product (Q stays unscaled bf16) differs from the reference's
//   scale-before by f32 roundings.  Pᵀ = 2^((sᵀ·scale − lse)·log2 e), the
//   difference rounded once in natural units, and dSᵀ = Pᵀ ∘ (dPᵀ − D) stay
//   in f32 registers; lse and D of the fragment's query columns come from
//   the stage's shared memory.  dV += Pᵀ·dO and dK += dSᵀ·Q take Pᵀ and
//   dSᵀ from registers as the A operand (wgmma's accumulator fragment is,
//   pair by pair, its A fragment) and dO and Q from shared memory,
//   MN-major, as the forward's P·V takes V.  dV's product runs while dSᵀ
//   is split.
// - The split: Pᵀ, dSᵀ (and dS in the dQ role) go into the products as
//   bf16 hi = bf16(x) and lo = bf16(x − hi), two wgmmas a 16-row step into
//   one f32 accumulator: x to ~16 significant bits, the reference's f32
//   values within f32 tolerance, where one bf16 rounding is not
//   (tests/test_torch_flash_attn.py's model of this arithmetic).
// - dQ role: S = Q·Kᵀ, dP = dO·Vᵀ, dS in registers with the row's lse and D
//   (loaded once), dQ += dS·K with K MN-major: the forward's P·V pattern.
// - Causal: a consumer skips a streamed tile whose every key lies past
//   every query (it still takes and gives back the stage), and masks P to 0
//   in the diagonal tile.
// - Outputs: dK·scale, dV, dQ·scale rounded to nearest-even bf16, staged in
//   the consumer's own kept panels in the swizzle TMA reads, stored by TMA.
//
// f32 design (flash_bwd_f32): the CUDA cores.  What bounds it: at
// smollm-135m's training shape (B=8, H=9, Hkv=3, S=1024, dh=64, causal,
// f32) the five products S, dP, dV, dQ and dK take 2·S²·dh each, halved
// by the mask, over 72 query heads: 24.2 GFLOP, 0.36 ms at the f32 peak of
// 67 TFLOP/s.  The bytes (q, o, dO, dq at 18.9 MB each, k, v, dk, dv at
// 6.3 MB each, lse) are ~101 MB, 0.03 ms at 3.35 TB/s.  So the function is
// bound by operations, on the CUDA cores: TF32 would round q, k, v and dO
// to 10 mantissa bits, and no kernel of the port uses it.
// - Seven products (S and dP are computed for dQ and again for dK and dV:
//   38.1 GFLOP executed at the training shape, with the diagonal tiles'
//   masked parts, for the 24.2 the bound counts).  The five-product
//   alternative, S and dP once with dQ accumulated across key tiles in a
//   fixed order, was not built: its dQ partial products do not fit the
//   dK/dV role's registers at dh = 128 (249 a thread already).
// - At the training shape 192 + 576 CTAs, 5.8 waves over 132 SMs at one
//   CTA a SM, where two grids left the dK/dV grid's last of 1.5 waves on a
//   few SMs.
// - Both roles are register-blocked (csrc/flash_f32.cuh: each thread an
//   8 × 4 patch of S and dP and an 8 × dh/16 patch of its gradients,
//   16-byte shared loads, 8 or more FFMAs a shared-memory wavefront) and
//   stream their tiles through a 2-stage cp.async ring, one barrier for the
//   ring and one for P and dS a tile.  P = exp(s − lse) is taken as
//   2^((s − lse)·log2 e): s − lse is rounded once in natural units, as the
//   plain version's is, and only the small difference is scaled
//   (2^(s·log2 e − lse·log2 e) would round two terms of ~30 at a peaked
//   softmax).  256 threads and 128-row kept tiles at dh = 64, 128 and 64
//   at dh = 128 (what fits 227 KB of shared memory).
// - dQ: Q (times scale) and dO stay in shared memory, transposed;
//   the CTA walks the 64-key tiles of K and V up to the diagonal: S and dP
//   in registers, P and dS in registers, dS once through shared memory
//   (transposed), dQ += dS·K in registers.
// - dK, dV: K and V stay in shared memory, transposed; the CTA walks the
//   G query heads of its group and, for each, the 64-row q tiles from the
//   diagonal down, streaming Q, dO, lse and D: Sᵀ and dPᵀ in registers, P
//   and dS once through shared memory, dV += Pᵀ dO and dK += dSᵀ q in
//   registers.
// - Shared memory: 203,776 B at dh = 64 and 230,400 B at dh = 128 (the
//   dK/dV role's; dQ's 169,984 and 213,504).
// - Inside a diagonal tile the mask sets s to -1e30 and exp(-1e30 − lse)
//   is exactly 0.  A query or key tile past S (S a multiple of 64, not of
//   the tile) is zero in shared memory and never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "flash_f32.cuh"
#include "hopper_tc.cuh"

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
template <int DH>
__device__ __forceinline__ void dq_tile(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ lse,
    const float* __restrict__ dout, const float* __restrict__ D,
    float* __restrict__ dq, int S, int G, float scale, int causal, int bh,
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
  const float* gk = k + kv_base;
  const float* gv = v + kv_base;
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
    float* out = dq + qoff + (size_t)r * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      out[64 * (c >> 2) + 4 * tx + (c & 3)] = acc[i][c] * scale;
  }
}

// dK and dV of KV head bhkv's key tile kt (BK keys).
template <int DH>
__device__ __forceinline__ void dkv_tile(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ lse,
    const float* __restrict__ dout, const float* __restrict__ D,
    float* __restrict__ dk, float* __restrict__ dv, int S, int G, float scale,
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
    float* ok = dk + koff + (size_t)r * DH;
    float* ov = dv + koff + (size_t)r * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 64 * (c >> 2) + 4 * tx + (c & 3);
      ok[col] = gk[i][c] * scale;
      ov[col] = gv[i][c];
    }
  }
}

// The two roles as one grid: blocks [0, n_dkv) take (KV head, key
// tile) for dK and dV, key tile 0 (the longest walk) first; the rest take
// (query head, query tile) for dQ, the last (longest) query tiles first.
// The scheduler hands out blocks in that order as SMs free up, so dQ's
// short CTAs fill in behind dK/dV's long ones.
template <int DH>
__global__ void __launch_bounds__(DH == 64 ? 256 : 128, 1)
flash_bwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ lse,
              const float* __restrict__ dout, const float* __restrict__ D,
              float* __restrict__ dq, float* __restrict__ dk,
              float* __restrict__ dv,
              int S, int BH, int BHkv, float scale, int causal) {
  const int tiles = (S + rows_for(DH) - 1) / rows_for(DH);
  const int n_dkv = BHkv * tiles;
  const int b = blockIdx.x;
  if (b < n_dkv)
    dkv_tile<DH>(q, k, v, lse, dout, D, dk, dv, S, BH / BHkv, scale,
                    causal, b % BHkv, b / BHkv);
  else
    dq_tile<DH>(q, k, v, lse, dout, D, dq, S, BH / BHkv, scale, causal,
                   (b - n_dkv) % BH, tiles - 1 - (b - n_dkv) / BH);
}

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, const void* o,
               const float* lse, const void* dout, float* D, void* dq,
               void* dk, void* dv, int BH, int BHkv, int S, float scale,
               int causal, cudaStream_t stream) {
  static unsigned done = 0;
  const float* tdo = static_cast<const float*>(dout);
  const int rows = BH * S;
  flash_bwd_dot<DH, float><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const float*>(o), tdo, D, rows);
  int e = (int)cudaGetLastError();
  if (e) return e;
  auto kern = flash_bwd_f32<DH>;
  const size_t smem = smem_bytes(DH);
  if ((e = opt_in(kern, smem, &done))) return e;
  const int tiles = (S + rows_for(DH) - 1) / rows_for(DH);
  kern<<<(BH + BHkv) * tiles, threads_for(DH), smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), lse, tdo, D, static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv), S, BH, BHkv, scale,
      causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: wgmma and TMA
// ---------------------------------------------------------------------------

constexpr int kTcRows = 64;       // rows of a consumer's kept tile and of
                                  // a streamed tile
constexpr int kTcConsumers = 2;   // consumer warpgroups per CTA
constexpr int kTcKept = kTcRows * kTcConsumers;   // rows a CTA keeps
constexpr int kTcStages = 3;      // depth of the streamed tiles' ring
constexpr int kTcThreads = 128 * (kTcConsumers + 1);
constexpr uint32_t kBox = kTcRows * 128;          // bytes of a 64-row panel
constexpr uint32_t kVecBytes = 2 * kTcRows * 4;   // lse and D of a tile

// Dynamic shared memory of one bf16 CTA (bytes), for either role: the kept
// tiles A and B [consumer] (K and V in dK/dV, Q and dO in dQ), the
// streamed tiles X and Y [stage] (Q and dO in dK/dV, K and V in dQ), each
// 64 rows of dh / 64 panels 1024-byte aligned for the 128-byte swizzle;
// lse and D of each stage's query rows (dK/dV); the mbarriers (kept_full,
// full[stages], empty[stages]); 1 KB to align the base.
template <int DH>
struct TcSmem {
  static constexpr int kPanels = DH / kPanel;
  static constexpr uint32_t tile = kPanels * kBox;
  static constexpr uint32_t a = 0;
  static constexpr uint32_t b = a + kTcConsumers * tile;
  static constexpr uint32_t x = b + kTcConsumers * tile;
  static constexpr uint32_t y = x + kTcStages * tile;
  static constexpr uint32_t vec = y + kTcStages * tile;
  static constexpr uint32_t bar = vec + kTcStages * kVecBytes;
  static constexpr uint32_t bytes = bar + 8 * (1 + 2 * kTcStages) + 1024;
};

// s (64 × 64 f32) = A·Xᵀ over dh: A a kept tile's panels at sa (64 rows),
// X a streamed tile's at sx (64 rows), both K-major; 16 columns of dh per
// wgmma, the descriptor advancing 32 bytes within a panel.  No commit.
template <int DH>
__device__ __forceinline__ void issue_ss(float (&s)[32], uint32_t sa,
                                         uint32_t sx) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
    const uint64_t da = smem_desc(sa + off, 16);
    const uint64_t db = smem_desc(sx + off, 16);
    if (kk == 0)
      wgmma_qk_first(s, da, db);
    else
      wgmma_qk(s, da, db);
  }
}

// acc (64 × dh f32) += (hi + lo) · Y: the 64 × 64 A operand in two bf16
// halves from registers, Y the streamed tile at sy read MN-major (its 64
// rows are the product's depth), 16 rows per wgmma; one commit group.
template <int N>
__device__ __forceinline__ void issue_rs(float (&acc)[N],
                                         const uint32_t (&hi)[4][4],
                                         const uint32_t (&lo)[4][4],
                                         uint32_t sy) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint64_t db = smem_desc(sy + j * 2048, kBox);
    wgmma_pv(acc, hi[j], db);
    wgmma_pv(acc, lo[j], db);
  }
  wgmma_commit();
}

// acc · mul (a consumer's 64 rows × DH, wgmma's fragment) rounded to
// nearest-even bf16 into the panels at sp, in the swizzle TMA reads.
template <int DH>
__device__ __forceinline__ void stage_out(const float (&acc)[DH / 2],
                                          float mul, uint32_t sp, int lrow,
                                          int col) {
#pragma unroll
  for (int i = 0; i < DH / 2; i += 2) {
    const int row = lrow + 8 * ((i / 2) % 2);
    const int cc = (i / 4) * 8 + col;
    const uint32_t at = sp + (cc / kPanel) * kBox + row * 128 +
                        ((((cc % kPanel) / 8) ^ (row % 8)) * 16) +
                        (cc % 8) * 2;
    asm volatile("st.shared.b32 [%0], %1;" ::"r"(at),
                 "r"(bf16x2_bits(__floats2bfloat162_rn(acc[i] * mul,
                                                       acc[i + 1] * mul)))
                 : "memory");
  }
}

// Hand the consumer's staged panels (sp0, and sp1 unless 0) to TMA:
// rows first.. of `head` in the maps m0 and m1.
template <int DH>
__device__ __forceinline__ void store_out(const CUtensorMap* m0, uint32_t sp0,
                                          const CUtensorMap* m1, uint32_t sp1,
                                          int first, int head, int wg,
                                          int t) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
  if (t == 0) {
    for (int h = 0; h < DH / kPanel; ++h) {
      tma_store(m0, sp0 + h * kBox, h * kPanel, first, head);
      if (sp1) tma_store(m1, sp1 + h * kBox, h * kPanel, first, head);
    }
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    // shared memory must outlive the store's reads
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

// A consumer's view of the ring: its full and empty barriers, stage and
// phase.
struct Ring {
  uint32_t full0, empty0;
  int stage = 0;
  uint32_t phase = 0;
  __device__ void wait() const { mbar_wait(full0 + 8 * stage, phase); }
  __device__ void release() {
    mbar_arrive(empty0 + 8 * stage);
    if (++stage == kTcStages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// dK and dV of the consumer's 64 keys k0.. of KV head `head`: the walk's
// `steps` query tiles (tile first_t + t % per_head of query head
// head·G + t / per_head), Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (K, V kept, Q, dO
// streamed), Pᵀ and dSᵀ in registers with lse and D of the tile's queries
// from shared memory, dV += Pᵀ·dO and dK += dSᵀ·Q on the split.
template <int DH>
__device__ __forceinline__ void dkv_consumer(
    const CUtensorMap* tdk, const CUtensorMap* tdv, uint32_t base,
    const float* svec, uint32_t kept_full, Ring ring, int head, int k0,
    int wg, int first_t, int per_head, int steps, float scale, int causal) {
  using L = TcSmem<DH>;
  const int t = threadIdx.x % 128, lane = t % 32;
  const int lrow = (t / 32) * 16 + lane / 4;  // and lrow + 8, of 64 keys
  const int col = (lane % 4) * 2;  // + 8·(i / 4) + (i % 2) of 64 queries
  const uint32_t sa = base + L::a + wg * L::tile;
  const uint32_t sb = base + L::b + wg * L::tile;
  float dk[DH / 2], dv[DH / 2];   // columns 8·(i / 4) + col + (i % 2)
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(kept_full, 0);
  for (int st = 0; st < steps; ++st) {
    const int q0 = (first_t + st % per_head) * kTcRows;
    ring.wait();
    // a causal tile with every key past every query adds nothing
    if (!causal || q0 + kTcRows - 1 >= k0) {
      const uint32_t sx = base + L::x + ring.stage * L::tile;
      const uint32_t sy = base + L::y + ring.stage * L::tile;
      const float* vl = svec + ring.stage * 2 * kTcRows;  // lse, then D
      float s[32], dp[32];
      wgmma_fence();
      issue_ss<DH>(s, sa, sx);
      issue_ss<DH>(dp, sb, sy);
      wgmma_commit();
      wgmma_wait<0>();
      pin(s);
      pin(dp);
      // P = exp(s·scale − lse) as 2^((s·scale − lse)·log2 e), the
      // difference rounded once; 0 where key > query
      const bool diag = causal && q0 < k0 + kTcRows - 1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(vl + 8 * j + col);
        const float2 d2 =
            *reinterpret_cast<const float2*>(vl + kTcRows + 8 * j + col);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = 4 * j + u;
          float p = exp2_approx(fmaf(s[i], scale, -(u % 2 ? l2.y : l2.x)) *
                                kLog2e);
          if (diag && k0 + lrow + 8 * (u / 2) > q0 + 8 * j + col + u % 2)
            p = 0.f;
          s[i] = p;
          dp[i] = p * (dp[i] - (u % 2 ? d2.y : d2.x));
        }
      }
      uint32_t phi[4][4], plo[4][4], shi[4][4], slo[4][4];
      split_p(s, phi, plo);
      pin(dv);
      pin(phi);
      pin(plo);
      wgmma_fence();
      issue_rs(dv, phi, plo, sy);   // dV += Pᵀ·dO, while dS is split
      split_p(dp, shi, slo);
      pin(dk);
      pin(shi);
      pin(slo);
      wgmma_fence();
      issue_rs(dk, shi, slo, sx);   // dK += dSᵀ·Q
      wgmma_wait<0>();
      pin(dv);
      pin(dk);
      pin(phi);
      pin(plo);
      pin(shi);
      pin(slo);
    }
    ring.release();
  }
  // dK·scale and dV in bf16, staged in this consumer's K and V panels (no
  // longer read) and stored by TMA
  stage_out<DH>(dk, scale, sa, lrow, col);
  stage_out<DH>(dv, 1.f, sb, lrow, col);
  store_out<DH>(tdk, sa, tdv, sb, k0, head, wg, t);
}

// dQ of the consumer's 64 query rows q0.. of query head `head`: the
// `steps` key tiles of its KV head from the first, S = Q·Kᵀ and
// dP = dO·Vᵀ (Q, dO kept, K, V streamed), dS in registers with the rows'
// lse and D, dQ += dS·K on the split.
template <int DH>
__device__ __forceinline__ void dq_consumer(
    const CUtensorMap* tdq, const float* __restrict__ lse,
    const float* __restrict__ D, uint32_t base, uint32_t kept_full,
    Ring ring, int head, int q0, int wg, int S, int steps, float scale,
    int causal) {
  using L = TcSmem<DH>;
  const int t = threadIdx.x % 128, lane = t % 32;
  const int lrow = (t / 32) * 16 + lane / 4;  // and lrow + 8, of 64 rows
  const int col = (lane % 4) * 2;  // + 8·(i / 4) + (i % 2) of 64 keys
  const int row0 = q0 + lrow;
  const uint32_t sa = base + L::a + wg * L::tile;
  const uint32_t sb = base + L::b + wg * L::tile;
  const size_t at = (size_t)head * S + row0;
  const float l[2] = {lse[at], lse[at + 8]}, d[2] = {D[at], D[at + 8]};
  float acc[DH / 2];   // columns 8·(i / 4) + col + (i % 2)
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;

  mbar_wait(kept_full, 0);
  for (int kj = 0; kj < steps; ++kj) {
    const int k0 = kj * kTcRows;
    ring.wait();
    if (!causal || k0 <= q0 + kTcRows - 1) {
      const uint32_t sx = base + L::x + ring.stage * L::tile;
      const uint32_t sy = base + L::y + ring.stage * L::tile;
      float s[32], dp[32];
      wgmma_fence();
      issue_ss<DH>(s, sa, sx);
      issue_ss<DH>(dp, sb, sy);
      wgmma_commit();
      wgmma_wait<0>();
      pin(s);
      pin(dp);
      const bool diag = causal && k0 + kTcRows - 1 > q0;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i / 2) % 2;
        float p = exp2_approx(fmaf(s[i], scale, -l[r]) * kLog2e);
        if (diag && k0 + 8 * (i / 4) + col + i % 2 > row0 + 8 * r) p = 0.f;
        dp[i] = p * (dp[i] - d[r]);
      }
      uint32_t hi[4][4], lo[4][4];
      split_p(dp, hi, lo);
      pin(acc);
      pin(hi);
      pin(lo);
      wgmma_fence();
      issue_rs(acc, hi, lo, sx);   // dQ += dS·K
      wgmma_wait<0>();
      pin(acc);
      pin(hi);
      pin(lo);
    }
    ring.release();
  }
  // dQ·scale in bf16, staged in this consumer's Q panels, stored by TMA
  stage_out<DH>(acc, scale, sa, lrow, col);
  store_out<DH>(tdq, sa, nullptr, 0, q0, head, wg, t);
}

// The two roles as one grid, as the f32 kernel's: blocks [0, n_dkv) take
// (KV head, 128-key tile) for dK and dV, key tile 0 (the longest walk)
// first; the rest take (query head, 128-row tile) for dQ, the last
// (longest) query tiles first.  Warpgroup 2 is the producer, whose one
// thread issues every TMA load; warpgroups 0 and 1 are consumers of 64
// kept rows each.
template <int DH>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_tc(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const __grid_constant__ CUtensorMap tdo,
             const __grid_constant__ CUtensorMap tdq,
             const __grid_constant__ CUtensorMap tdk,
             const __grid_constant__ CUtensorMap tdv,
             const float* __restrict__ lse, const float* __restrict__ D,
             int S, int BH, int BHkv, float scale, int causal) {
  using L = TcSmem<DH>;
  constexpr int P = L::kPanels;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const float* svec =
      reinterpret_cast<const float*>(smem_raw + (base - raw) + L::vec);
  const uint32_t kept_full = base + L::bar;
  const uint32_t full0 = kept_full + 8, empty0 = full0 + 8 * kTcStages;

  const int G = BH / BHkv;
  const int tiles = (S + kTcKept - 1) / kTcKept;
  const int n_dkv = BHkv * tiles;
  const bool dkv = blockIdx.x < n_dkv;
  const int b = dkv ? blockIdx.x : blockIdx.x - n_dkv;
  const int head = dkv ? b % BHkv : b % BH;
  const int r0 = (dkv ? b / BHkv : tiles - 1 - b / BH) * kTcKept;
  const int active = min(kTcConsumers, (S - r0) / kTcRows);
  // the walk over streamed tiles: dK/dV the G query heads of the group,
  // each from the diagonal down; dQ the key tiles up to the diagonal
  const int nt = S / kTcRows;
  const int first_t = dkv && causal ? r0 / kTcRows : 0;
  const int per_head = nt - first_t;
  const int steps = dkv ? G * per_head
                        : causal ? (r0 + active * kTcRows - 1) / kTcRows + 1
                                 : nt;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kept_full, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 128 * active);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kTcConsumers) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x != kTcConsumers * 128) return;
    const CUtensorMap* ma = dkv ? &tk : &tq;
    const CUtensorMap* mb = dkv ? &tv : &tdo;
    const CUtensorMap* mx = dkv ? &tq : &tk;
    const CUtensorMap* my = dkv ? &tdo : &tv;
    mbar_expect_tx(kept_full, active * 2 * L::tile);
    for (int c = 0; c < active; ++c)
      for (int h = 0; h < P; ++h) {
        const uint32_t off = c * L::tile + h * kBox;
        tma_load(base + L::a + off, ma, kept_full, h * kPanel,
                 r0 + c * kTcRows, head);
        tma_load(base + L::b + off, mb, kept_full, h * kPanel,
                 r0 + c * kTcRows, head);
      }
    int stage = 0;
    uint32_t phase = 0;
    for (int t = 0; t < steps; ++t) {
      const int sh = dkv ? head * G + t / per_head : head / G;
      const int row = (dkv ? first_t + t % per_head : t) * kTcRows;
      mbar_wait(empty0 + 8 * stage, phase ^ 1);
      const uint32_t full = full0 + 8 * stage;
      mbar_expect_tx(full, 2 * L::tile + (dkv ? kVecBytes : 0));
      for (int h = 0; h < P; ++h) {
        const uint32_t off = stage * L::tile + h * kBox;
        tma_load(base + L::x + off, mx, full, h * kPanel, row, sh);
        tma_load(base + L::y + off, my, full, h * kPanel, row, sh);
      }
      if (dkv) {
        const size_t at = (size_t)sh * S + row;
        const uint32_t sv = base + L::vec + stage * kVecBytes;
        bulk_load(sv, lse + at, kVecBytes / 2, full);
        bulk_load(sv + kVecBytes / 2, D + at, kVecBytes / 2, full);
      }
      if (++stage == kTcStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    if (wg >= active) return;
    const Ring ring{full0, empty0};
    if (dkv)
      dkv_consumer<DH>(&tdk, &tdv, base, svec, kept_full, ring, head,
                       r0 + wg * kTcRows, wg, first_t, per_head, steps,
                       scale, causal);
    else
      dq_consumer<DH>(&tdq, lse, D, base, kept_full, ring, head,
                      r0 + wg * kTcRows, wg, S, steps, scale, causal);
  }
}

template <int DH>
int launch_tc(const void* q, const void* k, const void* v, const void* o,
              const float* lse, const void* dout, float* D, void* dq,
              void* dk, void* dv, int BH, int BHkv, int S, float scale,
              int causal, cudaStream_t stream) {
  // lse and D are read by 16-byte bulk copies
  if ((uintptr_t)lse % 16 || (uintptr_t)D % 16)
    return (int)cudaErrorMisalignedAddress;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  CUtensorMap tq, tk, tv, tdo, tdq, tdk, tdv;
  int err = encode(fn, &tq, q, BH, S, DH, kTcRows);
  if (!err) err = encode(fn, &tk, k, BHkv, S, DH, kTcRows);
  if (!err) err = encode(fn, &tv, v, BHkv, S, DH, kTcRows);
  if (!err) err = encode(fn, &tdo, dout, BH, S, DH, kTcRows);
  if (!err) err = encode(fn, &tdq, dq, BH, S, DH, kTcRows);
  if (!err) err = encode(fn, &tdk, dk, BHkv, S, DH, kTcRows);
  if (!err) err = encode(fn, &tdv, dv, BHkv, S, DH, kTcRows);
  if (err) return err;
  static unsigned done = 0;
  auto kern = flash_bwd_tc<DH>;
  const size_t smem = TcSmem<DH>::bytes;
  if ((err = opt_in(kern, smem, &done))) return err;
  const int rows = BH * S;
  flash_bwd_dot<DH, __nv_bfloat16><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), D, rows);
  if ((err = (int)cudaGetLastError())) return err;
  const int tiles = (S + kTcKept - 1) / kTcKept;
  kern<<<(BH + BHkv) * tiles, kTcThreads, smem, stream>>>(
      tq, tk, tv, tdo, tdq, tdk, tdv, lse, D, S, BH, BHkv, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// S must be a multiple of this (the streamed tiles; a kept tile past S is
// masked).
int flash_attn_bwd_tile() { return kStream; }

// Dynamic shared memory one CTA needs at head dimension dh (bytes), the
// larger of the two kernels'.
size_t flash_attn_bwd_smem_bytes(int dh) {
  const size_t tc = dh == 64    ? TcSmem<64>::bytes
                    : dh == 128 ? TcSmem<128>::bytes
                                : 0;
  return smem_bytes(dh) > tc ? smem_bytes(dh) : tc;
}

// Dynamic shared memory of the bf16 kernel at head dimension dh (bytes),
// or 0 for another dh.
size_t flash_attn_bwd_tc_smem_bytes(int dh) {
  return dh == 64 ? TcSmem<64>::bytes : dh == 128 ? TcSmem<128>::bytes : 0;
}

// The f32 kernel's launch plan at (dh, S, BH, BHkv): out[0..5] =
// threads, rows of a kept tile (query rows of dQ, keys of dK/dV), dynamic
// shared memory (bytes), dK/dV CTAs, dQ CTAs (the grid is both, dK/dV
// first) and resident CTAs a SM on the current card.  Returns a CUDA
// error code (0 on success).
int flash_attn_bwd_plan(int dh, int S, int BH, int BHkv, int* out) {
  if ((dh != 64 && dh != 128) || S <= 0 || S % kStream || BHkv <= 0 ||
      BH % BHkv)
    return (int)cudaErrorInvalidValue;
  static unsigned d64 = 0, d128 = 0;
  const int R = rows_for(dh), NT = threads_for(dh);
  const size_t smem = smem_bytes(dh);
  const int occ = dh == 64 ? occupancy(flash_bwd_f32<64>, NT, smem, &d64)
                           : occupancy(flash_bwd_f32<128>, NT, smem, &d128);
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
  return tc_error_string(err);
}

// dq (BH, S, dh), dk and dv (BHkv, S, dh) from q, o, dout (BH, S, dh),
// k, v (BHkv, S, dh) and lse (BH, S) f32; D is an f32 scratch of (BH, S).
// bf16 != 0 for bfloat16 tensors (tensor cores; lse and D 16-byte
// aligned), else float32 (CUDA cores).
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
    return bf16 ? launch_tc<64>(FLASH_BWD_ARGS) : launch_f32<64>(FLASH_BWD_ARGS);
  if (dh == 128)
    return bf16 ? launch_tc<128>(FLASH_BWD_ARGS)
                : launch_f32<128>(FLASH_BWD_ARGS);
#undef FLASH_BWD_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

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
// device memory bounds a full fleet launch.  But the dump loop launches
// gram_power over a few hundred streams (2-3 a SM) and the step over a few
// dozen (most SMs idle), so what a launch costs is the latency of one CTA
// (its copies, its Gram and its 25 dependent power steps) and, at a few
// hundred streams, the SM's shared-memory loads of the Gram.
//
// Design.  Every stage is spread over the whole CTA:
// - Gram: only the upper triangle of K is formed.  Rows are taken in blocks
//   of 8 (block I = rows 8I..8I+7), and a thread owns an 8×8 register
//   patch (I, J), I ≤ J: ⌈m/8⌉(⌈m/8⌉+1)/2 patches, 36 at m = 64, 2304
//   entries against the 2080 the triangle has.  A step of d reads J's 8
//   rows and then I's, one row ahead, with 16-byte shared loads (4
//   columns) and does 256 FMAs, 16 loads for 256 FMAs (a 4×4 patch, 8 for
//   64, measured slower: the loads bound the Gram).  Where the CTA has
//   threads to spare, each patch is split over slices of d (3 at m = 64 in
//   gram_power, 7 in the step), which add their sums through shared
//   memory at the end.  Rows lie in shared memory in blocks of 8 at a
//   block stride of 8·ld + 4 floats (2·ld + 1 16-byte units, an odd
//   number), so a quarter-warp that reads 8 blocks at one column hits 8
//   distinct bank groups, and lanes that share a block read it as a
//   broadcast.  The patches are written into K in shared memory once,
//   with their mirrors, two 16-byte stores a row, so K is exactly
//   symmetric; a diagonal patch's two halves are the same products
//   (x·y = y·x in f32).
// - gram_power does not keep D: d streams through two panels of C = 64
//   columns (fewer where the shared-memory formula below is tight),
//   double-buffered with cp.async (16-byte copies where rows are 16-byte
//   aligned, else 4-byte; zero-filled past d), and K is written over the
//   panels once the last chunk is consumed.  At m = 64 a CTA has 128
//   threads and 37 KB, so several CTAs share an SM (four or more panels,
//   or 32 columns, measured slower at 354 streams).
// - The step keeps D whole (it needs D three times): every row is copied
//   with cp.async, all in flight at once; v = ûᵀD/σ has threads across
//   16-byte column units and row slices, summed over the slices after;
//   p = Dv takes power_steps.cuh's row groups (a warp a group of 8 rows,
//   one shuffle reduction for all 8), and the warp then writes its rows
//   D′_i = D_i − p_i v to shared and device memory with 16-byte stores;
//   K′ is then written over D′.
// - Power steps (power_cta): one or two threads a row of K, with 16-byte
//   reads of K's rows and broadcast reads of x, every thread summing
//   n_t² = Σ x_t² itself in one fixed order, x_{t+1} = K x_t · (1/n_t)
//   from one reciprocal square root, two x buffers by step parity and one
//   block barrier a step.  At m = 64 this measured faster than
//   power_steps.cuh's warp-a-group step (a 9-shuffle reduction and a
//   shuffled norm a step), which power_iter.cu keeps for its cluster
//   exchange (PERF.md).
// All arithmetic is plain f32 FMA (no TF32): the caller compares λ̂ against
// θ, and a tensor-core product in TF32 could flip that decision.  K′ is
// recomputed from D′, never downdated (K − ppᵀ cancels against σ₁²).
// Neither kernel needs more shared memory than fused_tick_smem_bytes, the
// formula by which kernels/fused_tick/ops.py routes a shape here.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "power_steps.cuh"
#include "tile_copy.cuh"

namespace {

constexpr int kMaxWarps = 16;   // the step: a warp a block of 8 rows
constexpr int kMaxThreads = 32 * kMaxWarps;
// slices of d a Gram patch at most, as the threads allow: the step (one
// CTA on an SM, 256 threads at m = 64) 7, gram_power (128 threads at
// m = 64, 4 CTAs an SM) 3
constexpr int kStepSlices = 7, kGramPowerSlices = 3;
constexpr int kScratch = 256 + 8;  // the formula's reduction scratch (floats)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ float4 lds4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}

// Row i of a panel stored in blocks of 8 rows at a block stride of
// 8·ld + 4 floats.
__device__ __forceinline__ float* panel_row(float* s, int i, int ld) {
  return s + (i >> 3) * (8 * ld + 4) + (i & 7) * ld;
}

// 1 / floored_norm(ss) from one reciprocal square root (rsqrtf, within 2
// ulp): 1/√max(ss, 1e-30), or (floor_norm != 0) 1/max(√ss, 1e-30) =
// min(1/√ss, 1e30).
__device__ __forceinline__ float floored_rnorm(float ss, int floor_norm) {
  return floor_norm ? fminf(rsqrtf(ss), 1e30f) : rsqrtf(fmaxf(ss, 1e-30f));
}

// Sum over the block; every thread returns the same value.
__device__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) t += red[i];
  return t;
}

// The Gram's register patch of one thread: thread t < slices·P takes
// patch p = t mod P, (I, J) = (pI, pJ), I ≤ J, of the ⌈m/8⌉-block upper
// triangle (pI < 0: none), and the column units u ≡ t / P (mod slices);
// acc[r][c] = Σ_k D[8I + r][k] D[8J + c][k] over its units.
struct Patches {
  int pI, pJ, slice;
  float acc[8][8];

  __device__ __forceinline__ Patches(int nb, int P, int slices) {
    const int t = threadIdx.x;
    slice = t / P;
    pI = -1;
    pJ = 0;
    if (slice < slices) tile_of(t % P, nb, &pI, &pJ);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  }

  // acc[r] += a_r b over the 4 columns of one unit (8 independent FMAs in
  // a row; every entry sums its columns in order).
  __device__ __forceinline__ void fma_row(int r, float4 a,
                                          const float4 (&b)[8]) {
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a.x, b[c].x, acc[r][c]);
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a.y, b[c].y, acc[r][c]);
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a.z, b[c].z, acc[r][c]);
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a.w, b[c].w, acc[r][c]);
  }

  // Adds the column units [0, nu) (4 columns each, those of this thread's
  // slice) of a panel of the m rows at stride ld (blocks of 8 at
  // 8·ld + 4).  The last block's rows past m are not stored: they read
  // row m − 1 in their place, and their entries are never written to K.
  // Per unit: the 8 rows of J in registers, then the rows of I one at a
  // time, the next one's load issued before this one's 32 FMAs.
  __device__ __forceinline__ void add(float* s, int ld, int nu, int m,
                                      int slices) {
    if (pI < 0) return;
    const uint32_t ba = smem_addr(panel_row(s, 8 * pI, ld));
    const uint32_t bb = smem_addr(panel_row(s, 8 * pJ, ld));
    const int la = min(7, m - 1 - 8 * pI), lb = min(7, m - 1 - 8 * pJ);
    const uint32_t row = 4 * ld;  // bytes
#pragma unroll 1
    for (int u = slice; u < nu; u += slices) {
      const uint32_t off = 16 * u;
      float4 b[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) b[c] = lds4(bb + min(c, lb) * row + off);
      float4 a = lds4(ba + off);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float4 next = lds4(ba + min(min(r + 1, 7), la) * row + off);
        fma_row(r, a, b);
        a = next;
      }
    }
  }

  // Slices 1, 2, ... hand their sums to slice 0 through `part`
  // ((slices − 1)·P float4 × 16, free shared memory), which adds them in
  // slice order.  Every thread calls it after a barrier that ends the
  // reads of the panel `part` may overlap.
  __device__ __forceinline__ void gather(float* part, int P, int slices) {
    if (slices == 1) return;
    float4* p4 = reinterpret_cast<float4*>(part);
    const int p = threadIdx.x % P;
    if (slice >= 1 && pI >= 0)
#pragma unroll
      for (int q = 0; q < 16; ++q)
        p4[((slice - 1) * 16 + q) * P + p] =
            make_float4(acc[q >> 1][4 * (q & 1)], acc[q >> 1][4 * (q & 1) + 1],
                        acc[q >> 1][4 * (q & 1) + 2], acc[q >> 1][4 * (q & 1) + 3]);
    __syncthreads();
    if (slice == 0 && pI >= 0)
      for (int sl = 1; sl < slices; ++sl)
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const float4 v = p4[((sl - 1) * 16 + q) * P + p];
          acc[q >> 1][4 * (q & 1)] += v.x;
          acc[q >> 1][4 * (q & 1) + 1] += v.y;
          acc[q >> 1][4 * (q & 1) + 2] += v.z;
          acc[q >> 1][4 * (q & 1) + 3] += v.w;
        }
  }

  // K (m × ldk, row-major, ldk ≥ m4 = m rounded up to 4) from slice 0's
  // patches and their mirrors, two 16-byte stores per row of a patch and
  // per row of its mirror (the second not past m4); entries past m are
  // written as zeros.
  __device__ __forceinline__ void store(float* sK, int ldk, int m) const {
    if (slice || pI < 0) return;
    const int I = 8 * pI, J = 8 * pJ, m4 = (m + 3) & ~3;
    auto at = [&](int r, int c) {
      return I + r < m && J + c < m ? acc[r][c] : 0.f;
    };
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (I + r < m) {
        float4* k = reinterpret_cast<float4*>(sK + (I + r) * ldk + J);
        k[0] = make_float4(at(r, 0), at(r, 1), at(r, 2), at(r, 3));
        if (J + 4 < m4)
          k[1] = make_float4(at(r, 4), at(r, 5), at(r, 6), at(r, 7));
      }
      if (J + r < m) {
        float4* k = reinterpret_cast<float4*>(sK + (J + r) * ldk + I);
        k[0] = make_float4(at(0, r), at(1, r), at(2, r), at(3, r));
        if (I + 4 < m4)
          k[1] = make_float4(at(4, r), at(5, r), at(6, r), at(7, r));
      }
    }
  }
};

// After the Gram: K's pad columns [m4, ldk) zero (Patches::store writes
// [m, m4), m4 = m rounded up to 4), and the two x buffers (2 × ldk after
// K) x₀ = u₀ = 1/√m, pads zero.
__device__ __forceinline__ void init_power(float* sK, float* xb, int m,
                                           int ldk) {
  const int m4 = (m + 3) & ~3, pad = ldk - m4;
  for (int idx = threadIdx.x; idx < m * pad; idx += blockDim.x)
    sK[(idx / pad) * ldk + m4 + idx % pad] = 0.f;
  const float u0 = 1.0f / sqrtf((float)m);
  for (int j = threadIdx.x; j < ldk; j += blockDim.x) {
    xb[j] = j < m ? u0 : 0.f;
    xb[ldk + j] = 0.f;
  }
}

// `iters` power steps on K (m × ldk in shared memory) from x₀ in xb, then
// one more for K û: writes λ̂ = Σ (K û)_j û_j and û = x / n.  Each row of
// K has rt consecutive threads (rt ∈ {1, 2}, m·rt ≤ the CTA's threads);
// thread sub of row i takes the 16-byte units sub, sub + rt, ... of K's
// row i and of x_t (a broadcast), and sums both K_i · x_t and
// n_t² = Σ x_t² over them in four interleaved partial sums each; the rt
// threads add theirs with an xor shuffle, so every thread holds the same
// n_t (its partial sums depend on sub alone).  Then x_{t+1,i} =
// (K_i · x_t) · r_t, r_t = 1 / n_t from one reciprocal square root (no
// division or square root on the step's chain: their IEEE sequences cost
// as much as the rest of a step), and one barrier a step.
__device__ void power_cta(const float* sK, float* xb, int m, int ldk, int rt,
                          int iters, int floor_norm, float* lam_out,
                          float* u_out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = tid / rt, sub = tid % rt, nu = ldk / 4;
  const float* ki = sK + min(i, m - 1) * ldk;
  const bool busy = warp * 32 < m * rt;  // the warp has rows
  float inv = 1.f;                       // r_t
  for (int t = 0; t <= iters; ++t) {
    const float* x = xb + (t & 1) * ldk;
    float* y = xb + ((t + 1) & 1) * ldk;
    if (busy) {
      float4 n = make_float4(0.f, 0.f, 0.f, 0.f), s = n;
#pragma unroll 4
      for (int u = sub; u < nu; u += rt) {
        const float4 xv = *reinterpret_cast<const float4*>(x + 4 * u);
        const float4 kv = *reinterpret_cast<const float4*>(ki + 4 * u);
        n.x = fmaf(xv.x, xv.x, n.x);
        n.y = fmaf(xv.y, xv.y, n.y);
        n.z = fmaf(xv.z, xv.z, n.z);
        n.w = fmaf(xv.w, xv.w, n.w);
        s.x = fmaf(kv.x, xv.x, s.x);
        s.y = fmaf(kv.y, xv.y, s.y);
        s.z = fmaf(kv.z, xv.z, s.z);
        s.w = fmaf(kv.w, xv.w, s.w);
      }
      float nn = (n.x + n.y) + (n.z + n.w), ss = (s.x + s.y) + (s.z + s.w);
      for (int o = 1; o < rt; o <<= 1) {
        nn += __shfl_xor_sync(0xffffffffu, nn, o);
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
      }
      if (t) inv = floored_rnorm(nn, floor_norm);
      if (sub == 0 && i < m) y[i] = ss * inv;
    }
    __syncthreads();  // x_{t+1} whole; x_t free for x_{t+2}
  }
  const float* x = xb + (iters & 1) * ldk;        // û = x · r
  const float* y = xb + ((iters + 1) & 1) * ldk;  // K û
  if (warp == 0) {
    float lam = 0.f;
    for (int j = lane; j < m; j += 32) lam = fmaf(y[j], x[j] * inv, lam);
    lam = warp_sum(lam);
    if (lane == 0) *lam_out = lam;
  }
  for (int j = tid; j < m; j += blockDim.x) u_out[j] = x[j] * inv;
}

// Columns [k0, k0 + C) of the m rows of D (m × d, zero past d) into a
// panel of stride C, by cp.async of BYTES.
template <int BYTES>
__device__ __forceinline__ void load_chunk(const float* __restrict__ D,
                                           float* s, int k0, int C, int m,
                                           int d) {
  constexpr int E = BYTES / 4;  // floats a copy
  const int sh = __ffs(C / E) - 1;  // log2 of the copies a row
  for (int idx = threadIdx.x; idx < m << sh; idx += blockDim.x) {
    const int i = idx >> sh, e = (idx & ((1 << sh) - 1)) * E;
    const int n = max(0, min(E, d - (k0 + e)));
    cp_async<BYTES>(smem_addr(panel_row(s, i, C) + e),
                    n ? D + (size_t)i * d + k0 + e : D, 4 * n);
  }
}

// Where the power steps' buffers lie after the Gram: K (m × ldk) at 0, the
// x buffers (2 × ldk) after it, then the Gram slices' partial sums.
struct After {
  float *K, *x, *part;
  __device__ __forceinline__ After(float* smem, int m, int ldk) {
    K = smem;
    x = K + m * ldk;
    part = x + 2 * ldk;
  }
};

template <int BYTES>
__global__ void __launch_bounds__(kMaxThreads)
gram_power_kernel(const float* __restrict__ D, float* __restrict__ lam_out,
                  float* __restrict__ u_out, int m, int d, int nb, int P,
                  int C, int ldk, int rt, int slices, int iters,
                  int floor_norm) {
  extern __shared__ __align__(16) float smem[];
  const size_t b = blockIdx.x;
  const float* Db = D + b * (size_t)m * d;
  const int panel = nb * (8 * C + 4);
  const After a(smem, m, ldk);

  Patches g(nb, P, slices);
  const int n_chunks = (d + C - 1) / C;
  auto issue = [&](int ch) {  // a commit group, empty past the last chunk
    if (ch < n_chunks)
      load_chunk<BYTES>(Db, smem + (ch & 1) * panel, ch * C, C, m, d);
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  issue(0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    issue(ch + 1);  // into the panel chunk ch − 1 was read from
    asm volatile("cp.async.wait_group 1;" ::: "memory");  // chunk ch landed
    __syncthreads();
    g.add(smem + (ch & 1) * panel, C, C / 4, m, slices);
    __syncthreads();  // this panel is free for chunk ch + 2 (or for K)
  }
  g.gather(a.part, P, slices);
  g.store(a.K, ldk, m);
  init_power(a.K, a.x, m, ldk);
  __syncthreads();
  power_cta(a.K, a.x, m, ldk, rt, iters, floor_norm, lam_out + b,
            u_out + b * m);
}

template <int BYTES>
__global__ void __launch_bounds__(kMaxThreads)
step_kernel(const float* __restrict__ D, const float* __restrict__ lam_in,
            const float* __restrict__ u_in, float* __restrict__ snap,
            float* __restrict__ D_out, float* __restrict__ lam_out,
            float* __restrict__ u_out, int m, int d, int nb, int P, int ldd,
            int ldk, int rt, int rsn, int slices, int iters,
            int floor_norm) {
  extern __shared__ __align__(16) float smem[];
  constexpr int E = BYTES / 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, nw = nt >> 5, nu = ldd / 4;
  const int m4 = (m + 3) & ~3;
  const size_t b = blockIdx.x;
  const float* Db = D + b * (size_t)m * d;
  float* Do = D_out + b * (size_t)m * d;
  float* sD = smem;                          // m rows, blocks of 8 at ldd
  float* sv = panel_row(sD, m, ldd);         // ldd
  float* part = rsn > 1 ? sv + ldd : sv;     // rsn × ldd (rsn = 1: v)
  float* su = part + (rsn > 1 ? rsn : 1) * ldd;  // m4
  float* sp = su + m4;                       // m4
  float* red = sp + m4;                      // kMaxWarps
  const After a(smem, m, ldk);               // after the Gram

  // D, zero past d, every copy in flight
  for (int i = warp; i < m; i += nw) {
    float* dst = panel_row(sD, i, ldd);
    for (int e = lane * E; e < ldd; e += 32 * E) {
      const int n = max(0, min(E, d - e));
      cp_async<BYTES>(smem_addr(dst + e), n ? Db + (size_t)i * d + e : Db,
                      4 * n);
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  for (int i = tid; i < m; i += nt) su[i] = u_in[b * m + i];
  const float sigma = sqrtf(fmaxf(lam_in[b], 1e-30f));
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  // v = ûᵀD / σ: thread (cu, rs) sums rows rs, rs + rsn, ... of column
  // unit cu; the rsn partial sums are added in order after (in place,
  // where rsn = 1)
  for (int w = tid; w < nu * rsn; w += nt) {
    const int cu = w % nu, rs = w / nu;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int i = rs; i < m; i += rsn) {
      const float ui = su[i];
      const float4 x =
          *reinterpret_cast<const float4*>(panel_row(sD, i, ldd) + 4 * cu);
      acc.x = fmaf(ui, x.x, acc.x);
      acc.y = fmaf(ui, x.y, acc.y);
      acc.z = fmaf(ui, x.z, acc.z);
      acc.w = fmaf(ui, x.w, acc.w);
    }
    *reinterpret_cast<float4*>(part + rs * ldd + 4 * cu) = acc;
  }
  __syncthreads();
  float ss = 0.f;
  for (int cu = tid; cu < nu; cu += nt) {
    float4 s = *reinterpret_cast<const float4*>(part + 4 * cu);
    for (int rs = 1; rs < rsn; ++rs) {
      const float4 t = *reinterpret_cast<const float4*>(part + rs * ldd + 4 * cu);
      s.x += t.x;
      s.y += t.y;
      s.z += t.z;
      s.w += t.w;
    }
    s.x /= sigma;
    s.y /= sigma;
    s.z /= sigma;
    s.w /= sigma;
    *reinterpret_cast<float4*>(sv + 4 * cu) = s;  // ûᵀD/σ, as the plain version
    ss = fmaf(s.x, s.x, ss);
    ss = fmaf(s.y, s.y, ss);
    ss = fmaf(s.z, s.z, ss);
    ss = fmaf(s.w, s.w, ss);
  }
  const float nrm = floored_norm(block_sum(ss, red), floor_norm);
  for (int j = tid; j < d; j += nt) {  // the pads stay 0
    const float vj = sv[j] / nrm;
    sv[j] = vj;
    snap[b * d + j] = sigma * vj;
  }
  __syncthreads();

  // p = D v, a warp a group of 8 rows (power_steps.cuh's row groups), then
  // the warp's rows D′_i = D_i − p_i v into shared and device memory
  auto row = [&](int i, int j) {
    return *reinterpret_cast<const float4*>(panel_row(sD, i, ldd) + j);
  };
  auto keep = [&](int i, float v) { sp[i] = v; };
  for (int g0 = warp * kGroup; g0 < m; g0 += nw * kGroup) {
    if (g0 + kGroup <= m)
      group_rows<true>(row, row, sv, g0, m, ldd, keep);
    else
      group_rows<false>(row, row, sv, g0, m, ldd, keep);
    __syncwarp();
    float p[kGroup];
#pragma unroll
    for (int r = 0; r < kGroup; ++r) p[r] = sp[min(g0 + r, m - 1)];
    for (int cu = lane; cu < nu; cu += 32) {
      const float4 v = *reinterpret_cast<const float4*>(sv + 4 * cu);
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        const int i = g0 + r;
        if (i >= m) break;
        float* ri = panel_row(sD, i, ldd) + 4 * cu;
        float4 x = *reinterpret_cast<const float4*>(ri);
        x.x = fmaf(-p[r], v.x, x.x);
        x.y = fmaf(-p[r], v.y, x.y);
        x.z = fmaf(-p[r], v.z, x.z);
        x.w = fmaf(-p[r], v.w, x.w);
        *reinterpret_cast<float4*>(ri) = x;
        float* g = Do + (size_t)i * d + 4 * cu;
        if constexpr (BYTES == 16) {
          *reinterpret_cast<float4*>(g) = x;  // d % 4 == 0
        } else {
          const int k = 4 * cu;
          if (k < d) g[0] = x.x;
          if (k + 1 < d) g[1] = x.y;
          if (k + 2 < d) g[2] = x.z;
          if (k + 3 < d) g[3] = x.w;
        }
      }
    }
  }
  __syncthreads();

  Patches g(nb, P, slices);
  g.add(sD, ldd, nu, m, slices);
  __syncthreads();  // D′ is read; the partial sums and K go over it
  g.gather(a.part, P, slices);
  g.store(a.K, ldk, m);
  init_power(a.K, a.x, m, ldk);
  __syncthreads();
  power_cta(a.K, a.x, m, ldk, rt, iters, floor_norm, lam_out + b,
            u_out + b * m);
}

// What a launch of either kernel takes for an (m, d) buffer: threads, row
// blocks of 8 and patches; gram_power's chunk width C (64 columns, fewer
// where the formula is tight); the step's D row stride
// ldd and row slices rsn of the v-extraction; slices of d a Gram patch;
// the power steps' threads a row rt; K's row stride ldk (m rounded up to
// 4 floats, and more where it fits: to 2 mod 4 16-byte units with 2
// threads a row, an odd number with 1, so that the 8 threads of a
// quarter-warp, which read 4 rows (or 8) at one column, hit 8 bank
// groups); and the dynamic shared memory (bytes), 0 where no layout fits
// the formula.
struct Layout {
  int threads, nb, P, C, ldd, ldk, rt, rsn, slices;
  size_t smem;
};

size_t formula_bytes(int m, int d) {
  const size_t ld = (size_t)(d | 1);
  return sizeof(float) * ((size_t)m * ld + (size_t)m * m + 3 * (size_t)m +
                          (size_t)d + kScratch);
}

Layout layout(int m, int d, bool step) {
  Layout L = {};
  if (m < 1 || d < 1) return L;
  const int m4 = (m + 3) / 4 * 4, k = m4 / 4;  // K's row in 16-byte units
  L.nb = (m + 7) / 8;
  L.P = L.nb * (L.nb + 1) / 2;
  // the step: a warp a group of 8 rows of D, up to 16; gram_power: two
  // threads a row of K, and a thread a patch
  L.threads = step ? 32 * min(kMaxWarps, L.nb)
                   : (max(2 * m, L.P) + 31) / 32 * 32;
  if (L.threads > kMaxThreads || L.P > L.threads) return Layout{};
  L.rt = L.threads >= 2 * m ? 2 : 1;
  L.ldd = (d + 3) / 4 * 4;
  const int nu = L.ldd / 4;
  const size_t limit = formula_bytes(m, d);
  auto fits = [&](size_t before, size_t after) {
    const size_t bytes = sizeof(float) * (before > after ? before : after);
    return bytes <= limit ? bytes : 0;
  };
  for (int pad = 1; pad >= 0; --pad)
    for (L.slices = min(step ? kStepSlices : kGramPowerSlices,
                        L.threads / L.P);
         L.slices >= 1; --L.slices) {
      L.ldk = 4 * (pad ? (L.rt == 2 ? k + (6 - k % 4) % 4 : k | 1) : k);
      // K, the x buffers and the Gram slices' partial sums
      const size_t after = (size_t)m * L.ldk + 2 * (size_t)L.ldk +
                           (size_t)(L.slices - 1) * L.P * 64;
      if (!step) {
        for (L.C = 64; L.C >= 8; L.C /= 2)
          if ((L.smem = fits(2 * (size_t)L.nb * (8 * L.C + 4), after)))
            return L;
        continue;
      }
      for (L.rsn = max(1, min(m, L.threads / nu));; L.rsn = 1) {
        // D's m rows, v, the partial sums, û, p and the block sum's scratch
        const size_t before = (size_t)(m / 8) * (8 * L.ldd + 4) +
                              (size_t)(m % 8) * L.ldd + L.ldd +
                              (L.rsn > 1 ? (size_t)L.rsn * L.ldd : 0) +
                              2 * (size_t)m4 + kMaxWarps;
        if ((L.smem = fits(before, after))) return L;
        if (L.rsn == 1) break;
      }
    }
  return Layout{};
}

template <int BYTES>
int launch_gram_power(const Layout& L, const float* D, float* lam_out,
                      float* u_out, int S, int m, int d, int iters,
                      int floor_norm, cudaStream_t stream) {
  auto kern = gram_power_kernel<BYTES>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<S, L.threads, L.smem, stream>>>(D, lam_out, u_out, m, d, L.nb, L.P,
                                         L.C, L.ldk, L.rt, L.slices, iters,
                                         floor_norm);
  return (int)cudaGetLastError();
}

template <int BYTES>
int launch_step(const Layout& L, const float* D, const float* lam,
                const float* u, float* snap, float* D_out, float* lam_out,
                float* u_out, int S, int m, int d, int iters, int floor_norm,
                cudaStream_t stream) {
  auto kern = step_kernel<BYTES>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<S, L.threads, L.smem, stream>>>(
      D, lam, u, snap, D_out, lam_out, u_out, m, d, L.nb, L.P, L.ldd, L.ldk,
      L.rt, L.rsn, L.slices, iters, floor_norm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory the route allows one CTA for an (m, d) buffer
// (kernels/fused_tick/ops.py::fused_tick_smem_bytes mirrors it): what this
// kernel's first design kept (D at an odd row stride, K, three m-vectors,
// v and 264 floats of scratch).  Both kernels fit within it at every
// shape the route sends them (fused_tick_kernel_smem).
size_t fused_tick_smem_bytes(int m, int d) { return formula_bytes(m, d); }

// Dynamic shared memory a launch of gram_power (step == 0) or of the step
// (step != 0) requests for an (m, d) buffer; 0 where it has no layout.
size_t fused_tick_kernel_smem(int m, int d, int step) {
  return layout(m, d, step != 0).smem;
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
  const Layout L = layout(m, d, false);
  if (!L.smem) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (copy_bytes(D, (size_t)d * sizeof(float), 16 | 4)) {
    case 16:
      return launch_gram_power<16>(L, D, lam_out, u_out, S, m, d, iters,
                                   floor_norm, st);
    case 4:
      return launch_gram_power<4>(L, D, lam_out, u_out, S, m, d, iters,
                                  floor_norm, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int fused_tick_step(const float* D, const float* lam, const float* u,
                    float* snap, float* D_out, float* lam_out, float* u_out,
                    int S, int m, int d, int iters, int floor_norm,
                    void* stream) {
  const Layout L = layout(m, d, true);
  if (!L.smem) return (int)cudaErrorInvalidValue;
  const size_t row = (size_t)d * sizeof(float);
  int bytes = copy_bytes(D, row, 16 | 4);
  if (bytes == 16 && copy_bytes(D_out, row, 16) != 16) bytes = 4;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bytes == 16)
    return launch_step<16>(L, D, lam, u, snap, D_out, lam_out, u_out, S, m, d,
                           iters, floor_norm, st);
  if (bytes == 4)
    return launch_step<4>(L, D, lam, u, snap, D_out, lam_out, u_out, S, m, d,
                          iters, floor_norm, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

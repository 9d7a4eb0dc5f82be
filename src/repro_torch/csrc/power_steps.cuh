// One step of the power iteration on rows of a PSD matrix K held in shared
// memory: power_iter.cu's step (a cluster of CTAs a stream, the step's
// vector exchanged with st.async).  fused_tick.cu takes its row groups for
// the matrix-vector product p = D v of the krylov step, and its floors.
//
// The step computes x_{t+1} = K x_t / n_t, where n_t = ‖x_t‖ (floored) and
// x₀ = u₀ = 1/√m, n₀ = 1, so u_t = x_t / n_t is never stored.  A warp takes
// 8 rows of K at a time (a group): a lane owns the columns 4·lane + 128·q
// and reads them with 16-byte loads of K's rows and of x_t, then the warp
// reduces its 8 partial sums, halving the rows at each shuffle level
// (9 shuffles), and hands each row's sum to the caller, which scales it
// by n_t.  norm() sums n_t in one fixed order (16-byte reads,
// lane-strided, then an xor butterfly, whose every lane ends with the
// same bits), so every warp that calls it gets the same n_t and no
// barrier is needed to share it.  K and x are at a row stride ld (a
// multiple of 4 floats) whose pad columns hold zeros.  All arithmetic is
// plain f32 FMA.

#pragma once

#include <cuda_runtime.h>

constexpr int kGroup = 8;  // rows a warp reduces at once

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The divisor that normalises a vector with squared norm `ss`: the fused
// floor √max(ss, 1e-30), or (floor_norm != 0) the inline floor
// max(√ss, 1e-30) of the reference's inline krylov path.
__device__ __forceinline__ float floored_norm(float ss, int floor_norm) {
  return floor_norm ? fmaxf(sqrtf(ss), 1e-30f) : sqrtf(fmaxf(ss, 1e-30f));
}

// The norm of x (its entries and zero pads up to ld) with the floor,
// summed in one fixed order: the same bits in every lane, warp and CTA.
__device__ __forceinline__ float norm(const float* x, int lane, int ld,
                                      int floor_norm) {
  float ss = 0.f;
  for (int j = lane * 4; j < ld; j += 128) {
    const float4 v = *reinterpret_cast<const float4*>(x + j);
    ss = fmaf(v.x, v.x, ss);
    ss = fmaf(v.y, v.y, ss);
    ss = fmaf(v.z, v.z, ss);
    ss = fmaf(v.w, v.w, ss);
  }
  return floored_norm(warp_sum(ss), floor_norm);
}

// s_i = Σ_j K_ij x_j for the rows [g0, g0 + kGroup) of K (the caller's
// numbering), each handed to send(i, s_i) by one lane.
// full_row(i, j) / part_row(i, j) return columns [j, j + 4) of row i as a
// float4: FULL, all kGroup rows exist and full_row reads them; otherwise
// rows at or past nr are skipped and part_row reads the others.
template <bool FULL, class FullRow, class PartRow, class Send>
__device__ __forceinline__ void group_rows(FullRow full_row, PartRow part_row,
                                           const float* x, int g0, int nr,
                                           int ld, Send send) {
  const int lane = threadIdx.x & 31;
  float acc[kGroup];
#pragma unroll
  for (int r = 0; r < kGroup; ++r) acc[r] = 0.f;
  for (int j = lane * 4; j < ld; j += 128) {
    const float4 xv = *reinterpret_cast<const float4*>(x + j);
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      const int i = g0 + r;
      float4 kv;
      if constexpr (FULL) {
        kv = full_row(i, j);
      } else {
        if (i >= nr) continue;
        kv = part_row(i, j);
      }
      acc[r] = fmaf(kv.x, xv.x, acc[r]);
      acc[r] = fmaf(kv.y, xv.y, acc[r]);
      acc[r] = fmaf(kv.z, xv.z, acc[r]);
      acc[r] = fmaf(kv.w, xv.w, acc[r]);
    }
  }
  // reduce-scatter over the lanes: at offsets 16, 8, ... each lane keeps
  // half of its rows and adds its partner's half of them, until one row
  // is left a lane; the lanes that share it finish it with xors.
  constexpr int kLevels = 3;  // log2(kGroup)
  static_assert(kGroup >> kLevels == 1, "kGroup is 2^kLevels");
#pragma unroll
  for (int l = 0; l < kLevels; ++l) {
    const int o = 16 >> l, half = kGroup >> (l + 1);
    const bool hi = lane & o;
#pragma unroll
    for (int r = 0; r < half; ++r) {
      const float give = hi ? acc[r] : acc[r + half];
      const float keep = hi ? acc[r + half] : acc[r];
      acc[r] = keep + __shfl_xor_sync(0xffffffffu, give, o);
    }
  }
  float v = acc[0];
#pragma unroll
  for (int o = 16 >> kLevels; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  constexpr int kShare = 32 / kGroup;  // lanes that share a row
  const int i = g0 + lane / kShare;
  if (lane % kShare == 0 && i < nr) send(i, v);
}

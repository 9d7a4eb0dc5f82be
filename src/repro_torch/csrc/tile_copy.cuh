// Helpers shared by the register-tiled Gram kernels (gram.cu, window_gram.cu):
// the cp.async copies of a panel into shared memory, the width a slab's
// alignment allows them, the 4-wide widening reads of a panel, and the
// walk of a symmetric result's upper-triangle tiles.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

// Four consecutive elements at p (16-byte aligned for f32, 8-byte for
// bf16), widened to f32.
__device__ __forceinline__ void load4(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* x) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  x[0] = a.x;
  x[1] = a.y;
  x[2] = b.x;
  x[3] = b.y;
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

// cp.async of BYTES (4, 8 or 16) from src to shared dst, of which the
// first `valid` bytes are read and the rest zero-filled.
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int valid) {
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "cp.async width");
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
                 "l"(src), "r"(valid)
                 : "memory");
  else if constexpr (BYTES == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(dst),
                 "l"(src), "r"(valid)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
                 "l"(src), "r"(valid)
                 : "memory");
}

// The widest cp.async, of the widths in the mask `widths` (16 | 8 | 4),
// whose alignment every row of a slab at `at` with rows of `row` bytes
// has; 0 where none fits and plain loads must copy.
inline int copy_bytes(const void* at, size_t row, int widths) {
  for (int b = 16; b >= 4; b /= 2)
    if ((widths & b) && row % b == 0 && (uintptr_t)at % b == 0) return b;
  return 0;
}

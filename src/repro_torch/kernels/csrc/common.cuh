// Shared helpers of the segment kernels: io-dtype conversion (fp32 / bf16
// in device memory, fp32 arithmetic), enum codes of the C interface, and
// the NaN-propagating max the reference's jnp.maximum computes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

enum { DT_F32 = 0, DT_BF16 = 1 };
enum { RED_SUM = 0, RED_MEAN = 1, RED_MAX = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// max(a, b) that keeps a NaN from either side, like jnp.maximum
__device__ __forceinline__ float max_nan(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// Rows [r0, r1) that block b walks: its chunk range clipped to the real rows
// (chunks past num_rows hold only padding, whose segment is the drop id).
__device__ __forceinline__ void block_rows(const int* cf, const int* cc, int b, int m_b,
                                           int64_t num_rows, int64_t* r0, int64_t* r1) {
  const int64_t first = (int64_t)cf[b] * m_b;
  const int64_t last = first + (int64_t)cc[b] * m_b;
  *r0 = first;
  *r1 = last < num_rows ? last : num_rows;
}

// Shared helpers of the segment kernels: io-dtype conversion (fp32 / bf16
// in device memory, fp32 arithmetic), enum codes of the C interface, the
// NaN-propagating max the reference's jnp.maximum computes, vectors of io
// elements as one load keeps them in registers, and the chunk range a
// window block of the plan walks (block_rows; only fused_transform_reduce.cu
// still walks ownership windows). The gather, segment_reduce and softmax
// kernels split their work by row runs instead (row_runs.cuh,
// segment_softmax.cu); the window walk they shared is gone.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

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

template <int BYTES> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

// V consecutive io elements, as one vector load keeps them in registers
template <typename T, int V> using RawVec = typename Raw<V * sizeof(T)>::type;

template <typename T, int V>
__device__ __forceinline__ void unpack(const RawVec<T, V>& r, float (&f)[V]) {
  T t[V];
  memcpy(t, &r, sizeof(r));
#pragma unroll
  for (int j = 0; j < V; ++j) f[j] = to_f(t[j]);
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[V]) {
  T t[V];
#pragma unroll
  for (int j = 0; j < V; ++j) t[j] = from_f<T>(f[j]);
  RawVec<T, V> r;
  memcpy(&r, t, sizeof(r));
  *reinterpret_cast<RawVec<T, V>*>(p) = r;
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

// Shared helpers of the segment kernels: io-dtype conversion (fp32 / bf16
// in device memory, fp32 arithmetic), enum codes of the C interface, the
// NaN-propagating max the reference's jnp.maximum computes, and the
// ownership-window walk of the window kernels (segment_reduce.cu runs
// window_walk; segment_softmax.cu and fused_transform_reduce.cu read their
// rows with block_rows and keep walks of their own). The gather kernel left
// the walk for row runs (gather_segment_reduce.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
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

// The sequential (SR) walk of one ownership window, for one feature column:
// the rows [r0, r1) of a block's chunk range in order, keeping the segments
// [lo, hi). load(i) gives row i's fp32 value for this column and is called
// only for rows of the window; store(s, v) writes output row s. Every
// segment of the window is stored exactly once: an empty one as -inf for
// max and 0 otherwise, mean as the sum over max(count, 1). Rows of a
// foreign segment are skipped, and the walk stops at the first row past the
// window (the index is sorted), so neighbouring windows need no atomics.
// Loads are issued U rows at a time so each thread keeps U in flight. Only
// segment_reduce.cu runs it. (fused_transform_reduce.cu keeps its own walk
// into a zeroed aggregate: built on this one, its weighted fp32 kernel ran
// 1.4x slower.)
template <int RED, typename Load, typename Store>
__device__ __forceinline__ void window_walk(const int* __restrict__ seg, int64_t r0,
                                            int64_t r1, int lo, int hi, Load load,
                                            Store store) {
  constexpr int U = 4;
  const float empty = RED == RED_MAX ? -CUDART_INF_F : 0.f;
  int next = lo;   // first output row of the window not written yet
  int open = -1;   // segment of the running value, -1 while none is open
  float acc = 0.f;
  int cnt = 0;
  auto flush = [&]() {
    for (; next < open; ++next) store(next, empty);
    store(open, RED == RED_MEAN ? acc / (float)max(cnt, 1) : acc);
    next = open + 1;
  };
  bool done = false;
  for (int64_t i = r0; i < r1 && !done; i += U) {
    int s[U];
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) s[u] = (i + u < r1) ? seg[i + u] : INT_MAX;
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = (s[u] >= lo && s[u] < hi) ? load(i + u) : 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s[u] < lo) continue;
      if (s[u] >= hi) {  // sorted: every later row is past the window
        done = true;
        break;
      }
      if (s[u] != open) {
        if (open >= 0) flush();
        open = s[u];
        acc = v[u];
        cnt = 1;
      } else {
        acc = RED == RED_MAX ? max_nan(acc, v[u]) : acc + v[u];
        ++cnt;
      }
    }
  }
  if (open >= 0) flush();
  for (; next < hi; ++next) store(next, empty);
}

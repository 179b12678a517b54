// Segment reduction on Hopper (paper Fig. 2):
//
//   Y[s, f] = reduce_{i : idx[i] == s} X[i, f]      reduce in {sum, mean, max}
//
// Replaces the TPU kernel src/repro/kernels/segment_reduce.py:
// segment_reduce_pallas (bodies _sr_body / _pr_body).
//
// What bounds it on the H100: bytes. Each row of X is read once, with its
// segment id, and each output row written once, against one add an
// element; the floor is (4 + N * io) bytes a row plus N * io an output row
// at 3.35 TB/s.
//
// Design: the ownership window of the plan, as in gather_segment_reduce.cu
// but reading X[i] in place instead of gathering. CUDA block (b, y) owns
// segments [b*s_b, (b+1)*s_b) and feature columns [y*blockDim,
// (y+1)*blockDim), and runs common.cuh's window_walk over its chunk range,
// one thread per column: the threads of a warp read neighbouring columns of
// one X row, so every load is coalesced, and X is streamed in row order.
// The mean's count lives in the walk (sum over max(count, 1) in one
// launch, where the TPU pairs a sum launch with a separate count); an empty
// max is -inf, an empty sum or mean 0; rows with idx >= num_segments never
// count. fp32 accumulation, output in the io dtype.
#include "common.cuh"

namespace {

template <typename T, int RED>
__global__ void srd_kernel(const T* __restrict__ x, const int* __restrict__ seg,
                           const int* __restrict__ cf, const int* __restrict__ cc,
                           T* __restrict__ out, int64_t num_rows, int feat,
                           int num_segments, int s_b, int m_b) {
  const int b = blockIdx.x;
  const int f = blockIdx.y * blockDim.x + threadIdx.x;
  if (f >= feat) return;
  const int lo = b * s_b;
  const int hi = min(lo + s_b, num_segments);
  int64_t r0, r1;
  block_rows(cf, cc, b, m_b, num_rows, &r0, &r1);
  window_walk<RED>(
      seg, r0, r1, lo, hi, [&](int64_t i) { return to_f(x[i * feat + f]); },
      [&](int s, float v) { out[(int64_t)s * feat + f] = from_f<T>(v); });
}

template <typename T>
bool dispatch(int reduce, dim3 grid, dim3 block, cudaStream_t st, const void* x,
              const void* seg, const void* cf, const void* cc, void* out,
              int64_t num_rows, int feat, int num_segments, int s_b, int m_b) {
#define SRD_CASE(RED)                                                                 \
  if (reduce == RED) {                                                                \
    srd_kernel<T, RED><<<grid, block, 0, st>>>((const T*)x, (const int*)seg,          \
                                               (const int*)cf, (const int*)cc, (T*)out, \
                                               num_rows, feat, num_segments, s_b, m_b); \
    return true;                                                                      \
  }
  SRD_CASE(RED_SUM)
  SRD_CASE(RED_MEAN)
  SRD_CASE(RED_MAX)
#undef SRD_CASE
  return false;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// n_b bounds the threads of a block (one feature column each).
extern "C" int srd_launch(int dtype, int reduce, const void* x, const void* seg,
                          const void* cf, const void* cc, void* out, int64_t num_rows,
                          int feat, int num_segments, int s_b, int m_b, int out_blocks,
                          int n_b, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  int threads = min(min(feat, n_b), 1024);
  threads = max(32, (threads + 31) / 32 * 32);
  const dim3 grid(out_blocks, (feat + threads - 1) / threads);
  const dim3 block(threads);
  cudaStream_t st = (cudaStream_t)stream;
  bool ok = false;
  if (dtype == DT_F32)
    ok = dispatch<float>(reduce, grid, block, st, x, seg, cf, cc, out, num_rows, feat,
                         num_segments, s_b, m_b);
  else if (dtype == DT_BF16)
    ok = dispatch<__nv_bfloat16>(reduce, grid, block, st, x, seg, cf, cc, out, num_rows,
                                 feat, num_segments, s_b, m_b);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

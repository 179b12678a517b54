// Fused gather + segment reduction on Hopper:
//
//   Y[s, f] = reduce_{i : seg[i] == s} (w[i] *) H[gidx[i], f]     reduce in {sum, mean, max}
//
// Replaces the TPU kernel src/repro/kernels/gather_segment_reduce.py:
// _gather_segment_reduce_impl (bodies _sr_body / _pr_body, row gather
// _gather_chunk).
//
// What bounds it on the H100: bytes. Each output row costs one read of its
// rows' indices and weights (4 + 4 + io bytes a row) and one gathered H row
// per edge, against 2 flops an element; at 3.35 TB/s the floor is the index
// stream plus H read once plus Y written once. At ogbn-arxiv H is
// 169k x 64 x 4 B = 43 MB and fits the 50 MB L2, so the repeated gathers of
// hub sources mostly hit L2 instead of device memory.
//
// Design: the deterministic ownership window of the plan. CUDA block
// (b, y) owns segments [b*s_b, (b+1)*s_b) and feature columns
// [y*blockDim, (y+1)*blockDim); it walks the rows of its chunk range
// (chunk_first[b], chunk_count[b] chunks of m_b rows) in order, one
// thread per column, with the running value in an fp32 register that is
// written out at each segment boundary (the SR walk). Rows of a foreign
// segment are skipped and the walk stops at the first row past the window,
// so no atomics are needed and the result does not depend on scheduling.
// The walk is common.cuh's window_walk, shared with segment_reduce.cu; it
// keeps 4 gathers in flight a thread. The
// threads of a warp read neighbouring columns of one H row, so every gather
// is coalesced. A "PR" schedule request runs this same walk:
// a one-hot matmul has no use on the CUDA cores.
//
// Semantics kept from the reference: mean divides by max(count, 1); an
// empty max is -inf; an empty sum is 0; rows with seg >= num_segments never
// count. The weight stays in the io dtype and the multiply is done in fp32.
#include "common.cuh"

namespace {

template <typename T, int RED, bool WEIGHTED>
__global__ void gsr_kernel(const T* __restrict__ h, const int* __restrict__ gidx,
                           const int* __restrict__ seg, const T* __restrict__ w,
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
      seg, r0, r1, lo, hi,
      [&](int64_t i) {
        float x = to_f(h[(int64_t)gidx[i] * feat + f]);
        if (WEIGHTED) x *= to_f(w[i]);
        return x;
      },
      [&](int s, float v) { out[(int64_t)s * feat + f] = from_f<T>(v); });
}

template <typename T, int RED, bool WEIGHTED>
void launch(dim3 grid, dim3 block, cudaStream_t st, const void* h, const void* gidx,
            const void* seg, const void* w, const void* cf, const void* cc, void* out,
            int64_t num_rows, int feat, int num_segments, int s_b, int m_b) {
  gsr_kernel<T, RED, WEIGHTED><<<grid, block, 0, st>>>(
      (const T*)h, (const int*)gidx, (const int*)seg, (const T*)w, (const int*)cf,
      (const int*)cc, (T*)out, num_rows, feat, num_segments, s_b, m_b);
}

template <typename T>
bool dispatch(int reduce, int weighted, dim3 grid, dim3 block, cudaStream_t st,
              const void* h, const void* gidx, const void* seg, const void* w,
              const void* cf, const void* cc, void* out, int64_t num_rows, int feat,
              int num_segments, int s_b, int m_b) {
#define GSR_CASE(RED, WT)                                                            \
  if (reduce == RED && (weighted != 0) == WT) {                                      \
    launch<T, RED, WT>(grid, block, st, h, gidx, seg, w, cf, cc, out, num_rows, feat, \
                       num_segments, s_b, m_b);                                      \
    return true;                                                                     \
  }
  GSR_CASE(RED_SUM, false)
  GSR_CASE(RED_SUM, true)
  GSR_CASE(RED_MEAN, false)
  GSR_CASE(RED_MEAN, true)
  GSR_CASE(RED_MAX, false)
  GSR_CASE(RED_MAX, true)
#undef GSR_CASE
  return false;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// n_b bounds the threads of a block (one feature column each).
extern "C" int gsr_launch(int dtype, int reduce, int weighted, const void* h,
                          const void* gidx, const void* seg, const void* w,
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
    ok = dispatch<float>(reduce, weighted, grid, block, st, h, gidx, seg, w, cf, cc, out,
                         num_rows, feat, num_segments, s_b, m_b);
  else if (dtype == DT_BF16)
    ok = dispatch<__nv_bfloat16>(reduce, weighted, grid, block, st, h, gidx, seg, w, cf,
                                 cc, out, num_rows, feat, num_segments, s_b, m_b);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

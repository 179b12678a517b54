// Softmax within sorted segments on Hopper (GAT attention):
//
//   out[i, h] = exp(x[i, h] - m[seg[i], h]) / max(z[seg[i], h], 1e-20)
//   m[s, h] = max_{seg[i]==s} x[i, h],  z[s, h] = sum_{seg[i]==s} exp(x[i, h] - m[s, h])
//
// Replaces the TPU kernel src/repro/kernels/segment_softmax.py:
// _segment_softmax_impl (body _softmax_body).
//
// What bounds it on the H100: bytes. Per edge it reads the segment id and
// H logits and writes H probabilities, a few flops an element; the floor is
// (4 + 2 * H * io) bytes an edge at 3.35 TB/s. The logits of one segment are
// read twice (statistics, then normalisation); the second read finds them
// in L1/L2, since it follows the first within the same segment.
//
// Design: the ownership window of the plan, as in gather_segment_reduce.cu.
// A group of `lanes` threads (heads rounded up to a power of two, at most a
// warp) owns segments [b*s_b, (b+1)*s_b) and walks the rows of its chunk
// range, one thread per head. Pass 1 keeps an online (max, sum-exp) pair in
// fp32 registers for the open segment; when the segment closes, pass 2
// re-walks just that segment's rows and writes exp(x - m) / max(z, 1e-20) in
// the io dtype. Rows are written only by the group owning their segment,
// so neighbouring windows never clobber each other's rows. Several groups
// share one CUDA block (128 threads), so a 4-head GAT still runs 32 windows
// per block. Rows with seg >= num_segments belong to no window; the wrapper
// allocates the output zero-filled so they come out exactly 0 (a later
// weighted sum multiplies by them, and 0 * garbage could be NaN).
#include "common.cuh"

namespace {

constexpr int THREADS = 128;

template <typename T>
__device__ __forceinline__ void emit(const T* __restrict__ x, T* __restrict__ out,
                                     int64_t a, int64_t e, int heads, int h, float m,
                                     float z) {
  const float denom = fmaxf(z, 1e-20f);
  for (int64_t j = a; j < e; ++j)
    out[j * heads + h] = from_f<T>(expf(to_f(x[j * heads + h]) - m) / denom);
}

template <typename T>
__global__ void ssm_kernel(const T* __restrict__ x, const int* __restrict__ seg,
                           const int* __restrict__ cf, const int* __restrict__ cc,
                           T* __restrict__ out, int64_t num_rows, int heads,
                           int num_segments, int s_b, int m_b, int out_blocks,
                           int lanes) {
  const int grp = threadIdx.x / lanes;
  const int lane = threadIdx.x % lanes;
  const int b = blockIdx.x * (blockDim.x / lanes) + grp;
  if (b >= out_blocks) return;
  const int lo = b * s_b;
  const int hi = min(lo + s_b, num_segments);
  int64_t r0, r1;
  block_rows(cf, cc, b, m_b, num_rows, &r0, &r1);

  for (int h = lane; h < heads; h += lanes) {
    int open = -1;
    int64_t start = r0;
    float m = 0.f, z = 0.f;
    int64_t i = r0;
    for (; i < r1; ++i) {
      const int s = seg[i];
      if (s < lo) continue;
      if (s >= hi) break;  // sorted: every later row is past the window
      const float v = to_f(x[i * heads + h]);
      if (s != open) {
        if (open >= 0) emit(x, out, start, i, heads, h, m, z);
        open = s;
        start = i;
        m = v;
        z = 1.f;
      } else {  // online update: rescale z to the new running max
        const float nm = max_nan(m, v);
        z = z * expf(m - nm) + expf(v - nm);
        m = nm;
      }
    }
    if (open >= 0) emit(x, out, start, i, heads, h, m, z);
  }
}

template <typename T>
void launch(int grid, int lanes, cudaStream_t st, const void* x, const void* seg,
            const void* cf, const void* cc, void* out, int64_t num_rows, int heads,
            int num_segments, int s_b, int m_b, int out_blocks) {
  ssm_kernel<T><<<grid, THREADS, 0, st>>>((const T*)x, (const int*)seg, (const int*)cf,
                                          (const int*)cc, (T*)out, num_rows, heads,
                                          num_segments, s_b, m_b, out_blocks, lanes);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// output must be zero-filled by the caller (rows of dropped segments).
extern "C" int ssm_launch(int dtype, const void* x, const void* seg, const void* cf,
                          const void* cc, void* out, int64_t num_rows, int heads,
                          int num_segments, int s_b, int m_b, int out_blocks,
                          void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  int lanes = 1;
  while (lanes < heads && lanes < 32) lanes *= 2;
  const int groups = THREADS / lanes;
  const int grid = (out_blocks + groups - 1) / groups;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_F32)
    launch<float>(grid, lanes, st, x, seg, cf, cc, out, num_rows, heads, num_segments, s_b,
                  m_b, out_blocks);
  else if (dtype == DT_BF16)
    launch<__nv_bfloat16>(grid, lanes, st, x, seg, cf, cc, out, num_rows, heads,
                          num_segments, s_b, m_b, out_blocks);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

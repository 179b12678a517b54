// Fused transform-aggregate on Hopper, SpMM + GEMM in one launch:
//
//   Y[s, :] = ( reduce_{i : seg[i] == s} wt[i] * H[gidx[i], :] ) @ W     reduce in {sum, mean}
//
// Replaces the TPU kernel src/repro/kernels/fused_transform_reduce.py:
// _fused_transform_reduce_impl (body _body).
//
// What bounds it on the H100: bytes at the served widths. The gather side
// reads the index stream and H rows like gather_segment_reduce.cu; the
// product adds 2 * d_in * d_out flops a node (8 kflop at 64 x 64), far below
// the fp32 ridge point, and W (16 KB at 64 x 64) is read once per block from
// L2. What the fusion saves is the (S, d_in) aggregate's round trip through
// device memory and a second launch.
//
// Design: the ownership window of the plan. CUDA block b owns segments
// [b*s_b, (b+1)*s_b). Phase 1 walks the rows of its chunk range in order,
// one thread per input column, with the running sum in an fp32 register;
// at each segment boundary the finished (mean-normalised) row goes into an
// (s_b, d_in) fp32 aggregate in shared memory. Phase 2 multiplies that
// aggregate, cast to the io dtype first as the reference does, by W, which
// streams through shared memory in K-tiles of KT rows; each thread keeps
// the fp32 sums of its outputs in an (s_b, d_out) fp32 tile in shared
// memory, and the block writes its s_b output rows in the io dtype. The
// product is this kernel's own FMA loop, no library call. A block that owns
// no rows writes zeros (0 @ W). Shared memory:
// 4 * s_b * (d_in + d_out) + KT * d_out * io bytes, the footprint that
// repro_torch.kernels.fused_transform_reduce.fusable checks against the
// 232,448 B a block may use.
#include "common.cuh"

#include <limits.h>

namespace {

constexpr int THREADS = 128;
constexpr int KT = 32;  // W rows per shared-memory tile (W_TILE_ROWS in Python)
constexpr int U = 4;    // rows whose loads are in flight together

template <typename T, bool MEAN, bool WEIGHTED>
__global__ void ftr_kernel(const T* __restrict__ h, const T* __restrict__ wm,
                           const int* __restrict__ gidx, const int* __restrict__ seg,
                           const T* __restrict__ wt, const int* __restrict__ cf,
                           const int* __restrict__ cc, T* __restrict__ out,
                           int64_t num_rows, int d_in, int d_out, int num_segments,
                           int s_b, int m_b) {
  extern __shared__ float smem[];
  float* agg = smem;                                 // (s_b, d_in) fp32
  float* oacc = agg + (size_t)s_b * d_in;            // (s_b, d_out) fp32
  T* wtile = (T*)(oacc + (size_t)s_b * d_out);       // (KT, d_out) io dtype

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lo = b * s_b;
  const int hi = min(lo + s_b, num_segments);
  const int nseg = hi - lo;
  T* yb = out + (int64_t)lo * d_out;
  if (cc[b] == 0) {  // owns no rows: 0 @ W
    for (int k = tid; k < nseg * d_out; k += blockDim.x) yb[k] = from_f<T>(0.f);
    return;
  }
  int64_t r0, r1;
  block_rows(cf, cc, b, m_b, num_rows, &r0, &r1);

  for (int k = tid; k < s_b * d_in; k += blockDim.x) agg[k] = 0.f;
  __syncthreads();

  // phase 1: the SR walk, one input column per thread
  for (int f = tid; f < d_in; f += blockDim.x) {
    int open = -1, cnt = 0;
    float acc = 0.f;
    bool done = false;
    for (int64_t i = r0; i < r1 && !done; i += U) {
      int s[U];
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) s[u] = (i + u < r1) ? seg[i + u] : INT_MAX;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        v[u] = 0.f;
        if (s[u] >= lo && s[u] < hi) {
          float x = to_f(h[(int64_t)gidx[i + u] * d_in + f]);
          if (WEIGHTED) x *= to_f(wt[i + u]);
          v[u] = x;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (s[u] < lo) continue;
        if (s[u] >= hi) {
          done = true;
          break;
        }
        if (s[u] != open) {
          if (open >= 0) agg[(open - lo) * d_in + f] = MEAN ? acc / (float)cnt : acc;
          open = s[u];
          acc = v[u];
          cnt = 1;
        } else {
          acc += v[u];
          ++cnt;
        }
      }
    }
    if (open >= 0) agg[(open - lo) * d_in + f] = MEAN ? acc / (float)cnt : acc;
  }

  // phase 2: (nseg, d_in) @ (d_in, d_out), W streamed in K-tiles
  for (int k = tid; k < nseg * d_out; k += blockDim.x) oacc[k] = 0.f;
  for (int k0 = 0; k0 < d_in; k0 += KT) {
    const int kt = min(KT, d_in - k0);
    __syncthreads();  // aggregate complete / previous tile consumed
    for (int t = tid; t < kt * d_out; t += blockDim.x)
      wtile[t] = wm[(int64_t)k0 * d_out + t];
    __syncthreads();
    for (int idx = tid; idx < nseg * d_out; idx += blockDim.x) {
      const int s = idx / d_out;
      const int o = idx - s * d_out;
      const float* arow = agg + s * d_in + k0;
      float sum = 0.f;
      for (int k = 0; k < kt; ++k)
        sum += to_f(from_f<T>(arow[k])) * to_f(wtile[k * d_out + o]);
      oacc[idx] += sum;
    }
  }
  for (int idx = tid; idx < nseg * d_out; idx += blockDim.x) yb[idx] = from_f<T>(oacc[idx]);
}

template <typename T, bool MEAN, bool WEIGHTED>
int launch(int grid, size_t smem, cudaStream_t st, const void* h, const void* wm,
           const void* gidx, const void* seg, const void* wt, const void* cf,
           const void* cc, void* out, int64_t num_rows, int d_in, int d_out,
           int num_segments, int s_b, int m_b) {
  auto kernel = ftr_kernel<T, MEAN, WEIGHTED>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, THREADS, smem, st>>>((const T*)h, (const T*)wm, (const int*)gidx,
                                      (const int*)seg, (const T*)wt, (const int*)cf,
                                      (const int*)cc, (T*)out, num_rows, d_in, d_out,
                                      num_segments, s_b, m_b);
  return 0;
}

template <typename T>
int dispatch(int mean, int weighted, int grid, cudaStream_t st, const void* h,
             const void* wm, const void* gidx, const void* seg, const void* wt,
             const void* cf, const void* cc, void* out, int64_t num_rows, int d_in,
             int d_out, int num_segments, int s_b, int m_b) {
  const size_t smem = sizeof(float) * (size_t)s_b * (d_in + d_out) +
                      sizeof(T) * (size_t)KT * d_out;
#define FTR_CASE(M, W)                                                                  \
  if ((mean != 0) == M && (weighted != 0) == W)                                         \
    return launch<T, M, W>(grid, smem, st, h, wm, gidx, seg, wt, cf, cc, out, num_rows, \
                           d_in, d_out, num_segments, s_b, m_b);
  FTR_CASE(false, false)
  FTR_CASE(false, true)
  FTR_CASE(true, false)
  FTR_CASE(true, true)
#undef FTR_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int ftr_launch(int dtype, int mean, int weighted, const void* h, const void* wm,
                          const void* gidx, const void* seg, const void* wt,
                          const void* cf, const void* cc, void* out, int64_t num_rows,
                          int d_in, int d_out, int num_segments, int s_b, int m_b,
                          int out_blocks, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  cudaStream_t st = (cudaStream_t)stream;
  int err;
  if (dtype == DT_F32)
    err = dispatch<float>(mean, weighted, out_blocks, st, h, wm, gidx, seg, wt, cf, cc, out,
                          num_rows, d_in, d_out, num_segments, s_b, m_b);
  else if (dtype == DT_BF16)
    err = dispatch<__nv_bfloat16>(mean, weighted, out_blocks, st, h, wm, gidx, seg, wt, cf,
                                  cc, out, num_rows, d_in, d_out, num_segments, s_b, m_b);
  else
    return (int)cudaErrorInvalidValue;
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

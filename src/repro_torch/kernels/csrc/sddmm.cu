// Sampled dense-dense matmul on Hopper (paper §VI):
//
//   out[i] = < A[row[i], :], B[col[i], :] >      i in [0, M)
//
// Replaces the TPU kernel src/repro/kernels/sddmm.py: sddmm_pallas (body
// _body).
//
// What bounds it on the H100: bytes. Per pair it reads two indices and two
// rows of N io elements and writes one value, against 2 * N flops; the
// floor counts each distinct row of A and B once (repeated rows hit L2).
//
// Design: a pure gather, no schedule metadata and no sortedness. A group of
// L lanes (8, 16 or 32, by N) owns one pair: the lanes read neighbouring
// columns of both rows, so each row read is coalesced, form fp32 products,
// reduce them with warp shuffles inside the group, and lane 0 writes the
// sum in the io dtype of A. The wrapper checks every index against the
// row counts on the host before the launch, so there is no guard row.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T, int L>
__global__ void __launch_bounds__(THREADS)
sddmm_kernel(const T* __restrict__ a, const T* __restrict__ b, const int* __restrict__ row,
             const int* __restrict__ col, T* __restrict__ out, int64_t m, int n) {
  const int lane = threadIdx.x % L;
  const int64_t i = (int64_t)blockIdx.x * (THREADS / L) + threadIdx.x / L;
  float acc = 0.f;
  if (i < m) {
    const T* ar = a + (int64_t)row[i] * n;
    const T* br = b + (int64_t)col[i] * n;
    for (int f = lane; f < n; f += L) acc = fmaf(to_f(ar[f]), to_f(br[f]), acc);
  }
  // every lane of the warp takes part in the shuffles, pairs past M too
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o, L);
  if (i < m && lane == 0) out[i] = from_f<T>(acc);
}

template <typename T>
void launch(int lanes, cudaStream_t st, const void* a, const void* b, const void* row,
            const void* col, void* out, int64_t m, int n) {
  const int64_t per_block = THREADS / lanes;
  const unsigned grid = (unsigned)((m + per_block - 1) / per_block);
  const T* ap = (const T*)a;
  const T* bp = (const T*)b;
  if (lanes == 8)
    sddmm_kernel<T, 8><<<grid, THREADS, 0, st>>>(ap, bp, (const int*)row, (const int*)col,
                                                 (T*)out, m, n);
  else if (lanes == 16)
    sddmm_kernel<T, 16><<<grid, THREADS, 0, st>>>(ap, bp, (const int*)row,
                                                  (const int*)col, (T*)out, m, n);
  else
    sddmm_kernel<T, 32><<<grid, THREADS, 0, st>>>(ap, bp, (const int*)row,
                                                  (const int*)col, (T*)out, m, n);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int sddmm_launch(int dtype, const void* a, const void* b, const void* row,
                            const void* col, void* out, int64_t m, int n, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  const int lanes = n <= 32 ? 8 : (n <= 128 ? 16 : 32);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_F32)
    launch<float>(lanes, st, a, b, row, col, out, m, n);
  else if (dtype == DT_BF16)
    launch<__nv_bfloat16>(lanes, st, a, b, row, col, out, m, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

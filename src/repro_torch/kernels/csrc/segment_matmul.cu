// Grouped matmul on Hopper, one launch for every relation:
//
//   out[r, :] = X[r, :] @ W[g]      for the rows r of group g, [off[g], off[g+1])
//
// Rows past off[G] belong to no group and are written as 0.
//
// Replaces the TPU kernel src/repro/kernels/segment_matmul.py:
// segment_matmul_pallas (body _body).
//
// What bounds it on the H100: bytes at the typed-GNN widths. A row costs
// K + N io elements of traffic against 2 * K * N flops, so at K = N = 64 in
// fp32 (16 flops a byte) it sits below the fp32 ridge point (20 flops a byte
// at 67 TFLOP/s and 3.35 TB/s); at 64 -> 128 it is just above. W (G x K x N,
// 2.2 MB at 133 x 64 x 64 fp32) is read once per row block from L2.
//
// Design: one CUDA block per (M_b-row block of the plan, 64-column tile of
// N). The block takes its group range from the plan metadata (first_group,
// group_count) and walks it in order, 64 rows at a time. For each group it
// stages X rows (rows of another group set to 0, as the TPU kernel masks
// them) and W[g] in K-tiles of 16 through shared memory, and 256 threads
// each keep a 4 x 4 fp32 tile of outputs in registers (plain FMA, no
// tensor cores yet). An empty group, or one that misses the tile, is
// skipped before any load: zipf-skewed relations leave many of them. Each
// output row is written once, by the block that owns it, so no atomics are
// needed. Row offsets are 64-bit: M * N reaches 7.7e8 at the AM graph.
#include "common.cuh"

namespace {

constexpr int BM = 64;        // rows of one tile
constexpr int BN = 64;        // output columns of one tile
constexpr int KT = 16;        // depth of one shared-memory stage
constexpr int TM = 4, TN = 4; // outputs a thread keeps
constexpr int THREADS = (BM / TM) * (BN / TN);

template <typename T>
__global__ void __launch_bounds__(THREADS)
smm_kernel(const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ off,
           const int* __restrict__ fg, const int* __restrict__ gc, T* __restrict__ out,
           int64_t num_rows, int k_dim, int n_dim, int num_groups, int m_b) {
  __shared__ float xs[KT][BM + 1];  // X tile, k-major; +1 keeps the stores off one bank
  __shared__ float ws[KT][BN];      // W tile
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int n0 = blockIdx.y * BN;
  const int64_t blk0 = (int64_t)blockIdx.x * m_b;
  const int64_t blk1 = min(blk0 + m_b, num_rows);
  const int g_first = max(fg[blockIdx.x], 0);
  const int g_end = min(fg[blockIdx.x] + gc[blockIdx.x], num_groups);

  for (int64_t t0 = blk0; t0 < blk1; t0 += BM) {
    const int64_t t1 = min(t0 + BM, blk1);
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int g = g_first; g < g_end; ++g) {
      const int64_t a = max((int64_t)off[g], t0);
      const int64_t e = min((int64_t)off[g + 1], t1);
      if (a >= e) continue;  // an empty group, or none of this tile's rows
      const T* wg = w + (size_t)g * k_dim * n_dim;
      for (int k0 = 0; k0 < k_dim; k0 += KT) {
        for (int i = tid; i < BM * KT; i += THREADS) {
          const int r = i / KT, k = i % KT;
          const int64_t row = t0 + r;
          float v = 0.f;
          if (row >= a && row < e && k0 + k < k_dim)
            v = to_f(x[(size_t)row * k_dim + k0 + k]);
          xs[k][r] = v;
        }
        for (int i = tid; i < KT * BN; i += THREADS) {
          const int k = i / BN, c = i % BN;
          float v = 0.f;
          if (k0 + k < k_dim && n0 + c < n_dim) v = to_f(wg[(size_t)(k0 + k) * n_dim + n0 + c]);
          ws[k][c] = v;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < KT; ++k) {
          float xr[TM], wc[TN];
#pragma unroll
          for (int i = 0; i < TM; ++i) xr[i] = xs[k][ty * TM + i];
#pragma unroll
          for (int j = 0; j < TN; ++j) wc[j] = ws[k][tx * TN + j];
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(xr[i], wc[j], acc[i][j]);
        }
        __syncthreads();
      }
    }
    // every row of the tile once; rows of no group kept their 0
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int64_t row = t0 + ty * TM + i;
      if (row >= t1) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = n0 + tx * TN + j;
        if (col < n_dim) out[(size_t)row * n_dim + col] = from_f<T>(acc[i][j]);
      }
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int smm_launch(int dtype, const void* x, const void* w, const void* off,
                          const void* fg, const void* gc, void* out, int64_t num_rows,
                          int k_dim, int n_dim, int num_groups, int m_b, int m_blocks,
                          void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  const dim3 grid(m_blocks, (n_dim + BN - 1) / BN);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_F32)
    smm_kernel<float><<<grid, THREADS, 0, st>>>(
        (const float*)x, (const float*)w, (const int*)off, (const int*)fg, (const int*)gc,
        (float*)out, num_rows, k_dim, n_dim, num_groups, m_b);
  else if (dtype == DT_BF16)
    smm_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const int*)off, (const int*)fg,
        (const int*)gc, (__nv_bfloat16*)out, num_rows, k_dim, n_dim, num_groups, m_b);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

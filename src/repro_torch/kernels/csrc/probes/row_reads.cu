// A probe, not a kernel of the port: the time it takes only to read the
// rows that a gather or sddmm reads, in the same order, with the same
// 16-byte vectors, and to do next to nothing with them.
//
//   out[t] = sum over the indices i of lane t's run of
//            < lane t's vector of A[row[i], :], that of B[col[i], :] >
//
// without A (a == nullptr) the sum of the B vectors alone. python -m
// repro_torch.kernel_variants times it beside sddmm (its A and B rows) and
// the fused transform-reduce (the H rows of its edges): what the card's L2,
// with HBM behind it, delivers for that access pattern.
//  * A group of G = n / V lanes (one 16-byte vector of a row a lane) owns
//    a run of RUN consecutive indices, as sddmm's lane groups do, and loads
//    an A row only where row[i] differs from the one before in its run, as
//    sddmm does.
//  * It keeps U rows in flight: U indices load, then U row vectors, then
//    their sums. No shuffle, no reduction across lanes, one fp32 word
//    written a lane.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T, int G, int U, bool WITH_A>
__global__ void __launch_bounds__(THREADS)
row_reads(const T* __restrict__ a, const int* __restrict__ row, const T* __restrict__ b,
          const int* __restrict__ col, float* __restrict__ out, int64_t m, int n, int run,
          int64_t num_runs) {
  constexpr int V = 16 / sizeof(T);
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t grp = t / G;
  const int sub = threadIdx.x % G;
  if (grp >= num_runs) return;
  const int64_t p0 = grp * run, p1 = min(p0 + (int64_t)run, m);
  float acc = 0.f, av[V];  // av: the lane's vector of the last A row (1 without A)
#pragma unroll
  for (int j = 0; j < V; ++j) av[j] = 1.f;
  int prev = -1;
  for (int64_t q0 = p0; q0 < p1; q0 += U) {
    int c[U], r[U];
    bool fresh[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool in = q0 + u < p1;
      c[u] = in ? __ldg(col + q0 + u) : -1;
      r[u] = WITH_A && in ? __ldg(row + q0 + u) : -1;
      fresh[u] = WITH_A && r[u] >= 0 && r[u] != (u == 0 ? prev : r[u - 1]);
    }
    uint4 vb[U], va[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      vb[u] = c[u] >= 0 ? __ldg(reinterpret_cast<const uint4*>(b + (int64_t)c[u] * n) + sub)
                        : uint4{};
      va[u] = fresh[u] ? __ldg(reinterpret_cast<const uint4*>(a + (int64_t)r[u] * n) + sub)
                       : uint4{};
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (fresh[u]) unpack<T, V>(va[u], av);
      float f[V];
      unpack<T, V>(vb[u], f);
#pragma unroll
      for (int j = 0; j < V; ++j) acc += av[j] * f[j];
    }
    prev = r[U - 1];
  }
  out[t] = acc;
}

template <typename T, int G, bool WITH_A>
bool by_u(int u, cudaStream_t st, const void* a, const void* row, const void* b,
          const void* col, void* out, int64_t m, int n, int run) {
  const int64_t runs = (m + run - 1) / run;
  const unsigned grid = (unsigned)((runs * G + THREADS - 1) / THREADS);
  const T *at = (const T*)a, *bt = (const T*)b;
  const int *rt = (const int*)row, *ct = (const int*)col;
  float* o = (float*)out;
  switch (u) {
    case 1: row_reads<T, G, 1, WITH_A><<<grid, THREADS, 0, st>>>(at, rt, bt, ct, o, m, n, run, runs); return true;
    case 2: row_reads<T, G, 2, WITH_A><<<grid, THREADS, 0, st>>>(at, rt, bt, ct, o, m, n, run, runs); return true;
    case 4: row_reads<T, G, 4, WITH_A><<<grid, THREADS, 0, st>>>(at, rt, bt, ct, o, m, n, run, runs); return true;
    case 8: row_reads<T, G, 8, WITH_A><<<grid, THREADS, 0, st>>>(at, rt, bt, ct, o, m, n, run, runs); return true;
  }
  return false;
}

template <typename T, bool WITH_A>
bool by_g(int g, int u, cudaStream_t st, const void* a, const void* row, const void* b,
          const void* col, void* out, int64_t m, int n, int run) {
  switch (g) {
    case 4: return by_u<T, 4, WITH_A>(u, st, a, row, b, col, out, m, n, run);
    case 8: return by_u<T, 8, WITH_A>(u, st, a, row, b, col, out, m, n, run);
    case 16: return by_u<T, 16, WITH_A>(u, st, a, row, b, col, out, m, n, run);
    case 32: return by_u<T, 32, WITH_A>(u, st, a, row, b, col, out, m, n, run);
  }
  return false;
}

template <typename T>
bool by_a(int g, int u, cudaStream_t st, const void* a, const void* row, const void* b,
          const void* col, void* out, int64_t m, int n, int run) {
  return a ? by_g<T, true>(g, u, st, a, row, b, col, out, m, n, run)
           : by_g<T, false>(g, u, st, a, row, b, col, out, m, n, run);
}

}  // namespace

// Reads the rows B[col[i]], and A[row[i]] unless `a` is null, of i in
// [0, m) on `stream`; `out` holds ceil(m / run) * (n * elem / 16) fp32
// words. Rows of 64 to 512 bytes, 16-byte aligned. Returns
// cudaGetLastError() (0 on success).
extern "C" int rows_launch(int dtype, const void* a, const void* row, const void* b,
                           const void* col, void* out, int64_t m, int n, int run, int u,
                           void* stream) {
  cudaGetLastError();
  const int es = dtype == DT_F32 ? 4 : 2;
  if (m < 1 || run < 1 || (dtype != DT_F32 && dtype != DT_BF16) || (n * es) % 16 != 0 ||
      (uintptr_t)b % 16 != 0 || (uintptr_t)a % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int g = n * es / 16;
  cudaStream_t st = (cudaStream_t)stream;
  const bool ok = dtype == DT_F32
                      ? by_a<float>(g, u, st, a, row, b, col, out, m, n, run)
                      : by_a<__nv_bfloat16>(g, u, st, a, row, b, col, out, m, n, run);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

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
// Design: runs of pairs, no schedule metadata and no sortedness required.
//  * A group of LPR = 8 lanes owns a run of RUN consecutive pairs; four
//    runs a warp. A lane holds NV vectors of at most 16 bytes of a row (F =
//    64 fp32: two 16-byte vectors; bf16: one), so each load instruction of
//    the warp reads 128 contiguous bytes of each of four rows. Narrower
//    vectors take widths off the 16-byte vector (F = 40 fp32: 4 elements,
//    F = 3: one), and the columns past F are masked.
//  * The group takes its run LPR pairs at a time: each lane loads one row
//    and one col index, coalesced (the next LPR pairs' while these are
//    used), and the indices go out by __shfl_sync. The A and B rows of U =
//    4 / NV pairs load together before any product.
//  * Row reuse: where a pair's row is the previous pair's (dst-sorted pairs
//    share A rows, 6.9 a row at ogbn-arxiv), its A row is not loaded again:
//    the lanes keep the last A row in registers. Unsorted pairs simply load
//    every row; nothing depends on order.
//  * Products are fp32. Lane k of the group ends with the dot product of
//    the group's k-th pair by a butterfly over the group (7 shuffles for 8
//    pairs, against 3 a pair for a tree each), so the 8 outputs are written
//    by neighbouring lanes, coalesced, in the io dtype of A.
//  * A row wider than four vectors a lane (F > 128 fp32, 256 bf16) takes
//    several column stretches into the same sums, without row reuse.
// The wrapper checks every index against the row counts on the host before
// the launch, so there is no guard row.
//
// What it leaves: on arxiv's dst-sorted pairs the A rows mostly come from
// registers, but every pair reads its B row (src, random over the nodes)
// through L2, 256 bytes at F = 64 fp32: 300 MB a launch, against a bound
// that counts each distinct row once. The read probe of the sweep below
// reads the same rows in the same order alone: the B rows in 0.0505 ms,
// the A and B rows in 0.0638, against the kernel's 0.0695 (fp32 F = 64).
//
// RUN = 32 and LPR = 8 are the sweep's choice (python -m
// repro_torch.kernel_variants --kernels sddmm; H100 80GB HBM3, 700 W): fp32
// F = 64 on the dst-sorted pairs took 0.0690 / 0.0692 / 0.0837 ms at RUN
// 16 / 32 / 64 and 0.0938 / 0.0692 / 0.0796 ms at LPR 4 / 8 / 16 (16: one
// vector a lane, four pairs' loads together; 4: four vectors, one pair);
// bf16 0.0404 / 0.0398 / 0.0444 and 0.0489 / 0.0398 / 0.0975, the shuffled
// pairs alike.
//
// The wide-row path (sddmm_wide, C entry sddmm_wide_launch). The MoE
// combine's router-weight gradient has rows of F = 2048, wider than one
// stretch of the runs kernel (F > 128 fp32, F > 256 bf16): it took the
// runs kernel's column stretches one after another, 16 blocks for 16,384
// pairs at 32 pairs a run, one pair's rows in flight a group, no A-row
// reuse, 12 % of the byte bound. The wide path gives the card enough
// loads in flight:
//  * A warp owns a run of WIDE_PAIRS consecutive pairs: 4,096 warps at
//    16,384 pairs. Lane u < WIDE_PAIRS loads pair u's indices; shuffles
//    hand them to the warp.
//  * The warp walks the columns in steps of WIDE_LOADS 16-byte vectors a
//    lane (neighbouring lanes on neighbouring addresses). In each step it
//    loads the vectors of all its pairs' B rows at once, WIDE_PAIRS *
//    WIDE_LOADS loads in flight a lane, before any product: the combine's
//    4,096 warps, about 31 an SM, keep some 64 KB of B in flight an SM.
//  * A-row reuse: a pair whose A row is the previous pair's in the run
//    loads no A vector; the lanes keep the last one in registers (the
//    combine's pairs are token-sorted, k = 8 to a token). A run starting
//    inside a token reads that row again, from L2 (the combine's A is 16.8
//    MB of the 50 MB L2): registers for the reuse within a run, L2 across
//    runs, and no shared memory that would cut the warps resident.
//  * B may be bf16 while A is fp32 (the backward's expert outputs): it is
//    loaded as bf16, at the vector width of A's 16 bytes, and widened in
//    registers, which gives bitwise the products of an fp32 copy.
//  * Products are fp32; each pair's sum is a butterfly over the warp's
//    lanes in a fixed order, so the result is bitwise the same from run to
//    run, written once, in A's dtype, by lane u for pair u.
// kernels/sddmm.py `path` sends a row to this path where it is wider than
// WIDE_MIN_BYTES; its note gives the measured crossing.
//
// WIDE_PAIRS = 4 and WIDE_LOADS = 1 are the sweep's choice (python -m
// repro_torch.kernel_variants --kernels sddmm; NVIDIA H100 80GB HBM3,
// 700.00 W), at the combine's 16,384 pairs of F = 2048, each swept with
// the other at its shipped value: fp32 B 0.0541 / 0.0550 / 0.0552 ms at 2
// / 4 / 8 pairs, 0.0544 / 0.0552 / 0.0565 at 1 / 2 / 4 loads; bf16 B under
// fp32 A 0.0331 / 0.0336 / 0.0344, 0.0337 / 0.0366 / 0.0344; both bf16
// 0.0317 / 0.0305 / 0.0308, 0.0305 / 0.0319 / 0.0339 (a first sweep with 2
// loads shipped put 1 load ahead by 2-10 %). A pair on half a warp (two
// runs a warp, 16 lanes a pair) lost in all three: 0.0575 / 0.0550 ms at
// 16 / 32 lanes with fp32 B, 0.0386 / 0.0336 with bf16 B, 0.0320 / 0.0307
// both bf16; a run is a whole warp. The runs
// kernel on the same pairs: 0.3647 (fp32), 0.2063 (bf16). Bound 0.0451 ms
// with fp32 B, 0.0251 with bf16 B: the fp32 case runs at 0.82 of it.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int LPR = 8;   // lanes a row
constexpr int RUN = 32;  // pairs a lane group owns

template <typename T, int V, int NV>
__global__ void __launch_bounds__(THREADS)
sddmm_runs(const T* __restrict__ a, const T* __restrict__ b, const int* __restrict__ row,
           const int* __restrict__ col, T* __restrict__ out, int64_t m, int n,
           int64_t num_runs) {
  static_assert(RUN % LPR == 0 && LPR >= 4 && LPR <= 16, "a run is whole butterflies");
  constexpr int GPW = 32 / LPR;       // runs (lane groups) a warp
  constexpr int CW = LPR * V * NV;    // columns one stretch covers
  constexpr int U = NV < 4 ? 4 / NV : 1;  // pairs whose rows load together
  const int lane = threadIdx.x & 31, sub = lane % LPR;
  const int64_t run = ((int64_t)blockIdx.x * THREADS + threadIdx.x) / 32 * GPW + lane / LPR;
  if (run >= num_runs) return;  // the whole group leaves together
  const unsigned gmask = ((1u << LPR) - 1u) << ((lane / LPR) * LPR);
  const int64_t p0 = run * RUN, p1 = min(p0 + (int64_t)RUN, m);
  const bool reuse = n <= CW;  // one stretch: the A row in registers stays valid
  int prev = -1;                // the row whose A values `acur` holds
  float acur[NV][V];
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) acur[k][j] = 0.f;

  int ri = p0 + sub < p1 ? row[p0 + sub] : -1;
  int ci = p0 + sub < p1 ? col[p0 + sub] : 0;
  for (int64_t q0 = p0; q0 < p1; q0 += LPR) {
    const int64_t q = q0 + sub, qn = q + LPR;
    // the next LPR pairs' indices load meanwhile
    const int rn = qn < p1 ? row[qn] : -1;
    const int cn = qn < p1 ? col[qn] : 0;
    float dot[LPR];
#pragma unroll
    for (int k = 0; k < LPR; ++k) dot[k] = 0.f;
    for (int c0 = 0; c0 < n; c0 += CW) {
#pragma unroll
      for (int u0 = 0; u0 < LPR; u0 += U) {
        int r[U];
        bool same[U];
        RawVec<T, V> ar[U][NV], br[U][NV];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          r[u] = __shfl_sync(gmask, ri, u0 + u, LPR);
          const int c = __shfl_sync(gmask, ci, u0 + u, LPR);
          same[u] = reuse && r[u] == (u == 0 ? prev : r[u - 1]);
#pragma unroll
          for (int k = 0; k < NV; ++k) {
            // vector k of the lane: the group reads LPR * V contiguous columns
            const int cc = c0 + k * (LPR * V) + sub * V;
            ar[u][k] = RawVec<T, V>{};
            br[u][k] = RawVec<T, V>{};
            if (r[u] >= 0 && cc < n) {
              if (!same[u])
                ar[u][k] = __ldg(reinterpret_cast<const RawVec<T, V>*>(a + (int64_t)r[u] * n + cc));
              br[u][k] = __ldg(reinterpret_cast<const RawVec<T, V>*>(b + (int64_t)c * n + cc));
            }
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int k = 0; k < NV; ++k) {
            if (!same[u]) unpack<T, V>(ar[u][k], acur[k]);
            float bv[V];
            unpack<T, V>(br[u][k], bv);
#pragma unroll
            for (int j = 0; j < V; ++j) dot[u0 + u] += acur[k][j] * bv[j];
          }
        }
        prev = r[U - 1];
      }
    }
    // butterfly: at offset o a lane keeps the half of its sums whose pair
    // index has bit o equal to its own, and adds its partner's; lane k ends
    // with the whole dot product of pair q0 + k
#pragma unroll
    for (int o = LPR / 2; o >= 1; o >>= 1) {
      const bool upper = sub & o;
#pragma unroll
      for (int k = 0; k < o; ++k) {
        const float send = upper ? dot[k] : dot[k + o];
        const float keep = upper ? dot[k + o] : dot[k];
        dot[k] = keep + __shfl_xor_sync(gmask, send, o, LPR);
      }
    }
    if (q < p1) out[q] = from_f<T>(dot[0]);
    ri = rn;
    ci = cn;
  }
}

template <typename T, int V, int NV>
void launch(cudaStream_t st, const void* a, const void* b, const void* row, const void* col,
            void* out, int64_t m, int n) {
  const int64_t runs = (m + RUN - 1) / RUN;
  const unsigned grid = (unsigned)((runs * LPR + THREADS - 1) / THREADS);
  sddmm_runs<T, V, NV><<<grid, THREADS, 0, st>>>((const T*)a, (const T*)b, (const int*)row,
                                                 (const int*)col, (T*)out, m, n, runs);
}

template <typename T, int V>
bool by_nv(int nv, cudaStream_t st, const void* a, const void* b, const void* row,
           const void* col, void* out, int64_t m, int n) {
  switch (nv) {
    case 1: launch<T, V, 1>(st, a, b, row, col, out, m, n); return true;
    case 2: launch<T, V, 2>(st, a, b, row, col, out, m, n); return true;
    case 3: launch<T, V, 3>(st, a, b, row, col, out, m, n); return true;
    case 4: launch<T, V, 4>(st, a, b, row, col, out, m, n); return true;
  }
  return false;
}

template <typename T>
bool by_vec(int v, int nv, cudaStream_t st, const void* a, const void* b, const void* row,
            const void* col, void* out, int64_t m, int n) {
  switch (v) {
    case 1: return by_nv<T, 1>(nv, st, a, b, row, col, out, m, n);
    case 2: return by_nv<T, 2>(nv, st, a, b, row, col, out, m, n);
    case 4: return by_nv<T, 4>(nv, st, a, b, row, col, out, m, n);
    case 8:
      if constexpr (sizeof(T) == 2) return by_nv<T, 8>(nv, st, a, b, row, col, out, m, n);
  }
  return false;
}

constexpr int WIDE_PAIRS = 4;   // consecutive pairs a warp owns
constexpr int WIDE_LOADS = 1;   // 16-byte vectors of each pair's rows a lane loads at once

template <typename TA, typename TB, int V>
__global__ void __launch_bounds__(THREADS)
sddmm_wide(const TA* __restrict__ a, const TB* __restrict__ b, const int* __restrict__ row,
           const int* __restrict__ col, TA* __restrict__ out, int64_t m, int n,
           int64_t num_runs) {
  constexpr int P = WIDE_PAIRS, NL = WIDE_LOADS;
  static_assert(P <= 32, "a warp's lanes hand out its pairs' indices");
  constexpr int CW = 32 * V * NL;  // columns one step of the warp covers
  const int sub = threadIdx.x & 31;
  const int64_t run = ((int64_t)blockIdx.x * THREADS + threadIdx.x) / 32;
  if (run >= num_runs) return;  // the whole warp leaves together
  const int64_t p0 = run * P;
  const bool mine = sub < P && p0 + sub < m;  // lane sub writes pair p0 + sub
  const int ri = mine ? row[p0 + sub] : -1;
  const int ci = mine ? col[p0 + sub] : 0;
  int r[P], c[P];
  bool fresh[P];  // pair u loads its A row: the run's first, or another row than u - 1's
#pragma unroll
  for (int u = 0; u < P; ++u) {
    r[u] = __shfl_sync(0xffffffffu, ri, u);
    c[u] = __shfl_sync(0xffffffffu, ci, u);
    fresh[u] = r[u] >= 0 && (u == 0 || r[u] != r[u - 1]);
  }
  float dot[P];
#pragma unroll
  for (int u = 0; u < P; ++u) dot[u] = 0.f;
  for (int c0 = 0; c0 < n; c0 += CW) {
    RawVec<TA, V> av[P][NL];
    RawVec<TB, V> bv[P][NL];
#pragma unroll
    for (int u = 0; u < P; ++u) {
#pragma unroll
      for (int k = 0; k < NL; ++k) {
        const int cc = c0 + (k * 32 + sub) * V;
        av[u][k] = RawVec<TA, V>{};
        bv[u][k] = RawVec<TB, V>{};
        if (r[u] >= 0 && cc < n) {
          if (fresh[u])
            av[u][k] = __ldg(reinterpret_cast<const RawVec<TA, V>*>(a + (int64_t)r[u] * n + cc));
          bv[u][k] = __ldg(reinterpret_cast<const RawVec<TB, V>*>(b + (int64_t)c[u] * n + cc));
        }
      }
    }
    float acur[NL][V];  // the lane's vectors of the last A row loaded
#pragma unroll
    for (int k = 0; k < NL; ++k)
#pragma unroll
      for (int j = 0; j < V; ++j) acur[k][j] = 0.f;
#pragma unroll
    for (int u = 0; u < P; ++u) {
#pragma unroll
      for (int k = 0; k < NL; ++k) {
        if (fresh[u]) unpack<TA, V>(av[u][k], acur[k]);
        float bf[V];
        unpack<TB, V>(bv[u][k], bf);
#pragma unroll
        for (int j = 0; j < V; ++j) dot[u] += acur[k][j] * bf[j];
      }
    }
  }
  // a butterfly over the warp's lanes in a fixed order: every lane ends
  // with every pair's sum, the same bits on each
  float mine_dot = 0.f;
#pragma unroll
  for (int u = 0; u < P; ++u) {
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], o);
    if (u == sub) mine_dot = dot[u];
  }
  if (mine) out[p0 + sub] = from_f<TA>(mine_dot);
}

template <typename TA, typename TB, int V>
void launch_wide(cudaStream_t st, const void* a, const void* b, const void* row,
                 const void* col, void* out, int64_t m, int n) {
  const int64_t runs = (m + WIDE_PAIRS - 1) / WIDE_PAIRS;
  const unsigned grid = (unsigned)((runs * 32 + THREADS - 1) / THREADS);
  sddmm_wide<TA, TB, V><<<grid, THREADS, 0, st>>>((const TA*)a, (const TB*)b, (const int*)row,
                                                  (const int*)col, (TA*)out, m, n, runs);
}

template <typename TA, typename TB>
bool wide_by_vec(int v, cudaStream_t st, const void* a, const void* b, const void* row,
                 const void* col, void* out, int64_t m, int n) {
  switch (v) {
    case 1: launch_wide<TA, TB, 1>(st, a, b, row, col, out, m, n); return true;
    case 2: launch_wide<TA, TB, 2>(st, a, b, row, col, out, m, n); return true;
    case 4: launch_wide<TA, TB, 4>(st, a, b, row, col, out, m, n); return true;
    case 8:
      if constexpr (sizeof(TA) == 2 && sizeof(TB) == 2) {
        launch_wide<TA, TB, 8>(st, a, b, row, col, out, m, n);
        return true;
      }
  }
  return false;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int sddmm_launch(int dtype, const void* a, const void* b, const void* row,
                            const void* col, void* out, int64_t m, int n, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (m < 1 || n < 1 || (dtype != DT_F32 && dtype != DT_BF16))
    return (int)cudaErrorInvalidValue;
  const int es = dtype == DT_F32 ? 4 : 2;
  // widest vector (at most 16 bytes) that divides a row and keeps A and B aligned
  int v = 16 / es;
  while (v > 1 && (n % v != 0 || ((uintptr_t)a % (v * es)) != 0 ||
                   ((uintptr_t)b % (v * es)) != 0))
    v /= 2;
  // vectors a lane: as many as span the row, at most 4 (then column stretches)
  int nv = (n + LPR * v - 1) / (LPR * v);
  if (nv > 4) nv = 4;
  cudaStream_t st = (cudaStream_t)stream;
  const bool ok = dtype == DT_F32 ? by_vec<float>(v, nv, st, a, b, row, col, out, m, n)
                                  : by_vec<__nv_bfloat16>(v, nv, st, a, b, row, col, out, m, n);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The wide-row path: launches on `stream` and returns cudaGetLastError() (0
// on success). A and the output in `dtype_a`, B in `dtype_b`: both fp32,
// both bf16, or an fp32 A with a bf16 B.
extern "C" int sddmm_wide_launch(int dtype_a, int dtype_b, const void* a, const void* b,
                                 const void* row, const void* col, void* out, int64_t m,
                                 int n, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  const bool f32_a = dtype_a == DT_F32, f32_b = dtype_b == DT_F32;
  if (m < 1 || n < 1 || (!f32_a && dtype_a != DT_BF16) || (!f32_b && dtype_b != DT_BF16) ||
      (!f32_a && f32_b))
    return (int)cudaErrorInvalidValue;
  const int ea = f32_a ? 4 : 2, eb = f32_b ? 4 : 2;
  // widest vector (at most 16 bytes of A) that divides a row and keeps A and B aligned
  int v = 16 / ea;
  while (v > 1 && (n % v != 0 || ((uintptr_t)a % (v * ea)) != 0 ||
                   ((uintptr_t)b % (v * eb)) != 0))
    v /= 2;
  cudaStream_t st = (cudaStream_t)stream;
  const bool ok =
      f32_a ? (f32_b ? wide_by_vec<float, float>(v, st, a, b, row, col, out, m, n)
                     : wide_by_vec<float, __nv_bfloat16>(v, st, a, b, row, col, out, m, n))
            : wide_by_vec<__nv_bfloat16, __nv_bfloat16>(v, st, a, b, row, col, out, m, n);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

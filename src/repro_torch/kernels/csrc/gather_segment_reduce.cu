// Fused gather + segment reduction on Hopper:
//
//   Y[s, f] = reduce_{i : seg[i] == s} (w[i] *) H[gidx[i], f]     reduce in {sum, mean, max}
//
// Replaces the TPU kernel src/repro/kernels/gather_segment_reduce.py:
// _gather_segment_reduce_impl (bodies _sr_body / _pr_body, row gather
// _gather_chunk).
//
// What bounds it on the H100: bytes. Each edge costs its index, segment and
// weight words and one gathered H row; each output row is written once. At
// 3.35 TB/s the floor is the index stream plus H read once plus Y written
// once (at ogbn-arxiv H is 169k x 64 x 4 B = 43 MB and stays in the 50 MB
// L2). In-degrees are skewed (arxiv: a 32-segment window holds up to 1,804
// rows, most nodes none), so a schedule that gives a block a fixed set of
// segments leaves one block walking the heaviest window while the card idles.
//
// Design: work is split by rows, not by segments (row_runs.cuh, whose
// templates segment_reduce.cu shares with an identity gather). Pass 1 cuts
// the sorted rows into runs of RUN rows (the config's M_b, chosen at run
// time among the built lengths), a lane group a run spanning an H row with
// 16-byte vector loads (a row that narrows them walked whole, not in column
// tiles: row_runs.cuh), and writes every segment that lies wholly
// inside its run; the segments cut by a run's ends leave fp32 partials.
// Pass 2, one lane group per output row from the plan's row_ptr, writes the
// empty segments and folds the partials in run order. No walk is longer
// than one run; no atomics, so the result is bitwise the same from run to
// run. One launch through gsr_launch is these two kernels.
//
// The owner path (gsr_owner, C entry gsr_owner_launch), for inputs of few
// rows: the MoE combine at decode gathers 64 rows of F = 2048 into 8 tokens.
// There the runs path is one run of M_b >= 64 rows walked by 8 warps, a
// second kernel (gsr_fix), and before both the row offsets built on the
// card (torch.arange, torch.searchsorted): four launches for 262 KB. The
// owner path is the TPU kernel's own schedule, an output owning its
// segments (src/repro/kernels/segment_reduce.py:13-21), in one launch:
//  * Each lane owns one (segment, vector of OWN_VEC_BYTES) of the output;
//    the lanes of a segment are neighbours, so a warp reads 32 contiguous
//    vectors of each H row and its index loads are one address.
//  * The lane finds its segment's rows itself: the lower bounds of s and
//    s + 1 in the sorted seg, two binary searches stepped together so
//    their loads are in flight at once. No row offsets are read or built.
//  * It walks the rows in order, OWN_ROWS rows of H in flight while the
//    next rows' indices load, with an fp32 running value, and writes its
//    vector of the output once: no partials, no second pass, no atomics,
//    so the result is bitwise the same from run to run.
// The semantics are the runs path's (row_runs.cuh): a dropped row (seg >=
// num_segments) lies past every searched segment's rows and is never read.
// A walk is as long as its segment, so kernels/gather_segment_reduce.py
// `path` keeps this path to inputs of at most OWNER_MAX_ROWS rows, where
// even one segment holding them all walks no longer than the runs path
// takes; its note gives the measured crossing.
#include "row_runs.cuh"

// OWN_ROWS = 8 and OWN_VEC_BYTES = 16 are the sweep's choice (python -m
// repro_torch.kernel_variants --kernels gather_segment_reduce; NVIDIA H100
// 80GB HBM3, 700.00 W), the decode combine / a hub of 128 bf16 rows of F =
// 2048, ms: 0.0077 / 0.0258, 0.0076 / 0.0255, 0.0085 / 0.0265 at 4 / 8 /
// 16 rows; 0.0075 / 0.0236, 0.0075 / 0.0248, 0.0077 / 0.0253 at 4 / 8 /
// 16 bytes. The main path's decode combine moves by less than 3 %; the
// narrower vectors help the hub (7 %) at the cost of four times the load
// instructions elsewhere.
constexpr int OWN_ROWS = 8;        // H rows in flight a lane
constexpr int OWN_VEC_BYTES = 16;  // the widest vector a lane owns of a row

namespace {

// [lo, hi): the rows of segment s in the sorted seg[0, n), the lower bounds
// of s and s + 1, searched together
__device__ __forceinline__ void segment_rows(const int* __restrict__ seg, int64_t n, int s,
                                             int64_t& lo, int64_t& hi) {
  int64_t a0 = 0, a1 = n, b0 = 0, b1 = n;
  while (a0 < a1 || b0 < b1) {
    const int64_t am = (a0 + a1) / 2, bm = (b0 + b1) / 2;
    const int va = a0 < a1 ? __ldg(seg + am) : 0;
    const int vb = b0 < b1 ? __ldg(seg + bm) : 0;
    if (a0 < a1) {
      if (va < s) a0 = am + 1; else a1 = am;
    }
    if (b0 < b1) {
      if (vb <= s) b0 = bm + 1; else b1 = bm;
    }
  }
  lo = a0;
  hi = b0;
}

// One lane a (segment, vector of V columns): the lanes of a segment are
// `vecs` neighbours, one a vector of the row.
template <typename T, int V, bool IS_MAX>
__global__ void __launch_bounds__(256)
gsr_owner(const T* __restrict__ h, const int* __restrict__ gidx, const int* __restrict__ seg,
          const T* __restrict__ w, T* __restrict__ out, int64_t num_rows, int feat,
          int num_segments, int vecs, int weighted, int mean) {
  constexpr int U = OWN_ROWS;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)num_segments * vecs) return;  // lanes share nothing: each leaves alone
  const int s = (int)(t / vecs);
  const int col = (int)(t % vecs) * V;
  int64_t lo, hi;
  segment_rows(seg, num_rows, s, lo, hi);

  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = IS_MAX ? -CUDART_INF_F : 0.f;  // an empty segment's
  auto load_idx = [&](int64_t i0, int (&gl)[U], float (&wl)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = i0 + u < hi;
      gl[u] = ok ? __ldg(gidx + i0 + u) : 0;
      wl[u] = (weighted && ok) ? to_f(w[i0 + u]) : 1.f;
    }
  };
  int g[U];
  float wt[U];
  load_idx(lo, g, wt);
  for (int64_t i0 = lo; i0 < hi; i0 += U) {
    RawVec<T, V> raw[U];  // the rows stay in the io dtype until they are used
#pragma unroll
    for (int u = 0; u < U; ++u)
      raw[u] = i0 + u < hi
                   ? __ldg(reinterpret_cast<const RawVec<T, V>*>(h + (int64_t)g[u] * feat + col))
                   : RawVec<T, V>{};
    int gn[U];
    float wn[U];
    load_idx(i0 + U, gn, wn);  // the next rows' indices load meanwhile
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i0 + u >= hi) break;
      float v[V];
      unpack<T, V>(raw[u], v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        v[j] *= wt[u];
        acc[j] = i0 + u == lo ? v[j] : combine<IS_MAX>(acc[j], v[j]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      g[u] = gn[u];
      wt[u] = wn[u];
    }
  }
  if (mean && hi > lo) {
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] /= (float)(hi - lo);
  }
  store_vec<T, V>(out + (int64_t)s * feat + col, acc);
}

struct OwnerArgs {
  const void *h, *gidx, *seg, *w;
  void* out;
  int64_t num_rows;
  int feat, num_segments, weighted, mean;
};

template <typename T, int V, bool IS_MAX>
void launch_owner(const OwnerArgs& a, cudaStream_t st) {
  const int vecs = (a.feat + V - 1) / V;
  const unsigned grid = (unsigned)(((int64_t)a.num_segments * vecs + 255) / 256);
  gsr_owner<T, V, IS_MAX><<<grid, 256, 0, st>>>(
      (const T*)a.h, (const int*)a.gidx, (const int*)a.seg, (const T*)a.w, (T*)a.out,
      a.num_rows, a.feat, a.num_segments, vecs, a.weighted, a.mean);
}

template <typename T, bool IS_MAX>
bool owner_by_vec(int v, const OwnerArgs& a, cudaStream_t st) {
  switch (v) {
    case 1: launch_owner<T, 1, IS_MAX>(a, st); return true;
    case 2: launch_owner<T, 2, IS_MAX>(a, st); return true;
    case 4: launch_owner<T, 4, IS_MAX>(a, st); return true;
    case 8:
      if constexpr (sizeof(T) == 2) {
        launch_owner<T, 8, IS_MAX>(a, st);
        return true;
      }
  }
  return false;
}

}  // namespace

// Launches both passes on `stream` and returns cudaGetLastError() (0 on
// success). `part` is fp32 scratch of 2 * ceil(num_rows / run_rows) rows of
// `feat`; `row_ptr` holds num_segments + 1 int64 row offsets of the sorted
// `seg`; `run_rows` is the run length, the config's M_b: one of the built
// instances RUN_LENGTHS (row_runs.cuh), any other is refused. On the H100
// (a sweep of build-time variants, PERF.md), runs of 128 or 256 rows
// left too few lane groups at the ogbn-arxiv bucket for narrow rows (F=3,
// F=32, bf16: up to 1.7x slower) and gained under 5 % on the 6M-row typed
// mean at AM; the measured PerfDB (repro_torch.core.autotune) picks per
// shape class.
extern "C" int gsr_launch(int dtype, int reduce, int weighted, const void* h,
                          const void* gidx, const void* seg, const void* w,
                          const void* row_ptr, void* part, void* out,
                          int64_t num_rows, int feat, int num_segments,
                          int run_rows, void* stream) {
#define GSR_RUN(R)                                                              \
  case R:                                                                       \
    return row_runs_launch<R, true>(dtype, reduce, weighted, h, gidx, seg, w,   \
                                    row_ptr, part, out, num_rows, feat,         \
                                    num_segments, stream);
  switch (run_rows) { FOR_RUN_LENGTHS(GSR_RUN) }
#undef GSR_RUN
  return (int)cudaErrorInvalidValue;
}

// The runs path in column tiles whatever the width: gsr_launch without the
// whole-row schedule (row_runs.cuh), its reference for tests and the sweep.
extern "C" int gsr_tiled_launch(int dtype, int reduce, int weighted, const void* h,
                                const void* gidx, const void* seg, const void* w,
                                const void* row_ptr, void* part, void* out,
                                int64_t num_rows, int feat, int num_segments,
                                int run_rows, void* stream) {
#define GSR_TILED_RUN(R)                                                        \
  case R:                                                                       \
    return row_runs_launch<R, true>(dtype, reduce, weighted, h, gidx, seg, w,   \
                                    row_ptr, part, out, num_rows, feat,         \
                                    num_segments, stream, true);
  switch (run_rows) { FOR_RUN_LENGTHS(GSR_TILED_RUN) }
#undef GSR_TILED_RUN
  return (int)cudaErrorInvalidValue;
}

// The owner path: one kernel on `stream`; returns cudaGetLastError() (0 on
// success). Reads no row offsets and no scratch.
extern "C" int gsr_owner_launch(int dtype, int reduce, int weighted, const void* h,
                                const void* gidx, const void* seg, const void* w, void* out,
                                int64_t num_rows, int feat, int num_segments, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (feat < 1 || num_segments < 1 || num_rows < 0 || reduce < RED_SUM || reduce > RED_MAX ||
      (dtype != DT_F32 && dtype != DT_BF16))
    return (int)cudaErrorInvalidValue;
  const int es = dtype == DT_F32 ? 4 : 2;
  // widest vector (at most OWN_VEC_BYTES) that divides a row and keeps H and Y aligned
  int v = OWN_VEC_BYTES / es;
  while (v > 1 && (feat % v != 0 || ((uintptr_t)h % (v * es)) != 0 ||
                   ((uintptr_t)out % (v * es)) != 0))
    v /= 2;
  const OwnerArgs a{h, gidx, seg, w, out, num_rows, feat, num_segments, weighted,
                    reduce == RED_MEAN};
  cudaStream_t st = (cudaStream_t)stream;
  const bool is_max = reduce == RED_MAX;
  bool ok;
  if (dtype == DT_F32)
    ok = is_max ? owner_by_vec<float, true>(v, a, st) : owner_by_vec<float, false>(v, a, st);
  else
    ok = is_max ? owner_by_vec<__nv_bfloat16, true>(v, a, st)
                : owner_by_vec<__nv_bfloat16, false>(v, a, st);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

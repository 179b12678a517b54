// Row runs: the schedule of the gather kernel (gather_segment_reduce.cu)
// and of segment_reduce (segment_reduce.cu), which is the same reduction
// with an identity gather and no weight:
//
//   Y[s, f] = reduce_{i : seg[i] == s} (w[i] *) H[GATHER ? gidx[i] : i, f]
//
// Work is split by rows, not by segments, so no walk is longer than one run
// whatever the degrees:
//  * Pass 1 (gsr_runs). The sorted rows are cut into runs of RUN
//    consecutive rows (a constant of the including kernel). A group of LPR
//    lanes owns one run and spans a feature row with 16-byte vector loads
//    (F = 64 fp32: 16 lanes a row, two runs a warp; bf16: 8 lanes, four
//    runs). The group loads its run's seg (and gidx, w) words
//    cooperatively, one coalesced word a lane, hands them out with
//    __shfl_sync, and keeps 8 rows in flight while the next indices are
//    already loading. It walks its run in order with an fp32 running value.
//    A segment that lies wholly inside the run is written to Y; the one or
//    two segments cut by the run's ends leave a partial in a scratch row
//    (slot 0: the segment of the run's first row, slot 1: that of its last
//    row).
//  * Pass 2 (gsr_fix), one lane group per output row: with the plan's row
//    offsets (row_ptr) it writes an empty segment as 0 (-inf for max), and
//    folds a cut segment's partials in run order, then divides a mean by
//    the segment's row count.
// Every output row is written once, by one of the two passes, with no
// atomics, in an order that does not depend on scheduling: the result is
// bitwise the same from run to run. A width that is not a multiple of the
// 16-byte vector runs the same template with 8-, 4- or 2-byte vectors; a
// row narrower than 4 lanes' vectors (F = 3) masks the lanes past F.
//
// Semantics: mean divides by max(count, 1); an empty max is -inf; an empty
// sum is 0; max propagates NaN; rows with seg >= num_segments never count
// and their rows of H are never read. The weight stays in the io dtype and
// the multiply is done in fp32. Row offsets into H, Y and the scratch, and
// row_ptr, are 64-bit.
//
// An including file instantiates only what it launches: the gather
// row_runs_launch<RUN, true>, segment_reduce row_runs_launch<RUN, false>
// (no gather index, no weight).
#pragma once

#include "common.cuh"

namespace {

template <bool IS_MAX>
__device__ __forceinline__ float combine(float a, float b) {
  return IS_MAX ? max_nan(a, b) : a + b;
}

// Pass 1: one group of LPR lanes per run of RUN rows; lane `sub` of the group
// holds columns [col, col + V) of the block's column tile.
template <typename T, int V, int LPR, bool IS_MAX, int RUN, bool GATHER>
__global__ void __launch_bounds__(256, 3)
gsr_runs(const T* __restrict__ h, const int* __restrict__ gidx,
         const int* __restrict__ seg, const T* __restrict__ w, float* __restrict__ part,
         T* __restrict__ out, int64_t num_rows, int feat, int num_segments,
         int64_t num_runs, int weighted, int mean) {
  constexpr int RPW = 32 / LPR;              // runs (lane groups) per warp
  constexpr int NB = LPR > 8 ? LPR : 8;      // rows per index round
  constexpr int IPL = NB / LPR;              // index words a lane loads per round
  constexpr int U = 8;                       // H rows in flight per group
  const int lane = threadIdx.x & 31, grp = lane / LPR, sub = lane % LPR;
  const int64_t run =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32 * RPW + grp;
  if (run >= num_runs) return;  // the whole group leaves together
  const unsigned gmask =
      LPR == 32 ? 0xffffffffu : (((1u << LPR) - 1u) << (grp * LPR));
  const int64_t r0 = run * RUN;
  const int64_t r1 = min(r0 + (int64_t)RUN, num_rows);
  const int first_seg = seg[r0];
  if (first_seg >= num_segments) return;  // sorted: only dropped rows from here
  const int col = blockIdx.y * (LPR * V) + sub * V;
  const bool col_ok = col < feat;
  const bool head_cut = r0 > 0 && seg[r0 - 1] == first_seg;

  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  int open = first_seg, cnt = 0;
  bool first = true;  // `open` is the segment of the run's first row

  // write the value of segment `open`: to Y, or as a partial if it is cut
  auto flush = [&](bool cut) {
    if (!col_ok) return;
    if (cut) {
      float* p = part + ((run * 2 + (first ? 0 : 1)) * (int64_t)feat + col);
#pragma unroll
      for (int j = 0; j < V; ++j) p[j] = acc[j];
    } else {
      float v[V];
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = mean ? acc[j] / (float)cnt : acc[j];
      store_vec<T, V>(out + (int64_t)open * feat + col, v);
    }
  };

  auto load_idx = [&](int64_t i0, int (&sl)[IPL], int (&gl)[IPL], float (&wl)[IPL]) {
#pragma unroll
    for (int q = 0; q < IPL; ++q) {
      const int64_t r = i0 + q * LPR + sub;
      const bool ok = r < r1;
      sl[q] = ok ? seg[r] : INT_MAX;
      if constexpr (GATHER) {
        gl[q] = ok ? gidx[r] : 0;
        wl[q] = (weighted && ok) ? to_f(w[r]) : 1.f;
      }
    }
  };

  int sl[IPL], gl[IPL];
  float wl[IPL];
  load_idx(r0, sl, gl, wl);
  bool done = false;
  for (int64_t i0 = r0; i0 < r1 && !done; i0 += NB) {
    int sn[IPL], gn[IPL];
    float wn[IPL];
    load_idx(i0 + NB, sn, gn, wn);  // next round's indices load meanwhile
#pragma unroll
    for (int u0 = 0; u0 < NB; u0 += U) {
      int s[U];
      float wt[U];
      RawVec<T, V> raw[U];  // the rows stay in the io dtype until they are used
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = u0 + u;
        s[u] = __shfl_sync(gmask, sl[t / LPR], t % LPR, LPR);
        int64_t hrow = i0 + t;  // the identity gather reads row i of X
        if constexpr (GATHER) {
          hrow = __shfl_sync(gmask, gl[t / LPR], t % LPR, LPR);
          wt[u] = __shfl_sync(gmask, wl[t / LPR], t % LPR, LPR);
        }
        raw[u] = RawVec<T, V>{};
        if (s[u] < num_segments && col_ok)
          raw[u] = __ldg(reinterpret_cast<const RawVec<T, V>*>(h + hrow * feat + col));
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (done) break;
        if (s[u] >= num_segments) {  // past the run, or dropped rows (sorted)
          done = true;
          break;
        }
        if (s[u] != open) {
          flush(first && head_cut);
          first = false;
          open = s[u];
          cnt = 0;
        }
        float v[V];
        unpack<T, V>(raw[u], v);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if constexpr (GATHER) v[j] *= wt[u];
          acc[j] = cnt == 0 ? v[j] : combine<IS_MAX>(acc[j], v[j]);
        }
        ++cnt;
      }
    }
#pragma unroll
    for (int q = 0; q < IPL; ++q) {
      sl[q] = sn[q];
      if constexpr (GATHER) {
        gl[q] = gn[q];
        wl[q] = wn[q];
      }
    }
  }
  const bool tail_cut = r1 < num_rows && seg[r1] == open;
  flush((first && head_cut) || tail_cut);
}

// Pass 2: one group of LPR lanes per output row; writes the empty segments
// and folds the partials of the cut ones in run order.
template <typename T, int V, int LPR, bool IS_MAX, int RUN>
__global__ void __launch_bounds__(256)
gsr_fix(const float* __restrict__ part, const int64_t* __restrict__ row_ptr,
        T* __restrict__ out, int feat, int num_segments, int mean) {
  constexpr int RPW = 32 / LPR;
  const int lane = threadIdx.x & 31, sub = lane % LPR;
  const int64_t s =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32 * RPW + lane / LPR;
  const int col = blockIdx.y * (LPR * V) + sub * V;
  if (s >= num_segments || col >= feat) return;
  const int64_t a = row_ptr[s], e = row_ptr[s + 1];
  float acc[V];
  if (a >= e) {
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = IS_MAX ? -CUDART_INF_F : 0.f;
    store_vec<T, V>(out + s * feat + col, acc);
    return;
  }
  const int64_t ka = a / RUN, kb = (e - 1) / RUN;
  if (ka == kb) return;  // whole inside one run: pass 1 wrote it
  const float* p = part + ((ka * 2 + (a == ka * RUN ? 0 : 1)) * (int64_t)feat + col);
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = p[j];
#pragma unroll 8
  for (int64_t k = ka + 1; k <= kb; ++k) {
    const float* q = part + (k * 2 * (int64_t)feat + col);
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = combine<IS_MAX>(acc[j], q[j]);
  }
  if (mean) {
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] /= (float)(e - a);
  }
  store_vec<T, V>(out + s * feat + col, acc);
}

struct RunArgs {
  const void *h, *gidx, *seg, *w, *row_ptr;
  void *part, *out;
  int64_t num_rows, num_runs;
  int feat, num_segments, weighted, mean;
};

template <typename T, int V, int LPR, bool IS_MAX, int RUN, bool GATHER>
void launch_passes(const RunArgs& a, cudaStream_t st) {
  constexpr int THREADS = 256, GROUPS = THREADS / 32 * (32 / LPR);
  const unsigned tiles = (unsigned)((a.feat + LPR * V - 1) / (LPR * V));
  if (a.num_runs > 0) {
    const dim3 grid((unsigned)((a.num_runs + GROUPS - 1) / GROUPS), tiles);
    gsr_runs<T, V, LPR, IS_MAX, RUN, GATHER><<<grid, THREADS, 0, st>>>(
        (const T*)a.h, (const int*)a.gidx, (const int*)a.seg, (const T*)a.w,
        (float*)a.part, (T*)a.out, a.num_rows, a.feat, a.num_segments,
        a.num_runs, a.weighted, a.mean);
  }
  const dim3 grid((unsigned)((a.num_segments + GROUPS - 1) / GROUPS), tiles);
  gsr_fix<T, V, LPR, IS_MAX, RUN><<<grid, THREADS, 0, st>>>(
      (const float*)a.part, (const int64_t*)a.row_ptr, (T*)a.out, a.feat,
      a.num_segments, a.mean);
}

template <typename T, int V, bool IS_MAX, int RUN, bool GATHER>
bool by_lanes(int lpr, const RunArgs& a, cudaStream_t st) {
  switch (lpr) {
    case 4: launch_passes<T, V, 4, IS_MAX, RUN, GATHER>(a, st); return true;
    case 8: launch_passes<T, V, 8, IS_MAX, RUN, GATHER>(a, st); return true;
    case 16: launch_passes<T, V, 16, IS_MAX, RUN, GATHER>(a, st); return true;
    case 32: launch_passes<T, V, 32, IS_MAX, RUN, GATHER>(a, st); return true;
  }
  return false;
}

template <typename T, bool IS_MAX, int RUN, bool GATHER>
bool by_vec(int v, int lpr, const RunArgs& a, cudaStream_t st) {
  switch (v) {
    case 1: return by_lanes<T, 1, IS_MAX, RUN, GATHER>(lpr, a, st);
    case 2: return by_lanes<T, 2, IS_MAX, RUN, GATHER>(lpr, a, st);
    case 4: return by_lanes<T, 4, IS_MAX, RUN, GATHER>(lpr, a, st);
    case 8:
      if constexpr (sizeof(T) == 2) return by_lanes<T, 8, IS_MAX, RUN, GATHER>(lpr, a, st);
  }
  return false;
}

// Launches both passes on `stream` and returns cudaGetLastError() (0 on
// success). `part` is fp32 scratch of 2 * ceil(num_rows / RUN) rows of
// `feat`; `row_ptr` holds num_segments + 1 int64 row offsets of the sorted
// `seg`. Without GATHER, `gidx` and `w` are not read.
template <int RUN, bool GATHER>
int row_runs_launch(int dtype, int reduce, int weighted, const void* h,
                    const void* gidx, const void* seg, const void* w,
                    const void* row_ptr, void* part, void* out, int64_t num_rows,
                    int feat, int num_segments, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (feat < 1 || reduce < RED_SUM || reduce > RED_MAX ||
      (dtype != DT_F32 && dtype != DT_BF16) || (!GATHER && weighted))
    return (int)cudaErrorInvalidValue;
  const int es = dtype == DT_F32 ? 4 : 2;
  // widest vector (at most 16 bytes) that divides a row and keeps H aligned
  int v = 16 / es;
  while (v > 1 && (feat % v != 0 || ((uintptr_t)h % (v * es)) != 0 ||
                   ((uintptr_t)out % (v * es)) != 0))
    v /= 2;
  // lane groups of 4 to 32; a row narrower than 4 vectors masks the rest
  int lpr = 4;
  while (lpr < 32 && lpr * v < feat) lpr *= 2;
  RunArgs a{h, gidx, seg, w, row_ptr, part, out, num_rows, (num_rows + RUN - 1) / RUN,
            feat, num_segments, weighted, reduce == RED_MEAN};
  cudaStream_t st = (cudaStream_t)stream;
  bool ok;
  const bool is_max = reduce == RED_MAX;
  if (dtype == DT_F32)
    ok = is_max ? by_vec<float, true, RUN, GATHER>(v, lpr, a, st)
                : by_vec<float, false, RUN, GATHER>(v, lpr, a, st);
  else
    ok = is_max ? by_vec<__nv_bfloat16, true, RUN, GATHER>(v, lpr, a, st)
                : by_vec<__nv_bfloat16, false, RUN, GATHER>(v, lpr, a, st);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// Softmax within sorted segments on Hopper (GAT attention):
//
//   out[i, h] = exp(x[i, h] - m[seg[i], h]) / max(z[seg[i], h], 1e-20)
//   m[s, h] = max_{seg[i]==s} x[i, h] (0 where it is not finite),
//   z[s, h] = sum_{seg[i]==s} exp(x[i, h] - m[s, h])
//
// Replaces the TPU kernel src/repro/kernels/segment_softmax.py:
// _segment_softmax_impl (body _softmax_body).
//
// What bounds it on the H100: bytes. Per edge it reads the segment id and
// H logits and writes H probabilities, a few flops an element; the floor is
// (4 + 2 * H * io) bytes an edge at 3.35 TB/s (the ogbn-arxiv bucket, fp32
// (E, 4): 0.017 ms). Degrees are skewed, so a schedule that gives a group of
// threads a fixed set of segments leaves the heaviest window's group
// walking it, one dependent exp after another, while the card idles.
//
// Design: work is split by rows, not by segments; no walk is longer than
// one run, whatever the degrees.
//  * Pass 1 (ssm_runs). The sorted rows are cut into runs of RUN (128)
//    rows, a warp a run and a tile of V heads (grid.y tiles the heads), and
//    lane L holds the run's PER_LANE consecutive rows from L * PER_LANE.
//    Where the tile is the whole row those rows are one stretch of memory
//    that the lane loads in 16-byte vectors ((E, 4) fp32: four a lane, 2 KB
//    a warp; (E, 2) two; (E,) one), all the run's loads issued together;
//    rows from row_ptr[num_segments] on are dropped and never read. Each
//    lane reduces its own rows in order, and a segmented shuffle scan over
//    the lanes (as many rounds as the longest segment's span of lanes
//    needs) leaves every row its segment's max over the run. Then
//    e = exp(x - m) and the same reduction sums e. A segment wholly inside
//    the run is written from registers as e / max(z, 1e-20): x is read once
//    for its rows. The one or two segments cut by the run's ends leave
//    their (m, z) over the run as a partial in two slots of the run (slot
//    0: the segment of the run's first row, slot 1: that of its last row).
//    Dropped rows are written as exact 0.
//  * Pass 2 (ssm_fix), a thread per (run, head): the run in which a cut
//    segment starts folds its partials in run order, up to the run of its
//    last row (from the plan's int64 row_ptr), m = max of the m_k,
//    z = sum of z_k * exp(m_k - m), and writes the final (m, max(z, 1e-20))
//    over every one of them.
//  * Pass 3 (ssm_cut), a warp per run again: a run that cuts no segment
//    leaves at once; otherwise the rows of its cut segments, and only
//    those, are read once more (after the run's ids, all at once) and
//    written as exp(x - m) / z with the pair in the run's own slots.
// Every output element is written exactly once, by pass 1 or pass 3, with
// no atomics, in an order that does not depend on scheduling: the result is
// bitwise the same from run to run. One launch through ssm_launch is these
// three kernels.
//
// A max that is not finite counts as 0 (as the plain version and the JAX
// impl="ref" do), so a segment whose logits are all -inf comes out 0, not
// NaN; a NaN logit makes its segment NaN. fp32 arithmetic, io dtype in
// device memory; row offsets are 64-bit.
#include "common.cuh"

namespace {

// rows of one run: 32 lanes x PER_LANE. On the H100 at 700 W (python -m
// repro_torch.kernel_variants) 128 rows are within 0.4 % of the best of
// 64, 128, 256 and 512 on every shape it times: fp32 (E, 4) at the
// ogbn-arxiv bucket 0.0520 ms against 0.0518 / 0.0809 / 0.1473 for 64 /
// 256 / 512, bf16 (E, 4) 0.0381 against 0.0427 / 0.0576 / 0.1254, (E,)
// 0.0228 against 0.0265 / 0.0232 / 0.0276, fp32 (E, 2) over the AM typed
// rows 0.0978 against 0.1198 / 0.0977 / 0.1427. Shorter runs cut more
// segments, whose rows pass 3 reads again; longer ones hold more than the
// 80 registers of pass 1
constexpr int RUN = 128;
constexpr int PER_LANE = RUN / 32;  // rows a lane holds
constexpr unsigned FULL = 0xffffffffu;

// the plain version's rule: a max that is not finite counts as 0
__device__ __forceinline__ float finite_or_0(float m) {
  return fabsf(m) < CUDART_INF_F ? m : 0.f;
}

template <bool IS_MAX>
__device__ __forceinline__ float op(float a, float b) {
  return IS_MAX ? max_nan(a, b) : a + b;
}

// How the PER_LANE consecutive rows a lane holds sit in the run's
// segments (rows are sorted, so a segment is a stretch of rows and of lanes).
struct LaneSegs {
  unsigned same;      // bit p: row p continues the segment of row p - 1
  bool multi;         // a segment starts after the lane's first row
  bool cont;          // the first row continues the last segment of the lane before
  bool cont_next;     // the lane after continues this lane's last segment
  int start;          // the lane in which this lane's last segment starts
  int end;            // the lane in which a segment running on from this lane ends
  unsigned longest;   // the longest span of lanes of one segment, over the warp
};

__device__ __forceinline__ LaneSegs lane_segs(const int (&s)[PER_LANE], int lane) {
  LaneSegs ls;
  ls.same = 0;
#pragma unroll
  for (int p = 1; p < PER_LANE; ++p)
    if (s[p] == s[p - 1]) ls.same |= 1u << p;
  ls.multi = s[0] != s[PER_LANE - 1];
  const int before = __shfl_up_sync(FULL, s[PER_LANE - 1], 1);
  ls.cont = lane > 0 && before == s[0];
  const unsigned conts = __ballot_sync(FULL, ls.cont);
  ls.cont_next = lane < 31 && (conts >> (lane + 1) & 1u);
  // lanes whose last segment starts in them, and lanes in which the
  // segment holding their first row ends
  const unsigned starts = __ballot_sync(FULL, !ls.cont || ls.multi);
  const unsigned ends = __ballot_sync(FULL, ls.multi || !ls.cont_next);
  ls.start = 31 - __clz(starts & (FULL >> (31 - lane)));
  const int from = ls.multi ? lane + 1 : lane;  // the first lane the segment may end in
  const unsigned later = from < 32 ? ends & ~((1u << from) - 1u) : 0u;
  ls.end = later ? __ffs(later) - 1 : 31;
  ls.longest = __reduce_max_sync(FULL, (unsigned)(lane - ls.start + 1));
  return ls;
}

// The segment totals over the whole run, for every row, in a fixed order:
// within the lane a forward then a backward pass over its rows; across
// lanes a segmented shuffle scan of each lane's last-segment total (as many
// rounds as the longest segment's span of lanes needs), which leaves in the
// lane where a segment ends its total, and one shuffle brings it to the
// lanes before that hold rows of it.
template <bool IS_MAX, int V>
__device__ __forceinline__ void run_reduce(float (&t)[PER_LANE][V], const int (&s)[PER_LANE],
                                           const LaneSegs& ls, int lane) {
#pragma unroll
  for (int p = 1; p < PER_LANE; ++p)
    if (ls.same >> p & 1u)
#pragma unroll
      for (int j = 0; j < V; ++j) t[p][j] = op<IS_MAX>(t[p - 1][j], t[p][j]);
#pragma unroll
  for (int p = PER_LANE - 2; p >= 0; --p)
    if (ls.same >> (p + 1) & 1u)
#pragma unroll
      for (int j = 0; j < V; ++j) t[p][j] = t[p + 1][j];
  float scan[V];
#pragma unroll
  for (int j = 0; j < V; ++j) scan[j] = t[PER_LANE - 1][j];
  for (unsigned d = 1; d < ls.longest; d <<= 1) {
    const bool take = lane - (int)d >= ls.start;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float u = __shfl_up_sync(FULL, scan[j], d);
      if (take) scan[j] = op<IS_MAX>(u, scan[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    // the total of the lane's first segment up to this lane: all of it when
    // the segment ends here
    const float before = __shfl_up_sync(FULL, scan[j], 1);
    const float first = ls.cont ? op<IS_MAX>(before, t[0][j]) : t[0][j];
    const float far = __shfl_sync(FULL, first, ls.end);
#pragma unroll
    for (int p = 0; p < PER_LANE; ++p) {
      if (!ls.multi)
        t[p][j] = far;
      else if (s[p] == s[0])
        t[p][j] = first;
      else if (s[p] == s[PER_LANE - 1] && ls.cont_next)
        t[p][j] = far;
    }
  }
}

// A lane's PER_LANE consecutive rows of a tile of V heads: as one stretch
// of PER_LANE * V elements in vectors of up to 16 bytes when the tile is
// the whole row and the tensor is 16-byte aligned (`whole`), else row by
// row. Rows from `lim` on read as 0.
template <typename T, int V>
__device__ __forceinline__ void load_rows(const T* __restrict__ x, int64_t rb, int64_t lim,
                                          int heads, int col, bool whole,
                                          float (&v)[PER_LANE][V]) {
  constexpr int N = PER_LANE * V, W = N < 16 / (int)sizeof(T) ? N : 16 / (int)sizeof(T);
  if (whole && rb + PER_LANE <= lim) {
    T t[N];
#pragma unroll
    for (int c = 0; c < N / W; ++c) {
      const RawVec<T, W> r = __ldg(reinterpret_cast<const RawVec<T, W>*>(x + rb * V) + c);
      memcpy(t + c * W, &r, sizeof(r));
    }
#pragma unroll
    for (int p = 0; p < PER_LANE; ++p)
#pragma unroll
      for (int j = 0; j < V; ++j) v[p][j] = to_f(t[p * V + j]);
    return;
  }
#pragma unroll
  for (int p = 0; p < PER_LANE; ++p) {
    RawVec<T, V> raw{};
    if (rb + p < lim) raw = __ldg(reinterpret_cast<const RawVec<T, V>*>(x + (rb + p) * heads + col));
    unpack<T, V>(raw, v[p]);
  }
}

// Writes the rows p of bit p of `write`, in one stretch when all are
// written and the tile is the whole row.
template <typename T, int V>
__device__ __forceinline__ void store_rows(T* __restrict__ out, int64_t rb, int heads, int col,
                                           bool whole, unsigned write,
                                           const float (&o)[PER_LANE][V]) {
  constexpr int N = PER_LANE * V, W = N < 16 / (int)sizeof(T) ? N : 16 / (int)sizeof(T);
  if (whole && write == (1u << PER_LANE) - 1u) {
    T t[N];
#pragma unroll
    for (int p = 0; p < PER_LANE; ++p)
#pragma unroll
      for (int j = 0; j < V; ++j) t[p * V + j] = from_f<T>(o[p][j]);
#pragma unroll
    for (int c = 0; c < N / W; ++c) {
      RawVec<T, W> r;
      memcpy(&r, t + c * W, sizeof(r));
      reinterpret_cast<RawVec<T, W>*>(out + rb * V)[c] = r;
    }
    return;
  }
#pragma unroll
  for (int p = 0; p < PER_LANE; ++p)
    if (write >> p & 1u) store_vec<T, V>(out + (rb + p) * heads + col, o[p]);
}

// Which segments of a run are cut by its ends, from the segments of its
// first and last rows and of the rows just before and after it (-1 where
// there is none): slot 0 holds the partial of the first row's segment, slot
// 1 that of the last row's when it is another.
struct Cuts {
  bool first_cut, last_cut;
};

__device__ __forceinline__ Cuts run_cuts(int first, int last, int before, int after,
                                         int num_segments) {
  const bool tail = last < num_segments && after == last;
  return {first < num_segments && (before == first || (tail && last == first)),
          tail && last != first};
}

__device__ __forceinline__ int seg_or_none(const int* __restrict__ seg, int64_t r,
                                           int64_t num_rows) {
  return r >= 0 && r < num_rows ? seg[r] : -1;
}

// offset of the partial of `slot` of run `run`: m at [0, heads), z at
// [heads, 2 heads) from it
__device__ __forceinline__ int64_t slot_at(int64_t run, int slot, int heads) {
  return (run * 2 + slot) * 2 * (int64_t)heads;
}

// Pass 1: a warp per run of RUN rows and a tile of V heads; lane L holds
// rows [r0 + L * PER_LANE, r0 + (L + 1) * PER_LANE). Three blocks an SM (at
// most 80 registers): on the H100 more warps in flight beat the fp32 (E, 4)
// instance's 96 registers at two blocks.
template <typename T, int V>
__global__ void __launch_bounds__(256, 3)
ssm_runs(const T* __restrict__ x, const int* __restrict__ seg,
         const int64_t* __restrict__ row_ptr, float* __restrict__ part,
         T* __restrict__ out, int64_t num_rows, int heads, int num_segments,
         int64_t num_runs, int whole) {
  const int lane = threadIdx.x & 31;
  const int64_t run = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  if (run >= num_runs) return;  // the whole warp leaves together
  const int col = blockIdx.y * V;  // heads [col, col + V): V divides heads
  const int64_t r0 = run * RUN, r1 = min(r0 + (int64_t)RUN, num_rows);
  const int64_t rb = r0 + lane * PER_LANE;
  // rows from row_ptr[num_segments] on are dropped (their seg is
  // num_segments or more): their logits are never read, they are written 0
  const int64_t real = row_ptr[num_segments];
  unsigned rows = 0;  // bit p: row rb + p is a row of the run
#pragma unroll
  for (int p = 0; p < PER_LANE; ++p)
    if (rb + p < r1) rows |= 1u << p;
  if (r0 >= real) {
    const float zero[PER_LANE][V] = {};
    store_rows<T, V>(out, rb, heads, col, whole, rows, zero);
    return;
  }
  int s[PER_LANE];
#pragma unroll
  for (int p = 0; p < PER_LANE; ++p) s[p] = rb + p < r1 ? seg[rb + p] : INT_MAX;
  float v[PER_LANE][V];
  load_rows<T, V>(x, rb, min(r1, real), heads, col, whole, v);
  const int first = seg[r0], last = seg[r1 - 1];
  const Cuts c = run_cuts(first, last, seg_or_none(seg, r0 - 1, num_rows),
                          seg_or_none(seg, r1, num_rows), num_segments);
  const LaneSegs ls = lane_segs(s, lane);
  const int64_t tail = r1 - 1 - r0;  // the run's last row: lane tail / PER_LANE
  float* p0 = part + slot_at(run, 0, heads) + col;
  float* p1 = part + slot_at(run, 1, heads) + col;

  // the segment max over the run, for every row; the cut ones leave it
  float t[PER_LANE][V];
#pragma unroll
  for (int p = 0; p < PER_LANE; ++p)
#pragma unroll
    for (int j = 0; j < V; ++j) t[p][j] = v[p][j];
  run_reduce<true, V>(t, s, ls, lane);
#pragma unroll
  for (int p = 0; p < PER_LANE; ++p) {
    if (lane == 0 && p == 0 && c.first_cut)
#pragma unroll
      for (int j = 0; j < V; ++j) p0[j] = t[0][j];
    if (lane * PER_LANE + p == tail && c.last_cut)
#pragma unroll
      for (int j = 0; j < V; ++j) p1[j] = t[p][j];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      v[p][j] = expf(v[p][j] - finite_or_0(t[p][j]));
      t[p][j] = v[p][j];
    }
  }
  // the segment sum of exp(x - m) over the run
  run_reduce<false, V>(t, s, ls, lane);
#pragma unroll
  for (int p = 0; p < PER_LANE; ++p) {
    if (lane == 0 && p == 0 && c.first_cut)
#pragma unroll
      for (int j = 0; j < V; ++j) p0[heads + j] = t[0][j];
    if (lane * PER_LANE + p == tail && c.last_cut)
#pragma unroll
      for (int j = 0; j < V; ++j) p1[heads + j] = t[p][j];
    // the output, in place of the sums: dropped rows 0, cut ones left to
    // pass 3
    const bool dropped = rb + p >= real;
    if (!dropped && ((c.first_cut && s[p] == first) || (c.last_cut && s[p] == last)))
      rows &= ~(1u << p);
#pragma unroll
    for (int j = 0; j < V; ++j) t[p][j] = dropped ? 0.f : v[p][j] / fmaxf(t[p][j], 1e-20f);
  }
  store_rows<T, V>(out, rb, heads, col, whole, rows, t);
}

// Pass 2: a thread per (run, head). The run whose last segment is cut by
// its end and starts inside it (its first run) folds that segment's
// partials in run order and writes the final (m, max(z, 1e-20)) over every
// one of them, so that pass 3 finds it in its own run's slots.
__global__ void __launch_bounds__(256)
ssm_fix(const int* __restrict__ seg, const int64_t* __restrict__ row_ptr,
        float* __restrict__ part, int64_t num_rows, int heads, int num_segments,
        int64_t num_runs) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= num_runs * heads) return;
  const int64_t ka = i / heads;
  const int h = (int)(i % heads);
  const int64_t r0 = ka * RUN, r1 = min(r0 + (int64_t)RUN, num_rows);
  const int first = seg[r0], s = seg[r1 - 1];
  const int before = seg_or_none(seg, r0 - 1, num_rows);
  if (s >= num_segments || seg_or_none(seg, r1, num_rows) != s) return;  // not cut
  if (s == first && before == s) return;  // it starts in an earlier run
  const int64_t kb = (row_ptr[s + 1] - 1) / RUN;
  float* head = part + slot_at(ka, s == first ? 0 : 1, heads) + h;
  float m = head[0];
#pragma unroll 4
  for (int64_t k = ka + 1; k <= kb; ++k) m = max_nan(m, part[slot_at(k, 0, heads) + h]);
  const float mf = finite_or_0(m);
  // a partial whose m is -inf has z = 0 and weighs exp(-inf) = 0
  float z = head[heads] * expf(head[0] - mf);
#pragma unroll 4
  for (int64_t k = ka + 1; k <= kb; ++k) {
    const float* q = part + slot_at(k, 0, heads) + h;
    z += q[heads] * expf(q[0] - mf);
  }
  z = fmaxf(z, 1e-20f);
  head[0] = mf;
  head[heads] = z;
  for (int64_t k = ka + 1; k <= kb; ++k) {
    float* q = part + slot_at(k, 0, heads) + h;
    q[0] = mf;
    q[heads] = z;
  }
}

// Pass 3: a warp per run and head tile; writes the rows of the run's cut
// segments with the pairs pass 2 left in the run's own slots. A run that
// cuts no segment leaves before any load; otherwise the run's ids come in
// one round and then, all at once, its slots and the rows of x that lie in
// a cut segment (rows of whole segments and dropped rows are not read).
template <typename T, int V>
__global__ void __launch_bounds__(256)
ssm_cut(const T* __restrict__ x, const int* __restrict__ seg,
        const float* __restrict__ part, T* __restrict__ out, int64_t num_rows,
        int heads, int num_segments, int64_t num_runs) {
  const int lane = threadIdx.x & 31;
  const int64_t run = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  if (run >= num_runs) return;
  const int col = blockIdx.y * V;
  const int64_t r0 = run * RUN, r1 = min(r0 + (int64_t)RUN, num_rows);
  int s[PER_LANE];
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
    const int64_t r = r0 + k * 32 + lane;
    s[k] = r < r1 ? seg[r] : INT_MAX;
  }
  const int first = seg[r0], last = seg[r1 - 1];
  const Cuts c = run_cuts(first, last, seg_or_none(seg, r0 - 1, num_rows),
                          seg_or_none(seg, r1, num_rows), num_segments);
  if (!c.first_cut && !c.last_cut) return;  // the whole warp leaves together
  // the slot of each of the lane's rows, -1 for a row it does not write
  int slot[PER_LANE];
  RawVec<T, V> raw[PER_LANE];
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
    slot[k] = c.first_cut && s[k] == first ? 0 : c.last_cut && s[k] == last ? 1 : -1;
    raw[k] = RawVec<T, V>{};
    if (slot[k] >= 0)
      raw[k] = __ldg(reinterpret_cast<const RawVec<T, V>*>(x + (r0 + k * 32 + lane) * heads + col));
  }
  float m[2][V], z[2][V];
#pragma unroll
  for (int sl = 0; sl < 2; ++sl)
#pragma unroll
    for (int j = 0; j < V; ++j) {
      m[sl][j] = part[slot_at(run, sl, heads) + col + j];
      z[sl][j] = part[slot_at(run, sl, heads) + heads + col + j];
    }
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
    if (slot[k] < 0) continue;
    float o[V];
    unpack<T, V>(raw[k], o);
#pragma unroll
    for (int j = 0; j < V; ++j)
      o[j] = expf(o[j] - (slot[k] ? m[1][j] : m[0][j])) / (slot[k] ? z[1][j] : z[0][j]);
    store_vec<T, V>(out + (r0 + k * 32 + lane) * heads + col, o);
  }
}

template <typename T, int V>
void launch(const void* x, const void* seg, const void* row_ptr, void* part, void* out,
            int64_t num_rows, int heads, int num_segments, cudaStream_t st) {
  // a lane's rows are one stretch of memory when the tile is the whole row
  const int whole = heads == V && (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
  constexpr int THREADS = 256, WARPS = THREADS / 32;
  const int64_t num_runs = (num_rows + RUN - 1) / RUN;
  const dim3 grid((unsigned)((num_runs + WARPS - 1) / WARPS), (unsigned)(heads / V));
  ssm_runs<T, V><<<grid, THREADS, 0, st>>>((const T*)x, (const int*)seg,
                                           (const int64_t*)row_ptr, (float*)part,
                                           (T*)out, num_rows, heads, num_segments,
                                           num_runs, whole);
  const int64_t fix_threads = num_runs * heads;
  ssm_fix<<<(unsigned)((fix_threads + THREADS - 1) / THREADS), THREADS, 0, st>>>(
      (const int*)seg, (const int64_t*)row_ptr, (float*)part, num_rows, heads,
      num_segments, num_runs);
  ssm_cut<T, V><<<grid, THREADS, 0, st>>>((const T*)x, (const int*)seg, (const float*)part,
                                          (T*)out, num_rows, heads, num_segments,
                                          num_runs);
}

template <typename T>
bool by_vec(int v, const void* x, const void* seg, const void* row_ptr, void* part,
            void* out, int64_t num_rows, int heads, int num_segments, cudaStream_t st) {
  switch (v) {
    case 1: launch<T, 1>(x, seg, row_ptr, part, out, num_rows, heads, num_segments, st); return true;
    case 2: launch<T, 2>(x, seg, row_ptr, part, out, num_rows, heads, num_segments, st); return true;
    case 4: launch<T, 4>(x, seg, row_ptr, part, out, num_rows, heads, num_segments, st); return true;
  }
  return false;
}

}  // namespace

// Launches the three passes on `stream` and returns cudaGetLastError() (0 on
// success). `part` is fp32 scratch of 4 * heads * ceil(num_rows / run_rows)
// floats; `row_ptr` holds num_segments + 1 int64 row offsets of the sorted
// `seg`; `run_rows` is the caller's copy of RUN, which must match it. Every
// element of `out` is written.
extern "C" int ssm_launch(int dtype, const void* x, const void* seg, const void* row_ptr,
                          void* part, void* out, int64_t num_rows, int heads,
                          int num_segments, int run_rows, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (run_rows != RUN || heads < 1 || num_segments < 0 ||
      (dtype != DT_F32 && dtype != DT_BF16))
    return (int)cudaErrorInvalidValue;
  if (num_rows == 0) return 0;
  const int es = dtype == DT_F32 ? 4 : 2;
  // widest vector of at most 4 heads that divides a row and keeps x aligned
  int v = 4;
  while (v > 1 && (heads % v != 0 || ((uintptr_t)x % (v * es)) != 0 ||
                   ((uintptr_t)out % (v * es)) != 0))
    v /= 2;
  cudaStream_t st = (cudaStream_t)stream;
  const bool ok =
      dtype == DT_F32
          ? by_vec<float>(v, x, seg, row_ptr, part, out, num_rows, heads, num_segments, st)
          : by_vec<__nv_bfloat16>(v, x, seg, row_ptr, part, out, num_rows, heads,
                                  num_segments, st);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

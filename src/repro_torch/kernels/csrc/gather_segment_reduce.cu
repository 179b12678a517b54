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
// the sorted rows into runs of RUN rows, a lane group a run spanning an H
// row with 16-byte vector loads, and writes every segment that lies wholly
// inside its run; the segments cut by a run's ends leave fp32 partials.
// Pass 2, one lane group per output row from the plan's row_ptr, writes the
// empty segments and folds the partials in run order. No walk is longer
// than one run; no atomics, so the result is bitwise the same from run to
// run. One launch through gsr_launch is these two kernels.
#include "row_runs.cuh"

namespace {

// rows of one run. On the H100 (python -m repro_torch.kernel_variants),
// runs of 128 or 256 rows left too few lane groups at the ogbn-arxiv bucket
// for narrow rows (F=3, F=32, bf16: up to 1.7x slower) and gained under 5 %
// on the 6M-row typed mean at AM
constexpr int RUN = 64;

}  // namespace

// Launches both passes on `stream` and returns cudaGetLastError() (0 on
// success). `part` is fp32 scratch of 2 * ceil(num_rows / run_rows) rows of
// `feat`; `row_ptr` holds num_segments + 1 int64 row offsets of the sorted
// `seg`; `run_rows` is the caller's copy of RUN, which must match it.
extern "C" int gsr_launch(int dtype, int reduce, int weighted, const void* h,
                          const void* gidx, const void* seg, const void* w,
                          const void* row_ptr, void* part, void* out,
                          int64_t num_rows, int feat, int num_segments,
                          int run_rows, void* stream) {
  if (run_rows != RUN) return (int)cudaErrorInvalidValue;
  return row_runs_launch<RUN, true>(dtype, reduce, weighted, h, gidx, seg, w,
                                    row_ptr, part, out, num_rows, feat,
                                    num_segments, stream);
}

// Segment reduction on Hopper (paper Fig. 2):
//
//   Y[s, f] = reduce_{i : idx[i] == s} X[i, f]      reduce in {sum, mean, max}
//
// Replaces the TPU kernel src/repro/kernels/segment_reduce.py:
// segment_reduce_pallas (bodies _sr_body / _pr_body).
//
// What bounds it on the H100: bytes. Each row of X is read once, with its
// segment id, and each output row written once, against one add an
// element; the floor is (4 + F * io) bytes a row plus F * io an output row
// at 3.35 TB/s (ogbn-arxiv, F = 64 fp32: 346.6 MB, 0.1035 ms). Degrees are
// skewed, so a schedule that gives a block a fixed set of segments leaves
// the block with the heaviest window walking it while the card idles.
//
// Design: the gather kernel's row runs (row_runs.cuh) with an identity
// gather and no weight, X read in place. Pass 1 cuts the sorted rows into
// runs of RUN rows, a lane group a run spanning an X row with 16-byte
// vector loads (8-, 4- or 2-byte ones for widths off the vector), 8 rows in
// flight, and writes every segment that lies wholly inside its run; the one
// or two segments cut by the run's ends leave fp32 partials in two scratch
// slots of the run. Pass 2, one lane group per segment from the plan's
// int64 row_ptr, writes an empty segment as 0 (-inf for max), folds a cut
// segment's partials in run order and divides a mean by its row count. No
// walk is longer than one run; no atomics, so the result is bitwise the
// same from run to run. One launch through srd_launch is these two
// kernels. fp32 accumulation, output in the io dtype, NaN-propagating max,
// mean over max(count, 1); rows with idx >= num_segments are dropped.
#include "row_runs.cuh"

namespace {

// rows of one run: the gather's length (its sweep in
// python -m repro_torch.kernel_variants times this kernel's too)
constexpr int RUN = 64;

}  // namespace

// Launches both passes on `stream` and returns cudaGetLastError() (0 on
// success). `part` is fp32 scratch of 2 * ceil(num_rows / run_rows) rows of
// `feat`; `row_ptr` holds num_segments + 1 int64 row offsets of the sorted
// `seg`; `run_rows` is the caller's copy of RUN, which must match it.
extern "C" int srd_launch(int dtype, int reduce, const void* x, const void* seg,
                          const void* row_ptr, void* part, void* out,
                          int64_t num_rows, int feat, int num_segments,
                          int run_rows, void* stream) {
  if (run_rows != RUN) return (int)cudaErrorInvalidValue;
  return row_runs_launch<RUN, false>(dtype, reduce, 0, x, nullptr, seg, nullptr,
                                     row_ptr, part, out, num_rows, feat,
                                     num_segments, stream);
}

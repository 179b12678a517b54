"""Analytical H100 cost model of the port's segment kernels.

Plays the reference's two roles: it scores the lattice for the analytical
performance database (:mod:`repro_torch.core.perfdb`, from which the
committed rules are distilled when no measured PerfDB is given), and it
costs the three orders of a transform layer for
:func:`repro_torch.core.mp.choose_order`.

The rates are the ones PERF.md's bounds use (NVIDIA's data sheet, H100
SXM, 700 W): 3.35 TB/s of HBM, 67 TFLOP/s fp32 outside the tensor cores,
495 TFLOP/s TF32 and 989 TFLOP/s bf16 on them, 227 KB of shared memory a
block, 132 SMs of 2,048 threads; plus a launch's fixed cost and the time
of one round of rows in flight through L2 (an estimate, not a data-sheet
number). The schedules costed are the kernels' own:

  * row runs (the gather, segment_reduce: ``csrc/row_runs.cuh``): each row
    read once, with its index words; every run of M_b rows writes two fp32
    partial rows that the fix pass reads again; a lane group a run, so a
    short run count leaves the card's threads idle (the bytes then move at
    a lower rate, :func:`_rate_share`); no walk is longer than one run, but a hub's
    partials fold serially in the fix pass;
  * segment tiles (the fused kernel: ``csrc/fused_transform_reduce.cu``):
    a block a tile of S_b segments loads W once, walks the tile's rows
    split over its lane groups, folds and multiplies on the tensor cores;
    the tile's shared memory sets how many blocks an SM holds; the tile
    holding a hub walks the hub's rows alone after the others are done.

All times in seconds.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.config_space import KernelConfig


@dataclasses.dataclass(frozen=True)
class H100Spec:
    name: str = "h100_sxm"
    hbm_bw: float = 3.35e12             # bytes/s
    peak_flops_fp32: float = 67e12      # CUDA cores
    peak_flops_tf32: float = 495e12     # tensor cores, dense
    peak_flops_bf16: float = 989e12     # tensor cores, dense
    smem_per_block: int = 232_448       # bytes one block may use
    smem_per_sm: int = 233_472          # bytes one SM holds
    sms: int = 132
    threads_per_sm: int = 2048
    launch_s: float = 4e-6              # one kernel launch
    row_round_s: float = 0.5e-6         # one round of rows in flight via L2


H100 = H100Spec()

ROWS_IN_FLIGHT = 8          # a row-run lane group's (U in row_runs.cuh)
FUSED_ROWS_IN_FLIGHT = 4    # a fused lane group's (U in the fused kernel)
FUSED_THREADS = 256         # a fused block's
# The memory rate a schedule reaches with a share x of the card's threads
# busy: min(1, (x / OCCUPANCY) ** SHARE_EXP). From sweeps on the card
# (PERF.md): runs of 256 rows at arxiv's F = 32 (13 % of the
# threads, against 54 % at 64 rows) ran 1.7x slower; a fused tile of 128
# at 3 blocks an SM (38 %) ran 1.07x slower than 64 at 6 (75 %).
OCCUPANCY, SHARE_EXP = 0.5, 0.4


def _rate_share(busy_threads: float, spec: "H100Spec") -> float:
    x = busy_threads / (spec.sms * spec.threads_per_sm)
    return min(1.0, (x / OCCUPANCY) ** SHARE_EXP)


def _ceil(a: float, b: float) -> int:
    return int(math.ceil(a / b))


def lanes_per_row(n: int, dtype_bytes: int) -> int:
    """A lane group's lanes for rows of ``n`` io elements (the kernels'
    rule): the widest vector of at most 16 bytes that divides a row, then
    the fewest lanes, 4 to 32, that span it."""
    v = 16 // dtype_bytes
    while v > 1 and n % v:
        v //= 2
    lpr = 4
    while lpr < 32 and lpr * v < n:
        lpr *= 2
    return lpr


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    compute_s: float
    memory_s: float
    overhead_s: float

    @property
    def total_s(self) -> float:
        # the walk and the memory traffic overlap; launches serialise
        return max(self.compute_s, self.memory_s) + self.overhead_s

    def gflops(self, useful_flops: float) -> float:
        return useful_flops / self.total_s / 1e9


def _row_runs_cost(m: int, s: int, n: int, cfg: KernelConfig,
                   dtype_bytes: int, spec: H100Spec, skew: float,
                   index_bytes: int) -> CostBreakdown:
    m, s, n = max(int(m), 1), max(int(s), 1), max(int(n), 1)
    runs = _ceil(m, cfg.m_b)
    lanes = runs * lanes_per_row(n, dtype_bytes)
    card = spec.sms * spec.threads_per_sm
    share = _rate_share(lanes, spec)
    nbytes = (m * (index_bytes + n * dtype_bytes)     # rows, index words
              + s * n * dtype_bytes + (s + 1) * 8      # output, row_ptr
              + 2 * runs * n * 4 * 2)                  # partials out and in
    memory_s = nbytes / (spec.hbm_bw * share)
    waves = _ceil(lanes, card)
    walk_s = waves * cfg.m_b / ROWS_IN_FLIGHT * spec.row_round_s
    # the fix pass folds a hub's partials one run after another
    hub_rows = skew * m / s
    fold_s = hub_rows / cfg.m_b / ROWS_IN_FLIGHT * spec.row_round_s
    return CostBreakdown(walk_s + fold_s, memory_s, 2 * spec.launch_s)


def segment_reduce_cost(m: int, s: int, n: int, cfg: KernelConfig,
                        dtype_bytes: int = 4, spec: H100Spec = H100,
                        skew: float = 1.0) -> CostBreakdown:
    """segment_reduce's row runs: m rows of n io elements, each with its
    segment id, into s segments. ``skew`` (max / avg degree) lengthens the
    hub's fold."""
    return _row_runs_cost(m, s, n, cfg, dtype_bytes, spec, skew, 4)


def useful_flops(m: int, n: int) -> float:
    """One add per input element is the useful work of a segment sum."""
    return float(m) * float(n)


def spmm_cost(m: int, s: int, n: int, cfg: KernelConfig,
              dtype_bytes: int = 4, spec: H100Spec = H100,
              skew: float = 1.0) -> CostBreakdown:
    """The gather's row runs (gather + weight + segment reduce): each row
    reads its segment id, gather index and weight and one gathered row."""
    return _row_runs_cost(m, s, n, cfg, dtype_bytes, spec, skew,
                          8 + dtype_bytes)


def dense_matmul_cost(rows: int, d_in: int, d_out: int,
                      dtype_bytes: int = 4,
                      spec: H100Spec = H100) -> CostBreakdown:
    """(rows, d_in) @ (d_in, d_out): fp32 on the CUDA cores (TF32 is off
    in the port), bf16 on the tensor cores; one launch."""
    nbytes = (rows * d_in + d_in * d_out + rows * d_out) * dtype_bytes
    peak = spec.peak_flops_bf16 if dtype_bytes == 2 else spec.peak_flops_fp32
    return CostBreakdown(2.0 * rows * d_in * d_out / peak,
                         nbytes / spec.hbm_bw, spec.launch_s)


def fused_transform_reduce_cost(m: int, s: int, d_in: int, d_out: int,
                                cfg: KernelConfig, dtype_bytes: int = 4,
                                spec: H100Spec = H100,
                                skew: float = 1.0) -> CostBreakdown:
    """The fused kernel's segment tiles of S_b: every row read once with its
    gather index and weight, W loaded by every block, the output written
    once; no (S, d_in) aggregate in device memory and one launch. The
    product runs on the tensor cores (fp32 as 3xTF32). ``skew`` makes the
    tile holding the hub walk the hub's rows after the rest."""
    from repro_torch.kernels.fused_transform_reduce import smem_bytes
    m, s = max(int(m), 1), max(int(s), 1)
    es = dtype_bytes
    tile = cfg.s_b
    blocks = _ceil(s, tile)
    smem = smem_bytes(d_in, d_out, "bfloat16" if es == 2 else "float32",
                      tile)
    per_sm = max(1, min(spec.threads_per_sm // FUSED_THREADS,
                        spec.smem_per_sm // max(smem, 1)))
    resident = spec.sms * per_sm
    share = _rate_share(min(blocks, resident) * FUSED_THREADS, spec)
    nbytes = (m * (4 + es + d_in * es) + s * d_out * es + (s + 1) * 8
              + blocks * d_in * d_out * es)
    memory_s = nbytes / (spec.hbm_bw * share)
    groups = FUSED_THREADS // lanes_per_row(d_in, es)
    walk_rounds = m / blocks / groups / FUSED_ROWS_IN_FLIGHT
    tc = spec.peak_flops_bf16 if es == 2 else spec.peak_flops_tf32 / 3.0
    product_s = 2.0 * tile * d_in * d_out / (tc / spec.sms)
    block_s = walk_rounds * spec.row_round_s + product_s
    hub_s = skew * m / s / groups / FUSED_ROWS_IN_FLIGHT * spec.row_round_s
    compute_s = _ceil(blocks, resident) * block_s + hub_s
    return CostBreakdown(compute_s, memory_s, spec.launch_s)


def segment_softmax_cost(m: int, s: int, heads: int, dtype_bytes: int = 4,
                         spec: H100Spec = H100) -> CostBreakdown:
    """The softmax's row runs (128 rows, a constant of its kernel): every
    row's segment id and logits read and its output written; a run's
    (max, sum-exp) partials of its two cut segments written and read again;
    the row offsets read; three launches (runs, fold, cut rows)."""
    m, s = max(int(m), 1), max(int(s), 1)
    runs = _ceil(m, 128)
    nbytes = (m * (4 + 2 * heads * dtype_bytes) + (s + 1) * 8
              + runs * 2 * 2 * heads * 4 * 2)
    return CostBreakdown(0.0, nbytes / spec.hbm_bw, 3 * spec.launch_s)


def segment_matmul_cost(m: int, k: int, n: int, groups: int,
                        dtype_bytes: int = 4,
                        spec: H100Spec = H100) -> CostBreakdown:
    """The grouped GEMM on the tensor cores: X, every group's W and the
    output once; fp32 as 3xTF32 (three products a term); one launch."""
    nbytes = (m * k + groups * k * n + m * n) * dtype_bytes
    flops = 2.0 * m * k * n
    compute = (flops / spec.peak_flops_bf16 if dtype_bytes == 2
               else 3 * flops / spec.peak_flops_tf32)
    return CostBreakdown(compute, nbytes / spec.hbm_bw, spec.launch_s)


def sddmm_cost(m: int, rows: int, n: int, dtype_bytes: int = 4,
               spec: H100Spec = H100) -> CostBreakdown:
    """sddmm over m (row, col) pairs: both indices and the output a pair, a
    gathered row of B a pair, the ``rows`` distinct rows of A once (pairs
    arrive sorted by row); fp32 dot products; one launch."""
    nbytes = m * (8 + dtype_bytes + n * dtype_bytes) + rows * n * dtype_bytes
    return CostBreakdown(2.0 * m * n / spec.peak_flops_fp32,
                         nbytes / spec.hbm_bw, spec.launch_s)

"""Segment reduction (paper Fig. 2) and the chunk metadata of the plans:

    Y[s] = reduce_{i: idx[i]==s} X[i]      reduce ∈ {sum, mean, max}

  * :func:`segment_reduce_cuda` — the hand-written Hopper kernel
    (``csrc/segment_reduce.cu``, the gather kernel's row runs of
    ``csrc/row_runs.cuh`` with an identity gather). Replaces the TPU kernel
    ``repro/kernels/segment_reduce.py:segment_reduce_pallas``.
  * :func:`segment_reduce_ref` — the plain PyTorch version.
  * :func:`segment_reduce_blocked` — the kernel's schedule in plain
    PyTorch: runs of :data:`RUN_ROWS` rows that write whole segments or
    keep partials of cut ones, folded in run order over the plan's row
    offsets (the gather's mirror with an identity gather).

Semantics of all three: ``idx`` sorted non-decreasing; fp32 accumulation,
output in the io dtype of ``X``; an empty segment is ``-inf`` for max and 0
otherwise; mean is the sum over ``max(count, 1)``; rows with
``idx >= num_segments`` are dropped.

:func:`chunk_metadata` is the plans' window metadata, which no kernel of
the port reads (the plans keep it to compare one to one with the
reference's): output block ``b`` owns segment ids ``[b·S_b, (b+1)·S_b)``.
Because the segment index is sorted, the rows feeding block ``b`` form one
contiguous range; ``chunk_metadata`` maps ``b`` to the range of ``M_b``-row
chunks that covers it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.config_space import KernelConfig
from repro_torch.kernels import _build
from repro_torch.kernels.gather_segment_reduce import (
    DTYPE_CODE, REDUCES, _REDUCE_CODE, _reduce_rows, check_row_ptr,
    gather_segment_reduce_blocked)

# rows of one run of the kernel's schedule: the constant RUN of
# csrc/segment_reduce.cu, which the launch checks against this copy
RUN_ROWS = 64

launches = 0    # wrapper launches in this process (each is two kernels)


def chunk_metadata(idx, num_segments: int, s_b: int, m_b: int, m_pad: int):
    """Per-output-block chunk range over the padded row space.

    ``idx`` is the padded sorted segment index (a tensor on any device, or a
    numpy array, read in place as a CPU tensor). Returns ``(chunk_first,
    chunk_count)`` int32 tensors of shape (out_blocks,) on ``idx``'s device:
    block b reads row chunks ``[chunk_first[b], chunk_first[b] +
    chunk_count[b])``.
    """
    idx = torch.as_tensor(idx)
    out_blocks = (num_segments + s_b - 1) // s_b
    bounds = torch.arange(out_blocks + 1, dtype=idx.dtype,
                          device=idx.device) * s_b
    row_bound = torch.searchsorted(idx, bounds, side="left").to(torch.int32)
    lo, hi = row_bound[:-1], row_bound[1:]
    chunk_first = lo // m_b
    last = torch.maximum(hi - 1, lo) // m_b
    chunk_count = torch.where(hi > lo, last - chunk_first + 1,
                              torch.zeros_like(lo))
    return chunk_first.to(torch.int32), chunk_count.to(torch.int32)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _resolve_plan(plan, num_rows: int, num_segments: int,
                  config: Optional[KernelConfig],
                  max_chunks: Optional[int]):
    """Merge an optional SegmentPlan into (config, max_chunks).

    The plan's config wins when none is given explicitly; an explicit config
    must agree on the tiling the metadata was built for (s_b, m_b)."""
    if plan is None:
        return config, max_chunks
    plan.validate(num_rows, num_segments)
    if config is None:
        config = plan.config
    elif (config.s_b, config.m_b) != (plan.config.s_b, plan.config.m_b):
        raise ValueError(
            f"explicit config (s_b={config.s_b}, m_b={config.m_b}) conflicts "
            f"with plan tiling (s_b={plan.config.s_b}, m_b={plan.config.m_b})")
    if max_chunks is None:
        max_chunks = plan.max_chunks
    return config, max_chunks


def segment_reduce_ref(x, idx, num_segments: int, reduce: str = "sum"):
    """The plain version (``index_add_`` / ``scatter_reduce_`` in fp32);
    dropped rows land in a guard row that is sliced away."""
    seg = idx.long().clamp_max(num_segments)
    out = _reduce_rows(x.float(), seg, num_segments + 1, reduce)
    return out[:num_segments].to(x.dtype)


def segment_reduce_blocked(x, idx, num_segments: int, reduce: str, row_ptr,
                           run_rows: int = RUN_ROWS):
    """The CUDA kernel's row-run schedule in plain PyTorch: the gather's
    mirror (:func:`~repro_torch.kernels.gather_segment_reduce.
    gather_segment_reduce_blocked`) with the identity gather, runs of
    ``run_rows`` (the kernel's, unless a test asks for shorter runs)."""
    rows = torch.arange(int(idx.shape[0]), device=x.device)
    return gather_segment_reduce_blocked(x, rows, idx, num_segments, None,
                                         reduce, row_ptr, run_rows)


def segment_reduce_cuda(x, idx, num_segments: int, reduce: str, row_ptr):
    """Launch the Hopper kernel on the current stream (asynchronous): two
    kernels, the runs and the fix-up pass, counted as one launch.
    ``row_ptr`` is the segments' int64 row offsets on x's device (the
    plan's)."""
    global launches
    if reduce not in REDUCES:
        raise ValueError(f"unknown reduce: {reduce!r}")
    if not x.is_cuda:
        raise ValueError(f"segment_reduce: impl='cuda' needs CUDA tensors, "
                         f"got x on {x.device}")
    if x.dtype not in DTYPE_CODE:
        raise TypeError(f"segment_reduce: io dtype must be float32 or "
                        f"bfloat16, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("segment_reduce: x must be a contiguous 2-D tensor")
    num_rows, feat = (int(d) for d in x.shape)
    if (idx.device != x.device or idx.dtype != torch.int32
            or idx.shape != (num_rows,) or not idx.is_contiguous()):
        raise ValueError(f"segment_reduce: idx must be a contiguous "
                         f"({num_rows},) int32 tensor on {x.device}")
    check_row_ptr("segment_reduce", row_ptr, num_segments, x.device)
    out = torch.empty((num_segments, feat), dtype=x.dtype, device=x.device)
    if num_segments == 0 or feat == 0:
        return out
    runs = (num_rows + RUN_ROWS - 1) // RUN_ROWS
    part = torch.empty((2 * runs, feat), dtype=torch.float32, device=x.device)
    lib = _build.load("segment_reduce")
    with torch.cuda.device(x.device):
        err = lib.srd_launch(
            DTYPE_CODE[x.dtype], _REDUCE_CODE[reduce], _build.ptr(x),
            _build.ptr(idx), _build.ptr(row_ptr), _build.ptr(part),
            _build.ptr(out), num_rows, feat, num_segments, RUN_ROWS,
            _build.stream_of(x))
    _build.check(err, "segment_reduce")
    launches += 1
    return out

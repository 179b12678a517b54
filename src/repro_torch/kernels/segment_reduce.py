"""Segment reduction (paper Fig. 2):

    Y[s] = reduce_{i: idx[i]==s} X[i]      reduce ∈ {sum, mean, max}

  * :func:`segment_reduce_cuda` — the hand-written Hopper kernel
    (``csrc/segment_reduce.cu``, the gather kernel's row runs of
    ``csrc/row_runs.cuh`` with an identity gather). Replaces the TPU kernel
    ``repro/kernels/segment_reduce.py:segment_reduce_pallas``.
  * :func:`segment_reduce_ref` — the plain PyTorch version.
  * :func:`segment_reduce_blocked` — the kernel's schedule in plain
    PyTorch: runs of ``run_rows`` rows (the config's M_b) that write whole
    segments or keep partials of cut ones, folded in run order over the plan's row
    offsets (the gather's mirror with an identity gather).

Semantics of all three: ``idx`` sorted non-decreasing; fp32 accumulation,
output in the io dtype of ``X``; an empty segment is ``-inf`` for max and 0
otherwise; mean is the sum over ``max(count, 1)``; rows with
``idx >= num_segments`` are dropped.
"""
from __future__ import annotations

import torch

from repro_torch.core.config_space import DEFAULT_M_B
from repro_torch.kernels import _build
from repro_torch.kernels.gather_segment_reduce import (
    DTYPE_CODE, REDUCES, _REDUCE_CODE, _reduce_rows, alignment,
    check_row_ptr, check_run_rows, count_schedule,
    gather_segment_reduce_blocked, schedule)

launches = 0    # wrapper launches in this process (each is two kernels)
# the same launches by column schedule (the gather's rule,
# gather_segment_reduce.schedule)
schedule_launches = {"tiled": 0, "whole_row": 0}


def segment_reduce_ref(x, idx, num_segments: int, reduce: str = "sum"):
    """The plain version (``index_add_`` / ``scatter_reduce_`` in fp32);
    dropped rows land in a guard row that is sliced away."""
    seg = idx.long().clamp_max(num_segments)
    out = _reduce_rows(x.float(), seg, num_segments + 1, reduce)
    return out[:num_segments].to(x.dtype)


def segment_reduce_blocked(x, idx, num_segments: int, reduce: str, row_ptr,
                           run_rows: int = DEFAULT_M_B):
    """The CUDA kernel's row-run schedule in plain PyTorch: the gather's
    mirror (:func:`~repro_torch.kernels.gather_segment_reduce.
    gather_segment_reduce_blocked`) with the identity gather, runs of
    ``run_rows`` (the config's M_b, or shorter runs a test asks for)."""
    rows = torch.arange(int(idx.shape[0]), device=x.device)
    return gather_segment_reduce_blocked(x, rows, idx, num_segments, None,
                                         reduce, row_ptr, run_rows)


def segment_reduce_cuda(x, idx, num_segments: int, reduce: str, row_ptr,
                        run_rows: int = DEFAULT_M_B):
    """Launch the Hopper kernel on the current stream (asynchronous): two
    kernels, the runs and the fix-up pass, counted as one launch.
    ``row_ptr`` is the segments' int64 row offsets on x's device (the
    plan's); ``run_rows`` is the config's M_b, a built run length. The
    launch is the ``repro_torch::segment_reduce`` op."""
    if reduce not in REDUCES:
        raise ValueError(f"unknown reduce: {reduce!r}")
    check_run_rows("segment_reduce", run_rows)
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
    return torch.ops.repro_torch.segment_reduce(x, idx, num_segments, reduce,
                                                row_ptr, run_rows)


@torch.library.custom_op("repro_torch::segment_reduce", mutates_args=(),
                         device_types="cuda")
def _launch(x: torch.Tensor, idx: torch.Tensor, num_segments: int,
            reduce: str, row_ptr: torch.Tensor,
            run_rows: int) -> torch.Tensor:
    """The launch, for inputs :func:`segment_reduce_cuda` checked."""
    global launches
    num_rows, feat = (int(d) for d in x.shape)
    out = torch.empty((num_segments, feat), dtype=x.dtype, device=x.device)
    if num_segments == 0 or feat == 0:
        return out
    runs = (num_rows + run_rows - 1) // run_rows
    part = torch.empty((2 * runs, feat), dtype=torch.float32, device=x.device)
    lib = _build.load("segment_reduce", run_rows)
    with torch.cuda.device(x.device):
        err = lib.srd_launch(
            DTYPE_CODE[x.dtype], _REDUCE_CODE[reduce], _build.ptr(x),
            _build.ptr(idx), _build.ptr(row_ptr), _build.ptr(part),
            _build.ptr(out), num_rows, feat, num_segments, run_rows,
            _build.stream_of(x))
    _build.check(err, "segment_reduce")
    launches += 1
    count_schedule("segment_reduce", schedule_launches,
                   schedule(feat, x.dtype, alignment(x, out)))
    return out


@_launch.register_fake
def _(x, idx, num_segments, reduce, row_ptr, run_rows):
    return x.new_empty((num_segments, x.shape[1]))

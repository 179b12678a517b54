"""Fused message + aggregate (paper §IV, Listing 2):

    Y[s] = reduce_{i: seg[i]==s} (w[i]·) H[gidx[i]]     reduce ∈ {sum, mean, max}

Three versions of one function, all with the reference semantics (mean
divides by ``max(count, 1)``, an empty max is ``-inf``, an empty sum is 0,
rows with ``seg >= num_segments`` are dropped; fp32 accumulation, output in
the io dtype of ``h``):

  * :func:`gather_segment_reduce_cuda` — the hand-written Hopper kernel
    (``csrc/gather_segment_reduce.cu``; its note says what bounds it and
    how the design answers). Replaces the TPU kernel
    ``repro/kernels/gather_segment_reduce.py:_gather_segment_reduce_impl``.
  * :func:`gather_segment_reduce_ref` — the plain PyTorch version
    (``index_select`` + ``index_add_`` / ``scatter_reduce_`` in fp32).
  * :func:`gather_segment_reduce_blocked` — the kernel's schedule in plain
    PyTorch: runs of ``run_rows`` rows (the config's M_b) that write whole
    segments or keep partials of cut ones, then a pass over the plan's row offsets that writes empty
    segments and folds the partials in run order. It is the CPU evidence
    that the kernel's use of the plan metadata is right.

The weight rides the io dtype of ``h``; the multiply is done in fp32.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.config_space import DEFAULT_M_B, RUN_LENGTHS
from repro_torch.kernels import _build

REDUCES = ("sum", "mean", "max")
_REDUCE_CODE = {"sum": 0, "mean": 1, "max": 2}
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0    # wrapper launches in this process (each is two kernels)


def _empty_value(reduce: str) -> float:
    return float("-inf") if reduce == "max" else 0.0


def _reduce_rows(msg, seg, num_rows_out: int, reduce: str):
    """fp32 reduce of ``msg`` (N, F) rows into ``num_rows_out`` outputs."""
    feat = msg.shape[1]
    if reduce == "max":
        out = torch.full((num_rows_out, feat), float("-inf"),
                         dtype=torch.float32, device=msg.device)
        return out.scatter_reduce_(0, seg[:, None].expand(-1, feat), msg,
                                   "amax", include_self=True)
    out = torch.zeros((num_rows_out, feat), dtype=torch.float32,
                      device=msg.device).index_add_(0, seg, msg)
    if reduce == "mean":
        cnt = torch.zeros(num_rows_out, dtype=torch.float32,
                          device=msg.device).index_add_(
            0, seg, torch.ones_like(seg, dtype=torch.float32))
        out = out / cnt.clamp_min(1.0)[:, None]
    return out


def _messages(h, gather_idx, weight, rows=None):
    gidx = gather_idx.long() if rows is None else gather_idx[rows].long()
    msg = h.index_select(0, gidx).float()
    if weight is not None:
        w = weight if rows is None else weight[rows]
        msg = msg * w.float()[:, None]
    return msg


def gather_segment_reduce_ref(h, gather_idx, seg_idx, num_segments: int,
                              weight=None, reduce: str = "sum"):
    """The plain version. Dropped rows (``seg >= num_segments``) land in a
    guard row that is sliced away."""
    seg = seg_idx.long().clamp_max(num_segments)
    out = _reduce_rows(_messages(h, gather_idx, weight), seg,
                       num_segments + 1, reduce)
    return out[:num_segments].to(h.dtype)


def row_offsets(seg_idx, num_segments: int):
    """``(num_segments + 1,)`` int64 row offsets of a sorted segment index,
    computed where it lies: segment s owns rows ``[row_ptr[s],
    row_ptr[s+1])``; rows with ``seg >= num_segments`` lie past
    ``row_ptr[num_segments]``."""
    seg = torch.as_tensor(seg_idx)
    bounds = torch.arange(num_segments + 1, dtype=seg.dtype, device=seg.device)
    return torch.searchsorted(seg, bounds)


def gather_segment_reduce_blocked(h, gather_idx, seg_idx, num_segments: int,
                                  weight, reduce: str, row_ptr,
                                  run_rows: int = DEFAULT_M_B):
    """The CUDA kernel's row-run schedule in plain PyTorch. Pass 1: the rows
    are cut into runs of ``run_rows`` (the config's M_b: any built length,
    or a shorter one a test asks for to cut more segments at a small size);
    each run reduces its rows per segment, and
    writes a segment that lies wholly inside it to the output, or keeps the
    value as a partial (slot 0: the segment of the run's first row, slot 1:
    that of its last row) if the run's ends cut it. Pass 2, per segment from
    ``row_ptr``: an empty one is written as the empty value, a cut one as its
    partials folded in run order (a mean divided by its row count)."""
    num_rows, feat = int(seg_idx.shape[0]), int(h.shape[1])
    out = torch.empty((num_segments, feat), dtype=torch.float32,
                      device=h.device)
    rp = row_ptr.tolist()
    partial = {}
    for run in range((num_rows + run_rows - 1) // run_rows):
        r0, r1 = run * run_rows, min((run + 1) * run_rows, num_rows)
        seg = seg_idx[r0:r1].long()
        keep = seg < num_segments
        if not bool(keep.any()):
            continue
        rows = torch.arange(r0, r1, device=h.device)[keep]
        lo = int(seg[keep][0])
        vals = _reduce_rows(_messages(h, gather_idx, weight, rows),
                            seg[keep] - lo, int(seg[keep][-1]) - lo + 1,
                            "sum" if reduce == "mean" else reduce)
        for s in torch.unique_consecutive(seg[keep]).tolist():
            a, e = rp[s], rp[s + 1]
            if a < r0 or e > r1:
                partial[(run, 0 if s == lo else 1)] = vals[s - lo]
            else:
                out[s] = vals[s - lo] / (e - a) if reduce == "mean" \
                    else vals[s - lo]
    for s in range(num_segments):
        a, e = rp[s], rp[s + 1]
        if a == e:
            out[s] = _empty_value(reduce)
            continue
        ka, kb = a // run_rows, (e - 1) // run_rows
        if ka == kb:
            continue
        acc = partial[(ka, 0 if a == ka * run_rows else 1)]
        for k in range(ka + 1, kb + 1):
            acc = (torch.maximum(acc, partial[(k, 0)]) if reduce == "max"
                   else acc + partial[(k, 0)])
        out[s] = acc / (e - a) if reduce == "mean" else acc
    return out.to(h.dtype)


def check_rows(name: str, h, index_args, weight, num_rows: int) -> None:
    """Device, dtype, shape and contiguity checks before a kernel gets raw
    pointers (shared by the kernels that gather rows of ``h``)."""
    if not h.is_cuda:
        raise ValueError(f"{name}: impl='cuda' needs CUDA tensors, got "
                         f"h on {h.device}")
    if h.dtype not in DTYPE_CODE:
        raise TypeError(f"{name}: io dtype must be float32 or bfloat16, "
                        f"got {h.dtype}")
    if h.dim() != 2 or not h.is_contiguous():
        raise ValueError(f"{name}: h must be a contiguous 2-D tensor")
    for label, t in index_args.items():
        if (t.device != h.device or t.dtype != torch.int32 or t.dim() != 1
                or not t.is_contiguous()):
            raise ValueError(f"{name}: {label} must be a contiguous int32 "
                             f"1-D tensor on {h.device}")
    if weight is not None and (
            weight.device != h.device or weight.dtype != h.dtype
            or weight.shape != (num_rows,) or not weight.is_contiguous()):
        raise ValueError(f"{name}: weight must be a contiguous ({num_rows},) "
                         f"{h.dtype} tensor on {h.device}")


def check_row_ptr(name: str, row_ptr, num_segments: int, device) -> None:
    """The row offsets a row-run kernel reads: a contiguous
    ``(num_segments + 1,)`` int64 tensor on the data's device."""
    if (row_ptr.device != device or row_ptr.dtype != torch.int64
            or row_ptr.shape != (num_segments + 1,)
            or not row_ptr.is_contiguous()):
        raise ValueError(f"{name}: row_ptr must be a contiguous "
                         f"({num_segments + 1},) int64 tensor on {device}")


def check_run_rows(name: str, run_rows: int) -> None:
    """A run length the row-run kernels were built for, or ValueError
    before any launch."""
    if run_rows not in RUN_LENGTHS:
        raise ValueError(f"{name}: no kernel instance is built for runs of "
                         f"{run_rows} rows (M_b); built: {RUN_LENGTHS}")


def gather_segment_reduce_cuda(h, gather_idx, seg_idx, num_segments: int,
                               weight, reduce: str, row_ptr,
                               run_rows: int = DEFAULT_M_B):
    """Launch the Hopper kernel on the current stream (asynchronous): two
    kernels, the runs and the fix-up pass, counted as one launch.
    ``row_ptr`` is :func:`row_offsets` of ``seg_idx`` on h's device (the
    plan's); ``run_rows`` is the config's M_b, one of the built
    :data:`~repro_torch.core.config_space.RUN_LENGTHS`. The checks read
    only shapes and dtypes; the launch is the ``repro_torch::
    gather_segment_reduce`` op, whose fake gives the output's shape."""
    if reduce not in REDUCES:
        raise ValueError(f"unknown reduce: {reduce!r}")
    check_run_rows("gather_segment_reduce", run_rows)
    num_rows = int(seg_idx.shape[0])
    check_rows("gather_segment_reduce", h,
               {"gather_idx": gather_idx, "seg_idx": seg_idx}, weight,
               num_rows)
    if gather_idx.shape[0] != num_rows:
        raise ValueError("gather_idx and seg_idx must have the same length")
    check_row_ptr("gather_segment_reduce", row_ptr, num_segments, h.device)
    return torch.ops.repro_torch.gather_segment_reduce(
        h, gather_idx, seg_idx, num_segments, weight, reduce, row_ptr,
        run_rows)


@torch.library.custom_op("repro_torch::gather_segment_reduce",
                         mutates_args=(), device_types="cuda")
def _launch(h: torch.Tensor, gather_idx: torch.Tensor, seg_idx: torch.Tensor,
            num_segments: int, weight: Optional[torch.Tensor], reduce: str,
            row_ptr: torch.Tensor, run_rows: int) -> torch.Tensor:
    """The launch, for inputs :func:`gather_segment_reduce_cuda` checked."""
    global launches
    num_rows, feat = int(seg_idx.shape[0]), int(h.shape[1])
    out = torch.empty((num_segments, feat), dtype=h.dtype, device=h.device)
    if num_segments == 0 or feat == 0:
        return out
    runs = (num_rows + run_rows - 1) // run_rows
    part = torch.empty((2 * runs, feat), dtype=torch.float32, device=h.device)
    lib = _build.load("gather_segment_reduce", run_rows)
    with torch.cuda.device(h.device):
        err = lib.gsr_launch(
            DTYPE_CODE[h.dtype], _REDUCE_CODE[reduce], int(weight is not None),
            _build.ptr(h), _build.ptr(gather_idx), _build.ptr(seg_idx),
            _build.ptr(weight if weight is not None else h),
            _build.ptr(row_ptr), _build.ptr(part), _build.ptr(out),
            num_rows, feat, num_segments, run_rows, _build.stream_of(h))
    _build.check(err, "gather_segment_reduce")
    launches += 1
    return out


@_launch.register_fake
def _(h, gather_idx, seg_idx, num_segments, weight, reduce, row_ptr,
      run_rows):
    return h.new_empty((num_segments, h.shape[1]))

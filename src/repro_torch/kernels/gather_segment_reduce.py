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
    PyTorch: block by block over the plan's chunk ranges, masking the rows
    outside each ownership window exactly as the kernel does. It is the CPU
    evidence that the kernel's use of the plan metadata is right.

The weight rides the io dtype of ``h``; the multiply is done in fp32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

REDUCES = ("sum", "mean", "max")
_REDUCE_CODE = {"sum": 0, "mean": 1, "max": 2}
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0    # launches of the CUDA kernel in this process


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


def gather_segment_reduce_blocked(h, gather_idx, seg_idx, num_segments: int,
                                  weight, reduce: str, chunk_first,
                                  chunk_count, s_b: int, m_b: int):
    """The CUDA kernel's ownership-window schedule in plain PyTorch: block b
    reads rows ``[chunk_first[b]·m_b, (chunk_first[b]+chunk_count[b])·m_b)``
    clipped to the real rows, keeps those whose segment lies in
    ``[b·s_b, min((b+1)·s_b, num_segments))``, and writes exactly that
    window of the output."""
    num_rows, feat = int(seg_idx.shape[0]), int(h.shape[1])
    out = torch.empty((num_segments, feat), dtype=torch.float32,
                      device=h.device)
    for b, (cf, cc) in enumerate(zip(chunk_first.tolist(),
                                     chunk_count.tolist())):
        lo, hi = b * s_b, min((b + 1) * s_b, num_segments)
        r0 = cf * m_b
        r1 = min(r0 + cc * m_b, num_rows)
        seg = seg_idx[r0:r1].long()
        keep = (seg >= lo) & (seg < hi)
        rows = torch.arange(r0, max(r0, r1), device=h.device)[keep]
        out[lo:hi] = _reduce_rows(_messages(h, gather_idx, weight, rows),
                                  seg[keep] - lo, hi - lo, reduce)
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


def gather_segment_reduce_cuda(h, gather_idx, seg_idx, num_segments: int,
                               weight, reduce: str, chunk_first, chunk_count,
                               s_b: int, m_b: int, n_b: int = 256):
    """Launch the Hopper kernel on the current stream (asynchronous).
    ``chunk_first`` / ``chunk_count`` are the plan metadata on h's device;
    ``n_b`` caps the threads (feature columns) of one block."""
    global launches
    if reduce not in REDUCES:
        raise ValueError(f"unknown reduce: {reduce!r}")
    num_rows = int(seg_idx.shape[0])
    check_rows("gather_segment_reduce", h,
               {"gather_idx": gather_idx, "seg_idx": seg_idx,
                "chunk_first": chunk_first, "chunk_count": chunk_count},
               weight, num_rows)
    if gather_idx.shape[0] != num_rows:
        raise ValueError("gather_idx and seg_idx must have the same length")
    out_blocks = (num_segments + s_b - 1) // s_b
    if chunk_first.shape[0] != out_blocks or chunk_count.shape[0] != out_blocks:
        raise ValueError(f"plan metadata has {chunk_first.shape[0]} blocks, "
                         f"expected {out_blocks}")
    feat = int(h.shape[1])
    out = torch.empty((num_segments, feat), dtype=h.dtype, device=h.device)
    if num_segments == 0 or feat == 0:
        return out
    lib = _build.load("gather_segment_reduce")
    with torch.cuda.device(h.device):
        err = lib.gsr_launch(
            DTYPE_CODE[h.dtype], _REDUCE_CODE[reduce], int(weight is not None),
            _build.ptr(h), _build.ptr(gather_idx), _build.ptr(seg_idx),
            _build.ptr(weight if weight is not None else h),
            _build.ptr(chunk_first), _build.ptr(chunk_count), _build.ptr(out),
            num_rows, feat, num_segments, s_b, m_b, out_blocks, n_b,
            _build.stream_of(h))
    _build.check(err, "gather_segment_reduce")
    launches += 1
    return out

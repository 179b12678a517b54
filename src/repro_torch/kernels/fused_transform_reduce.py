"""Fully-fused transform-aggregate — SpMM + GEMM in one launch:

    Y[s, :] = ( reduce_{i: seg[i]==s} wt[i] · H[gidx[i], :] ) @ W

Linear reduces only (sum / mean): the transform distributes over the
reduction, so aggregating at width d_in and transforming per output block
computes the same function as transform-then-aggregate. The fp32 aggregate
is cast to the io dtype before the product, as the reference does.

  * :func:`fused_transform_reduce_cuda` — the hand-written Hopper kernel
    (``csrc/fused_transform_reduce.cu``). Replaces the TPU kernel
    ``repro/kernels/fused_transform_reduce.py:_fused_transform_reduce_impl``.
  * :func:`fused_transform_reduce_ref` — the plain PyTorch version.
  * :func:`fusable` — does one block's shared-memory footprint fit Hopper?
"""
from __future__ import annotations

import torch

from repro_torch.core.config_space import SMEM_BYTES, KernelConfig, io_dtype_bytes
from repro_torch.kernels import _build
from repro_torch.kernels.gather_segment_reduce import (DTYPE_CODE, check_rows,
                                                       gather_segment_reduce_ref)

W_TILE_ROWS = 32    # rows of W per shared-memory tile (KT in the .cu source)

launches = 0        # launches of the CUDA kernel in this process


def smem_bytes(d_in: int, d_out: int, dtype, config: KernelConfig) -> int:
    """One block's shared memory: the (s_b, d_in) fp32 aggregate, the
    (s_b, d_out) fp32 output sums, and one (W_TILE_ROWS, d_out) tile of W
    in the io dtype."""
    return (4 * config.s_b * (d_in + d_out)
            + W_TILE_ROWS * d_out * io_dtype_bytes(dtype))


def fusable(d_in: int, d_out: int, dtype, config: KernelConfig,
            budget: int = SMEM_BYTES) -> bool:
    """Does one launch's shared-memory footprint fit a Hopper block?"""
    return smem_bytes(d_in, d_out, dtype, config) <= budget


def fused_transform_reduce_ref(h, w, gather_idx, seg_idx, num_segments: int,
                               weight=None, reduce: str = "sum"):
    """The plain version: fp32 aggregate cast to the io dtype, then an fp32
    product cast to the io dtype."""
    agg = gather_segment_reduce_ref(h, gather_idx, seg_idx, num_segments,
                                    weight, reduce)
    return (agg.float() @ w.float()).to(h.dtype)


def fused_transform_reduce_cuda(h, w, gather_idx, seg_idx, num_segments: int,
                                weight, reduce: str, chunk_first, chunk_count,
                                config: KernelConfig):
    """Launch the Hopper kernel on the current stream (asynchronous)."""
    global launches
    if reduce not in ("sum", "mean"):
        raise ValueError(f"fused transform-reduce is linear-only: reduce "
                         f"must be sum or mean, got {reduce!r}")
    num_rows = int(seg_idx.shape[0])
    check_rows("fused_transform_reduce", h,
               {"gather_idx": gather_idx, "seg_idx": seg_idx,
                "chunk_first": chunk_first, "chunk_count": chunk_count},
               weight, num_rows)
    d_in, d_out = int(h.shape[1]), int(w.shape[1])
    if (w.device != h.device or w.dtype != h.dtype or w.dim() != 2
            or w.shape[0] != d_in or not w.is_contiguous()):
        raise ValueError(f"fused_transform_reduce: W must be a contiguous "
                         f"({d_in}, d_out) {h.dtype} tensor on {h.device}")
    if gather_idx.shape[0] != num_rows:
        raise ValueError("gather_idx and seg_idx must have the same length")
    if not fusable(d_in, d_out, h.dtype, config):
        raise ValueError(
            f"(d_in={d_in}, d_out={d_out}) needs "
            f"{smem_bytes(d_in, d_out, h.dtype, config)} B of shared memory "
            f"for config {config}, over the {SMEM_BYTES} B of a Hopper "
            f"block; use the two-launch mp_transform path")
    s_b, m_b = config.s_b, config.m_b
    out_blocks = (num_segments + s_b - 1) // s_b
    if chunk_first.shape[0] != out_blocks or chunk_count.shape[0] != out_blocks:
        raise ValueError(f"plan metadata has {chunk_first.shape[0]} blocks, "
                         f"expected {out_blocks}")
    out = torch.empty((num_segments, d_out), dtype=h.dtype, device=h.device)
    if num_segments == 0 or d_out == 0:
        return out
    lib = _build.load("fused_transform_reduce")
    with torch.cuda.device(h.device):
        err = lib.ftr_launch(
            DTYPE_CODE[h.dtype], int(reduce == "mean"), int(weight is not None),
            _build.ptr(h), _build.ptr(w), _build.ptr(gather_idx),
            _build.ptr(seg_idx),
            _build.ptr(weight if weight is not None else h),
            _build.ptr(chunk_first), _build.ptr(chunk_count), _build.ptr(out),
            num_rows, d_in, d_out, num_segments, s_b, m_b, out_blocks,
            _build.stream_of(h))
    _build.check(err, "fused_transform_reduce")
    launches += 1
    return out

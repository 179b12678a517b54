"""Fully-fused transform-aggregate — SpMM + GEMM in one launch:

    Y[s, :] = ( reduce_{i: seg[i]==s} wt[i] · H[gidx[i], :] ) @ W

Linear reduces only (sum / mean): the transform distributes over the
reduction, so aggregating at width d_in and transforming per output block
computes the same function as transform-then-aggregate. The fp32 aggregate
is cast to the io dtype before the product, as the reference does.

  * :func:`fused_transform_reduce_cuda` — the hand-written Hopper kernel
    (``csrc/fused_transform_reduce.cu``; its note says what bounds it and
    how the design answers). Replaces the TPU kernel
    ``repro/kernels/fused_transform_reduce.py:_fused_transform_reduce_impl``.
  * :func:`fused_transform_reduce_ref` — the plain PyTorch version.
  * :func:`fused_transform_reduce_blocked` — the kernel's schedule in plain
    PyTorch: tiles of ``tile`` segments (the config's S_b) over the plan's row
    offsets, one run of rows per lane group, cut segments folded in run
    order, the aggregate cast once, then the product.
  * :func:`fusable` — does one block's shared-memory footprint fit Hopper?
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.core.config_space import (DEFAULT_S_B, SMEM_BYTES, TILE_SIZES,
                                           KernelConfig, io_dtype_bytes)
from repro_torch.kernels import _build
from repro_torch.kernels.gather_segment_reduce import (DTYPE_CODE, check_row_ptr,
                                                       check_rows,
                                                       gather_segment_reduce_ref)

THREADS = 256       # threads of a block (THREADS in the .cu source)
BN = 64             # output columns of one product pass (BN in the .cu source)

launches = 0        # launches of the CUDA kernel in this process


def smem_bytes(d_in: int, d_out: int, dtype, tile: int = DEFAULT_S_B) -> int:
    """One block's shared memory, as the kernel's ``Geometry`` lays it out
    for a tile of ``tile`` segments: the tile + 1 int64 row offsets and its fold plan (two int32 a
    segment); W transposed (n_pad rows of the k words, padded to 4 mod 32);
    the (TILE, d_in) aggregate in the io dtype (the same row stride); and
    the larger of the slots (two fp32 partials of a 16-byte vector a
    thread) and the output stage (TILE rows of BN columns) that reuses
    them."""
    es = io_dtype_bytes(dtype)
    f32 = es == 4
    kstep = 8 if f32 else 16
    k_pad = -(-max(d_in, 1) // kstep) * kstep
    kw = k_pad if f32 else k_pad // 2
    kstride = kw + (36 - kw % 32) % 32
    n_pad = -(-max(d_out, 1) // 8) * 8
    ostride = BN + 8 if f32 else BN // 2 + 4
    rp_words = (2 * (tile + 1) + 2 * tile + 3) // 4 * 4
    s_words = 2 * THREADS * (16 // es)
    return 4 * (rp_words + n_pad * kstride + tile * kstride
                + max(s_words, tile * ostride))


def fusable(d_in: int, d_out: int, dtype, config: KernelConfig = None,
            budget: int = SMEM_BYTES) -> bool:
    """Does one launch's shared-memory footprint (W resident, the tile's
    aggregate, slots and output stage) fit a Hopper block, at the tile of
    ``config`` (its S_b; the default tile without one)?"""
    tile = DEFAULT_S_B if config is None else config.s_b
    return smem_bytes(d_in, d_out, dtype, tile) <= budget


def fused_transform_reduce_ref(h, w, gather_idx, seg_idx, num_segments: int,
                               weight=None, reduce: str = "sum"):
    """The plain version: fp32 aggregate cast to the io dtype, then an fp32
    product cast to the io dtype."""
    agg = gather_segment_reduce_ref(h, gather_idx, seg_idx, num_segments,
                                    weight, reduce)
    return (agg.float() @ w.float()).to(h.dtype)


def lanes_per_row(d_in: int, dtype) -> int:
    """Lanes of the kernel's lane group for rows of ``d_in`` io elements:
    the widest vector of at most 16 bytes that divides a row (H aligned),
    then the fewest lanes, 4 to 32, that span the row with it."""
    es = io_dtype_bytes(dtype)
    v = 16 // es
    while v > 1 and d_in % v:
        v //= 2
    lpr = 4
    while lpr < 32 and lpr * v < d_in:
        lpr *= 2
    return lpr


def fused_transform_reduce_blocked(h, w, gather_idx, seg_idx,
                                   num_segments: int, weight, reduce: str,
                                   row_ptr, tile: int = DEFAULT_S_B):
    """The CUDA kernel's schedule in plain PyTorch. The segments are cut
    into tiles of ``tile`` (the config's S_b, or another a test asks for).
    A tile's rows ``[row_ptr[lo], row_ptr[hi])`` are split evenly into one
    run per lane group (``THREADS / lanes_per_row`` runs of ceil(rows /
    runs) rows); each run reduces its rows per segment, writes a segment
    that lies wholly inside it to the aggregate (cast to the io dtype) or
    keeps its value as a partial (slot 0: the segment of the run's first
    row, slot 1: that of its last row). Then each cut segment's partials
    fold in run order, empty segments are 0, and the tile's aggregate, in
    the io dtype, is multiplied by W in fp32. The aggregate starts NaN, so
    an element no step writes shows in the output."""
    num_rows, d_in = int(seg_idx.shape[0]), int(h.shape[1])
    runs = THREADS // lanes_per_row(d_in, h.dtype)
    agg = torch.full((num_segments, d_in), float("nan"), dtype=h.dtype,
                     device=h.device)
    rp = row_ptr.tolist()
    gidx = gather_idx[:num_rows].long()
    wt = None if weight is None else weight.float()
    for lo in range(0, num_segments, tile):
        hi = min(lo + tile, num_segments)
        r0, r1 = rp[lo], rp[hi]
        if r0 == r1:
            agg[lo:hi] = 0
            continue
        chunk = -(-(r1 - r0) // runs)
        partial = {}
        for g in range(runs):
            g0, g1 = min(r0 + g * chunk, r1), min(r0 + (g + 1) * chunk, r1)
            if g0 >= g1:
                continue
            msg = h.index_select(0, gidx[g0:g1]).float()
            if wt is not None:
                msg = msg * wt[g0:g1, None]
            s = lo
            while rp[s + 1] <= g0:      # the segment of the run's first row
                s += 1
            first = True
            while s < hi and rp[s] < g1:
                a, e = rp[s], rp[s + 1]
                if a < e:
                    val = msg[max(a, g0) - g0:min(e, g1) - g0].sum(0)
                    if a >= g0 and e <= g1:
                        agg[s] = (val / (e - a) if reduce == "mean"
                                  else val).to(h.dtype)
                    else:
                        partial[(g, 0 if first else 1)] = val
                    first = False
                s += 1
        for s in range(lo, hi):
            a, e = rp[s], rp[s + 1]
            if a == e:
                agg[s] = 0
                continue
            ka, kb = (a - r0) // chunk, (e - 1 - r0) // chunk
            if ka == kb:
                continue
            acc = partial[(ka, 0 if a == r0 + ka * chunk else 1)]
            for k in range(ka + 1, kb + 1):
                acc = acc + partial[(k, 0)]
            agg[s] = (acc / (e - a) if reduce == "mean" else acc).to(h.dtype)
    return (agg.float() @ w.float()).to(h.dtype)


def fused_transform_reduce_cuda(h, w, gather_idx, seg_idx, num_segments: int,
                                weight, reduce: str, row_ptr,
                                tile: int = DEFAULT_S_B):
    """Launch the Hopper kernel on the current stream (asynchronous).
    ``row_ptr`` is the plan's int64 row offsets of ``seg_idx`` on h's
    device; the kernel reads them and the gather indices, not ``seg_idx``
    itself. ``tile`` is the config's S_b, one of the built
    :data:`~repro_torch.core.config_space.TILE_SIZES`. The launch is the
    ``repro_torch::fused_transform_reduce`` op."""
    if reduce not in ("sum", "mean"):
        raise ValueError(f"fused transform-reduce is linear-only: reduce "
                         f"must be sum or mean, got {reduce!r}")
    if tile not in TILE_SIZES:
        raise ValueError(f"fused_transform_reduce: no kernel instance is "
                         f"built for tiles of {tile} segments (S_b); built: "
                         f"{TILE_SIZES}")
    num_rows = int(seg_idx.shape[0])
    check_rows("fused_transform_reduce", h,
               {"gather_idx": gather_idx, "seg_idx": seg_idx}, weight,
               num_rows)
    d_in, d_out = int(h.shape[1]), int(w.shape[1])
    if (w.device != h.device or w.dtype != h.dtype or w.dim() != 2
            or w.shape[0] != d_in or not w.is_contiguous()):
        raise ValueError(f"fused_transform_reduce: W must be a contiguous "
                         f"({d_in}, d_out) {h.dtype} tensor on {h.device}")
    if gather_idx.shape[0] != num_rows:
        raise ValueError("gather_idx and seg_idx must have the same length")
    check_row_ptr("fused_transform_reduce", row_ptr, num_segments, h.device)
    if smem_bytes(d_in, d_out, h.dtype, tile) > SMEM_BYTES:
        raise ValueError(
            f"(d_in={d_in}, d_out={d_out}) at a tile of {tile} needs "
            f"{smem_bytes(d_in, d_out, h.dtype, tile)} B of shared memory, over "
            f"the {SMEM_BYTES} B of a Hopper block; use the two-launch "
            f"mp_transform path")
    return torch.ops.repro_torch.fused_transform_reduce(
        h, w, gather_idx, num_segments, weight, reduce, row_ptr, tile)


@torch.library.custom_op("repro_torch::fused_transform_reduce",
                         mutates_args=(), device_types="cuda")
def _launch(h: torch.Tensor, w: torch.Tensor, gather_idx: torch.Tensor,
            num_segments: int, weight: Optional[torch.Tensor], reduce: str,
            row_ptr: torch.Tensor, tile: int) -> torch.Tensor:
    """The launch, for inputs :func:`fused_transform_reduce_cuda` checked
    (the kernel reads the row offsets, not the segment index)."""
    global launches
    d_in, d_out = int(h.shape[1]), int(w.shape[1])
    out = torch.empty((num_segments, d_out), dtype=h.dtype, device=h.device)
    if num_segments == 0 or d_out == 0:
        return out
    lib = _build.load("fused_transform_reduce", tile)
    with torch.cuda.device(h.device):
        err = lib.ftr_launch(
            DTYPE_CODE[h.dtype], int(reduce == "mean"), int(weight is not None),
            _build.ptr(h), _build.ptr(w), _build.ptr(gather_idx),
            _build.ptr(weight if weight is not None else h),
            _build.ptr(row_ptr), _build.ptr(out), d_in, d_out, num_segments,
            tile, _build.stream_of(h))
    _build.check(err, "fused_transform_reduce")
    launches += 1
    return out


@_launch.register_fake
def _(h, w, gather_idx, num_segments, weight, reduce, row_ptr, tile):
    return h.new_empty((num_segments, w.shape[1]))


@register_flop_formula(torch.ops.repro_torch.fused_transform_reduce)
def _flops(h_shape, w_shape, *args, out_shape=None, **kwargs) -> int:
    """2·S·K·N: the (S, K) aggregate times W, as the flop counter counts
    ``torch.matmul`` (the gather-reduce's adds are not counted, as an
    ``index_add_``'s are not)."""
    return 2 * out_shape[0] * w_shape[0] * w_shape[1]

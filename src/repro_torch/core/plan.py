"""Precomputed reduction plans (GeoT §III-C data-awareness, amortized).

A :class:`SegmentPlan` captures, once per graph, everything the segment
kernels otherwise derive on every call:

  * ``chunk_first`` / ``chunk_count`` — int32 tensors (out_blocks,): the
    chunk range each block of the fused kernel walks (see
    :func:`repro_torch.kernels.segment_reduce.chunk_metadata`);
  * ``row_ptr`` — int64 tensor (num_segments + 1,): each segment's row
    offsets in the index, which the row-run schedules of the gather,
    segment_reduce and softmax kernels read
    (:func:`repro_torch.kernels.gather_segment_reduce.row_offsets`);
  * a tight ``max_chunks`` — the most chunks any block owns. The CUDA
    kernels bound their loop by the block's own ``chunk_count`` and do not
    need it; it is kept so plans compare one to one with the reference;
  * degree statistics of the segment index;
  * the selected :class:`~repro_torch.core.config_space.KernelConfig`.

A :class:`RelationPlan` does the same for the grouped ``segment_matmul`` of
a relation-typed graph: which relation groups each row block overlaps.

Plans are built on the host and moved once to ``device``: the card unless
the caller passes ``device="cpu"`` (there is no fallback without a card).
A kernel call never copies plan metadata; a plan on another device than
the data raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.config_space import KernelConfig, default_config
from repro_torch.core.device import resolve_device
from repro_torch.kernels.gather_segment_reduce import row_offsets
from repro_torch.kernels.segment_matmul import group_metadata
from repro_torch.kernels.segment_reduce import chunk_metadata

__all__ = ["SegmentStats", "SegmentPlan", "RelationPlan", "segment_stats",
           "make_plan", "make_graph_plan", "make_relation_plan"]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class SegmentStats:
    """O(|V|) degree statistics of a sorted segment index."""
    num_rows: int            # M = |E| (index length)
    num_segments: int        # S (output rows)
    live_segments: int       # segments with >= 1 row (gapped ids shrink this)
    max_degree: int          # heaviest segment
    avg_degree: float        # M / max(live_segments, 1)
    std_degree: float        # over live segments

    @property
    def skew(self) -> float:
        """max/avg degree — the load imbalance of the heaviest window."""
        return self.max_degree / max(self.avg_degree, 1e-9)


def segment_stats(idx: np.ndarray, num_segments: int) -> SegmentStats:
    idx = np.asarray(idx)
    m = int(idx.size)
    if m == 0:
        return SegmentStats(0, num_segments, 0, 0, 0.0, 0.0)
    deg = np.bincount(idx, minlength=num_segments)
    live = deg[deg > 0]
    return SegmentStats(
        num_rows=m,
        num_segments=num_segments,
        live_segments=int(live.size),
        max_degree=int(deg.max()),
        avg_degree=float(m / max(live.size, 1)),
        std_degree=float(live.std()) if live.size else 0.0,
    )


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """Precomputed schedule for one (sorted idx, num_segments) instance."""
    chunk_first: torch.Tensor    # (out_blocks,) int32
    chunk_count: torch.Tensor    # (out_blocks,) int32
    row_ptr: torch.Tensor        # (num_segments + 1,) int64
    num_rows: int
    num_segments: int
    max_chunks: int              # tight: max(chunk_count), >= 1
    config: KernelConfig
    stats: SegmentStats

    @property
    def device(self) -> torch.device:
        return self.chunk_first.device

    def to(self, device) -> "SegmentPlan":
        """The same plan with its metadata on ``device``."""
        device = torch.device(device)
        if self.chunk_first.device == device:
            return self
        return dataclasses.replace(
            self, chunk_first=self.chunk_first.to(device),
            chunk_count=self.chunk_count.to(device),
            row_ptr=self.row_ptr.to(device))

    @property
    def worst_case_chunks(self) -> int:
        """The chunk bound a plan-less caller must assume."""
        return _round_up(max(self.num_rows, 1), self.config.m_b) // self.config.m_b

    def pin_worst_case(self) -> "SegmentPlan":
        """The same plan with ``max_chunks`` pinned to the shape-static
        worst case, as bucket-reuse paths canonicalize it."""
        if self.max_chunks == self.worst_case_chunks:
            return self
        return dataclasses.replace(self, max_chunks=self.worst_case_chunks)

    def validate(self, num_rows: int, num_segments: int) -> None:
        """Consistency check against the arrays of an op call."""
        if num_rows != self.num_rows or num_segments != self.num_segments:
            raise ValueError(
                f"SegmentPlan built for (M={self.num_rows}, "
                f"S={self.num_segments}) used with (M={num_rows}, "
                f"S={num_segments}); rebuild the plan for this graph.")


def _host_index(idx) -> np.ndarray:
    if isinstance(idx, torch.Tensor):
        idx = idx.detach().cpu().numpy()
    return np.asarray(idx).astype(np.int32)


def make_plan(idx, num_segments: int, feat: int = 128,
              config: Optional[KernelConfig] = None,
              device=None) -> SegmentPlan:
    """Build a :class:`SegmentPlan` from a concrete sorted segment index
    (numpy array or tensor). It is built on the host and its tensors are
    moved once to ``device`` (``None``: the card, raising without one;
    ``"cpu"`` for the plain versions). ``feat`` is the widest layer width;
    with no ``config`` it sizes :func:`default_config`."""
    device = resolve_device(device, "make_plan")
    idx_np = _host_index(idx)
    if idx_np.ndim != 1:
        raise ValueError(f"idx must be 1-D, got shape {idx_np.shape}")
    if idx_np.size and np.any(idx_np[1:] < idx_np[:-1]):
        raise ValueError("idx must be sorted non-decreasing")
    stats = segment_stats(idx_np, num_segments)
    if config is None:
        config = default_config(feat)

    m = int(idx_np.size)
    m_pad = _round_up(max(m, 1), config.m_b)
    idxp = np.full((m_pad,), num_segments, np.int32)
    idxp[:m] = idx_np
    chunk_first, chunk_count = chunk_metadata(idxp, num_segments, config.s_b,
                                              config.m_b, m_pad)
    max_chunks = max(1, int(chunk_count.max())) if chunk_count.numel() else 1
    return SegmentPlan(
        chunk_first=chunk_first.to(device),
        chunk_count=chunk_count.to(device),
        row_ptr=row_offsets(torch.from_numpy(idxp), num_segments).to(device),
        num_rows=m,
        num_segments=int(num_segments),
        max_chunks=max_chunks,
        config=config,
        stats=stats,
    )


def make_graph_plan(edge_index, num_nodes: int, feat: int = 128,
                    config: Optional[KernelConfig] = None,
                    device=None) -> SegmentPlan:
    """Plan for GNN aggregation over ``edge_index`` (2, E) with
    ``edge_index[1]`` (destinations) sorted non-decreasing, on ``device``
    (as :func:`make_plan`). One plan serves every layer of a model on the
    same graph."""
    edge_index = _host_index(edge_index)
    if edge_index.ndim != 2 or edge_index.shape[0] != 2:
        raise ValueError(f"edge_index must be (2, E), got {edge_index.shape}")
    return make_plan(edge_index[1], num_nodes, feat=feat, config=config,
                     device=device)


@dataclasses.dataclass(frozen=True)
class RelationPlan:
    """Precomputed schedule of one grouped ``segment_matmul`` (the
    typed-edge analogue of :class:`SegmentPlan`): which relation groups each
    M_b-row block overlaps, built once per typed graph.

    ``offsets`` (R+1,), ``first_group`` / ``group_count`` (m_blocks,) are
    int32 tensors (:func:`~repro_torch.kernels.segment_matmul.group_metadata`);
    ``max_groups`` is the tight bound max(group_count) >= 1 (the plan-less
    bound is ``min(R, M_b + 1)``); ``stats`` are :class:`SegmentStats` over
    the relation-size histogram."""
    offsets: torch.Tensor        # (num_groups + 1,) int32 row offsets
    first_group: torch.Tensor    # (m_blocks,) int32
    group_count: torch.Tensor    # (m_blocks,) int32
    num_rows: int                # M: rows of X the metadata was built for
    num_groups: int              # R: relation count
    max_groups: int
    config: KernelConfig
    stats: SegmentStats

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    def to(self, device) -> "RelationPlan":
        """The same plan with its metadata on ``device``."""
        device = torch.device(device)
        if self.offsets.device == device:
            return self
        return dataclasses.replace(
            self, offsets=self.offsets.to(device),
            first_group=self.first_group.to(device),
            group_count=self.group_count.to(device))

    @property
    def worst_case_groups(self) -> int:
        """The group bound a plan-less caller must assume."""
        return min(self.num_groups, self.config.m_b + 1)

    def validate(self, num_rows: int, num_groups: int) -> None:
        """Consistency check against the arrays of an op call."""
        if num_rows != self.num_rows or num_groups != self.num_groups:
            raise ValueError(
                f"RelationPlan built for (M={self.num_rows}, "
                f"R={self.num_groups}) used with (M={num_rows}, "
                f"R={num_groups}); rebuild the plan for this typed graph.")


def make_relation_plan(group_sizes, num_rows: Optional[int] = None,
                       feat: int = 128,
                       config: Optional[KernelConfig] = None,
                       device=None) -> RelationPlan:
    """Build a :class:`RelationPlan` from concrete per-relation row counts
    (R,), non-negative. ``num_rows`` defaults to their sum (pass the padded
    row count when X carries trailing rows of no group). ``feat`` is the
    output width that sizes :func:`default_config`. Built on the host and
    moved once to ``device``, as :func:`make_plan`."""
    device = resolve_device(device, "make_relation_plan")
    sizes = _host_index(group_sizes).astype(np.int64)
    if sizes.ndim != 1 or sizes.size == 0:
        raise ValueError(
            f"group_sizes must be 1-D and non-empty, got shape {sizes.shape}")
    if np.any(sizes < 0):
        raise ValueError("group_sizes must be non-negative")
    total = int(sizes.sum())
    m = total if num_rows is None else int(num_rows)
    if m < total:
        raise ValueError(f"num_rows={m} < sum(group_sizes)={total}")
    # the relation-size histogram is a degenerate sorted segment index
    stats = segment_stats(np.repeat(np.arange(sizes.size), sizes), sizes.size)
    if config is None:
        config = default_config(feat)
    offsets, fg, gc = group_metadata(torch.from_numpy(sizes.astype(np.int32)),
                                     m, config.m_b)
    max_groups = max(1, int(gc.max())) if gc.numel() else 1
    return RelationPlan(
        offsets=offsets.to(device),
        first_group=fg.to(device),
        group_count=gc.to(device),
        num_rows=m,
        num_groups=int(sizes.size),
        max_groups=max_groups,
        config=config,
        stats=stats,
    )

"""Precomputed reduction plans (GeoT §III-C data-awareness, amortized).

A :class:`SegmentPlan` captures, once per graph, everything the segment
kernels otherwise derive on every call:

  * ``row_ptr`` — int64 tensor (num_segments + 1,): each segment's row
    offsets in the index, which the row-run schedules of the gather,
    segment_reduce and softmax kernels and the tiles of the fused kernel
    read (:func:`repro_torch.kernels.gather_segment_reduce.row_offsets`);
  * degree statistics of the segment index (their ``skew`` feeds
    :func:`repro_torch.core.mp.choose_order`);
  * the selected :class:`~repro_torch.core.config_space.KernelConfig`
    (its run length M_b and tile S_b are what the kernels read), chosen by
    :func:`repro_torch.core.heuristics.select_plan_config` unless given:
    a measured PerfDB winner with ``tune=True``, else the generated
    rules;
  * for a graph (:func:`make_graph_plan`), a :class:`SourceOrder`: the
    real edges in stable source order, the schedule on which the backward
    passes scatter a gradient into the source rows as one run of the
    gather kernel (the transposed walk), in place of an atomic scatter.

A :class:`PartitionedPlan` holds one such graph plan a shard of a
:class:`~repro_torch.data.partition.PartitionedGraph`, with one shared
config. A :class:`RelationPlan` does the same for the grouped
``segment_matmul`` of a relation-typed graph: which relation groups each
row block overlaps.

Plans are built on the host and moved once to ``device``: the card unless
the caller passes ``device="cpu"`` (there is no fallback without a card).
A kernel call never copies plan metadata; a plan on another device than
the data raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.config_space import KernelConfig
from repro_torch.core.device import resolve_device
from repro_torch.kernels.gather_segment_reduce import row_offsets
from repro_torch.kernels.segment_matmul import group_metadata
from repro_torch.obs.trace import span

__all__ = ["SegmentStats", "SegmentPlan", "SourceOrder", "PartitionedPlan",
           "RelationPlan", "segment_stats", "source_order", "make_plan",
           "make_graph_plan", "make_partitioned_plan", "make_relation_plan"]


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
class SourceOrder:
    """The edges of a destination-sorted graph in stable source order: the
    schedule of the transposed walk, which computes

        dH[v] = sum_{i: gather_idx[i]==v} (w[i]·) G[seg_idx[i]]

    as a gather-reduce over these rows (gather index ``dst``, sorted
    segment index ``src``, offsets ``row_ptr``): the reference's own
    sort-then-segment-reduce rule (``repro/core/ops.py`` ``_gather_bwd``),
    deterministic where an atomic scatter is not.

    Edges whose destination is dropped (``seg_idx >= num_segments``, the
    padding convention) sort last with source id ``num_sources``, past
    ``row_ptr[num_sources]``, so no walk visits them; their ``dst`` is 0
    so that no index points past G. Built without a segment index (a
    plain gather's backward, where G has one row an edge), ``dst`` is the
    edge id itself."""
    perm: torch.Tensor      # (E,) int32: edge ids in (source, edge) order
    src: torch.Tensor       # (E,) int32: sorted source ids
    dst: torch.Tensor       # (E,) int32: the row of G each edge reads
    row_ptr: torch.Tensor   # (num_sources + 1,) int64
    num_sources: int        # rows of H
    num_real: Optional[int] = None   # edges kept, when known on the host

    def to(self, device) -> "SourceOrder":
        device = torch.device(device)
        if self.perm.device == device:
            return self
        return dataclasses.replace(
            self, perm=self.perm.to(device), src=self.src.to(device),
            dst=self.dst.to(device), row_ptr=self.row_ptr.to(device))


def source_order(gather_idx, seg_idx, num_segments: int, num_sources: int,
                 num_real: Optional[int] = None) -> SourceOrder:
    """Build the :class:`SourceOrder` of ``gather_idx`` where it lies (one
    stable sort and one ``searchsorted`` on the device, no host round
    trip). ``seg_idx`` may be None: every edge is kept (a plain gather's
    backward)."""
    gidx = torch.as_tensor(gather_idx)
    if seg_idx is None:
        key = gidx.to(torch.int32)
    else:
        seg = torch.as_tensor(seg_idx, device=gidx.device)
        real = seg < num_segments
        key = torch.where(real, gidx, num_sources).to(torch.int32)
    src, perm = torch.sort(key, stable=True)
    perm = perm.to(torch.int32)
    dst = perm if seg_idx is None else \
        torch.where(real, seg, 0).to(torch.int32).index_select(0, perm)
    return SourceOrder(perm=perm, src=src.contiguous(), dst=dst.contiguous(),
                       row_ptr=row_offsets(src, num_sources),
                       num_sources=int(num_sources), num_real=num_real)


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """Precomputed schedule for one (sorted idx, num_segments) instance."""
    row_ptr: torch.Tensor        # (num_segments + 1,) int64
    num_rows: int
    num_segments: int
    config: KernelConfig
    stats: SegmentStats
    # the graph's edges in source order (make_graph_plan); valid for ops
    # whose gather index is the sources the plan was built from
    src_order: Optional[SourceOrder] = None

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device

    def to(self, device) -> "SegmentPlan":
        """The same plan with its metadata on ``device``."""
        device = torch.device(device)
        if self.row_ptr.device == device:
            return self
        return dataclasses.replace(
            self, row_ptr=self.row_ptr.to(device),
            src_order=(None if self.src_order is None
                       else self.src_order.to(device)))

    def without_source_order(self) -> "SegmentPlan":
        """The same plan for ops that gather by another index than the
        graph's sources (the typed layers gather messages by
        ``inv_type_perm``)."""
        if self.src_order is None:
            return self
        return dataclasses.replace(self, src_order=None)

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
              device=None, tune: Optional[bool] = None) -> SegmentPlan:
    """Build a :class:`SegmentPlan` from a concrete sorted segment index
    (numpy array or tensor). It is built on the host and its tensors are
    moved once to ``device`` (``None``: the card, raising without one;
    ``"cpu"`` for the plain versions). ``feat`` is the widest layer width.
    With no ``config`` the selection tiers pick one from the index's O(1)
    features: ``tune=True`` (or ``REPRO_AUTOTUNE=1`` with ``tune=None``)
    sweeps the built instances on the card once per shape class and reuses
    the measured winner from the PerfDB; else the generated rules decide
    (:func:`repro_torch.core.heuristics.select_plan_config`).

    The build is the span ``plan.build`` (``kind="segment"``), with the
    stages ``plan.host_index``, ``plan.stats`` and ``plan.row_ptr``."""
    device = resolve_device(device, "make_plan")
    with span("plan.build", kind="segment", segments=int(num_segments),
              feat=int(feat)) as build:
        with span("plan.host_index"):
            idx_np = _host_index(idx)
        if idx_np.ndim != 1:
            raise ValueError(f"idx must be 1-D, got shape {idx_np.shape}")
        build.set(rows=int(idx_np.size))
        return _plan_of_host_index(idx_np, num_segments, feat, config,
                                   device, tune)


def _plan_of_host_index(idx_np: np.ndarray, num_segments: int, feat: int,
                        config: Optional[KernelConfig], device,
                        tune: Optional[bool]) -> SegmentPlan:
    """:func:`make_plan`'s stages after the copy to the host: the sorted
    check, the statistics and the config (``plan.stats``), then the row
    offsets on ``device`` (``plan.row_ptr``)."""
    with span("plan.stats"):
        if idx_np.size and np.any(idx_np[1:] < idx_np[:-1]):
            raise ValueError("idx must be sorted non-decreasing")
        stats = segment_stats(idx_np, num_segments)
        if config is None:
            from repro_torch.core.heuristics import select_plan_config
            config = select_plan_config(max(int(idx_np.size), 1),
                                        max(stats.live_segments, 1), feat,
                                        tune=tune)
    with span("plan.row_ptr"):
        row_ptr = row_offsets(torch.from_numpy(idx_np),
                              num_segments).to(device)
    return SegmentPlan(
        row_ptr=row_ptr,
        num_rows=int(idx_np.size),
        num_segments=int(num_segments),
        config=config,
        stats=stats,
    )


def make_graph_plan(edge_index, num_nodes: int, feat: int = 128,
                    config: Optional[KernelConfig] = None,
                    device=None, tune: Optional[bool] = None) -> SegmentPlan:
    """Plan for GNN aggregation over ``edge_index`` (2, E) with
    ``edge_index[1]`` (destinations) sorted non-decreasing, on ``device``
    (as :func:`make_plan`, config selected the same way), with the
    :class:`SourceOrder` of its sources built there. One plan serves every
    layer of a model on the same graph, forward and backward.

    The build is one span ``plan.build`` (``kind="graph"``): one copy of
    both rows to the host (``plan.host_index``), :func:`make_plan`'s
    ``plan.stats`` and ``plan.row_ptr`` on the destinations, then
    ``plan.source_order``."""
    device = resolve_device(device, "make_plan")
    with span("plan.build", kind="graph", segments=int(num_nodes),
              feat=int(feat)) as build:
        with span("plan.host_index"):
            edge_index = _host_index(edge_index)
        if edge_index.ndim != 2 or edge_index.shape[0] != 2:
            raise ValueError(
                f"edge_index must be (2, E), got {edge_index.shape}")
        build.set(rows=int(edge_index.shape[1]))
        plan = _plan_of_host_index(edge_index[1], num_nodes, feat, config,
                                   device, tune)
        with span("plan.source_order"):
            src, dst = (torch.from_numpy(a).to(device) for a in edge_index)
            order = source_order(
                src, dst, num_nodes, num_nodes,
                num_real=int(np.sum(edge_index[1] < num_nodes)))
        return dataclasses.replace(plan, src_order=order)


@dataclasses.dataclass(frozen=True)
class PartitionedPlan:
    """One :class:`SegmentPlan` a shard of a
    :class:`~repro_torch.data.partition.PartitionedGraph`, sharing one
    config: each reduces the shard's ``num_rows = edges_per_shard`` padded
    rows into the *global* segment space (``num_segments = |V|``), its
    ``row_ptr`` built over the shard's padded dst and its
    :class:`SourceOrder` over ``src_local`` (``num_sources =
    nodes_per_shard``), so a backward walks the shard's rows without a
    sort. ``stats`` describe the *global* index and feed the same
    cost-model decisions (transform/aggregate order) as a single-device
    plan. A rank reads its own with :meth:`local_plan`."""
    plans: Tuple[SegmentPlan, ...]
    num_shards: int
    num_rows: int            # E_pad: padded rows a shard
    num_segments: int        # V: the global output space every shard targets
    config: KernelConfig
    stats: SegmentStats      # of the global (unpartitioned) index

    @property
    def device(self) -> torch.device:
        return self.plans[0].device

    def local_plan(self, rank: int) -> SegmentPlan:
        """The plan of shard ``rank``."""
        if not 0 <= rank < self.num_shards:
            raise ValueError(f"rank {rank} outside the plan's "
                             f"{self.num_shards} shards")
        return self.plans[rank]


def make_partitioned_plan(pg, feat: int = 128,
                          config: Optional[KernelConfig] = None,
                          tune: Optional[bool] = None) -> PartitionedPlan:
    """Build one :class:`PartitionedPlan` for a
    :class:`~repro_torch.data.partition.PartitionedGraph`, on its device.

    The config is selected once from the per-shard workload (each launch
    reduces ``edges_per_shard`` rows into the global segment space);
    padding slots carry ``dst = num_nodes`` and sort past
    ``row_ptr[num_nodes]``, the convention :func:`make_plan` uses for
    padded rows."""
    dst = pg.dst_global.cpu().numpy()             # (S, E_pad), pad = V
    v = int(pg.num_nodes)
    kept = dst < v          # neither a padding slot nor a dropped edge
    stats = segment_stats(np.sort(dst[kept]).astype(np.int32), v)
    if config is None:
        from repro_torch.core.heuristics import select_config
        live_per_shard = max(
            max((int(np.unique(dst[s][kept[s]]).size)
                 for s in range(pg.num_shards)), default=0), 1)
        config = select_config(max(int(pg.edges_per_shard), 1),
                               live_per_shard, feat, tune=tune)
    plans = []
    for s in range(pg.num_shards):
        seg = pg.dst_global[s]
        order = source_order(pg.src_local[s], seg, v, pg.nodes_per_shard,
                             num_real=int(kept[s].sum()))
        plans.append(SegmentPlan(row_ptr=row_offsets(seg, v),
                                 num_rows=int(pg.edges_per_shard),
                                 num_segments=v, config=config, stats=stats,
                                 src_order=order))
    return PartitionedPlan(plans=tuple(plans), num_shards=int(pg.num_shards),
                           num_rows=int(pg.edges_per_shard), num_segments=v,
                           config=config, stats=stats)


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
    # the group row offsets on the host: the backward's per-group weight
    # gradient slices by them without a device-to-host copy
    host_offsets: tuple = ()

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
                       device=None, tune: Optional[bool] = None
                       ) -> RelationPlan:
    """Build a :class:`RelationPlan` from concrete per-relation row counts
    (R,), non-negative. ``num_rows`` defaults to their sum (pass the padded
    row count when X carries trailing rows of no group). ``feat`` is the
    output width. Without ``config``, the selection tiers pick one for the
    ``grouped_segment_matmul`` key (a measured winner with ``tune=True``,
    else the rules): its M_b is the metadata's row-block granularity. Built
    on the host and moved once to ``device``, as :func:`make_plan`."""
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
        from repro_torch.core.heuristics import select_config
        config = select_config(max(m, 1), max(int(sizes.size), 1), feat,
                               op="grouped_segment_matmul", tune=tune)
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
        host_offsets=tuple(int(o) for o in np.concatenate(
            [[0], np.cumsum(sizes)])),
    )

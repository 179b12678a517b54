"""Partitioned graphs for sharded message passing (the port of
``repro/data/partition.py``).

:func:`partition_graph` splits a :class:`~repro_torch.data.graphs.Graph`
into ``num_shards`` pieces, one a rank of a
:class:`~repro_torch.core.dist_mp.ShardMesh`:

  * **nodes**: one contiguous range a shard (``node_ptr``), the
    boundaries placed by *out-degree* balance, so each shard owns about
    ``|E| / num_shards`` edges even on power-law graphs;
  * **edges**: every edge lives on the shard that owns its **source**, so
    the gather side of message passing reads only the shard's own rows.
    Each shard's edge list keeps the global dst-sorted order, is padded to
    the common length ``edges_per_shard``, and carries remapped indices:
    ``src_local`` relative to the shard's node block, ``dst_global`` in
    the global segment space. Padding slots use the kernels' drop
    convention: ``dst = num_nodes`` rows lie past ``row_ptr[num_nodes]``
    and reach no output; their ``src_local`` is 0;
  * **halo**: a *cut* edge is one whose destination another shard owns;
    its contribution is a partial aggregate that the merge of
    :mod:`repro_torch.core.dist_mp` combines across ranks.
    :class:`HaloInfo` counts such edges and their distinct remote
    destinations a shard.

A padded graph (a served bucket) carries edges with ``dst = num_nodes``:
they stay in their source's shard as edges the kernels drop, and count
toward no degree and no cut.

The partition is computed with numpy on the host, with the reference's
dtypes and the same arrays bit for bit; each array then goes to ``device``
in one copy (all shards stacked, as the reference's leaves are). Round
trips are exact: ``unpartition_nodes(pg, pg.shard_nodes(x)) == x`` and
likewise for edges.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.data.graphs import Graph

__all__ = ["HaloInfo", "PartitionedGraph", "partition_graph",
           "unpartition_nodes", "unpartition_edges"]


@dataclasses.dataclass(frozen=True)
class HaloInfo:
    """Cut-edge metadata of a partition (per shard)."""
    cut_edges: Tuple[int, ...]       # edges whose dst is owned elsewhere
    halo_nodes: Tuple[int, ...]      # distinct remote destinations a shard
    total_cut: int
    total_edges: int

    @property
    def cut_fraction(self) -> float:
        return self.total_cut / self.total_edges if self.total_edges else 0.0


@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """A graph split into ``num_shards`` pieces, stacked ``(num_shards,
    ...)`` tensors on one device; a rank reads its own row of each."""
    src_local: torch.Tensor    # (S, E_pad) int32: src - node_ptr[s]; pad 0
    dst_global: torch.Tensor   # (S, E_pad) int32: global dst, sorted; pad V
    edge_valid: torch.Tensor   # (S, E_pad) bool: False on padding slots
    edge_gather: torch.Tensor  # (S, E_pad) int32: global edge slot; pad 0
    node_gather: torch.Tensor  # (S, V_pad) int32: global node row; pad 0
    node_valid: torch.Tensor   # (S, V_pad) bool
    deg: torch.Tensor          # (V,) float32 global in-degree: the mean
    #                            merge's divisor, merged once here
    num_shards: int
    num_nodes: int             # V (global)
    num_edges: int             # E (global, unpadded)
    nodes_per_shard: int       # V_pad = the largest shard's node range
    edges_per_shard: int       # E_pad = the largest shard's edge count
    node_ptr: Tuple[int, ...]  # (S+1,) contiguous node partition
    halo: HaloInfo

    @property
    def device(self) -> torch.device:
        return self.dst_global.device

    def shard_nodes(self, x, rank: Optional[int] = None):
        """(V, ...) global node values -> (S, V_pad, ...) stacked local
        blocks, or with ``rank`` that shard's (V_pad, ...) block. Padding
        rows repeat row 0; no valid ``src_local`` reads them."""
        rows = self.node_gather if rank is None else self.node_gather[rank]
        out = x.index_select(0, rows.reshape(-1).long())
        return out.reshape(*rows.shape, *x.shape[1:])

    def shard_edges(self, vals, rank: Optional[int] = None):
        """(E, ...) per-edge values in the global dst-sorted order ->
        (S, E_pad, ...) stacked, or with ``rank`` that shard's (E_pad, ...)
        block, padding slots zeroed."""
        rows = self.edge_gather if rank is None else self.edge_gather[rank]
        valid = self.edge_valid if rank is None else self.edge_valid[rank]
        out = vals.index_select(0, rows.reshape(-1).long())
        out = out.reshape(*rows.shape, *vals.shape[1:])
        mask = valid.reshape(*valid.shape, *([1] * (vals.dim() - 1)))
        return torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                                  device=out.device))

    def make_plan(self, feat: Optional[int] = None, config=None,
                  tune: Optional[bool] = None):
        """One :class:`~repro_torch.core.plan.PartitionedPlan` (a
        SegmentPlan a shard and a shared config) for this partition, on its
        device. Build it once a partition and pass it as ``pplan=`` /
        ``plan=``."""
        from repro_torch.core.plan import make_partitioned_plan
        return make_partitioned_plan(self, feat=128 if feat is None else feat,
                                     config=config, tune=tune)


def _node_boundaries(outdeg: np.ndarray, num_shards: int) -> np.ndarray:
    """Contiguous node boundaries balanced by out-degree (edge ownership)."""
    v = outdeg.size
    cum = np.concatenate([[0], np.cumsum(outdeg, dtype=np.int64)])
    total = int(cum[-1])
    if total == 0:
        # no edges: plain node-count split
        bounds = np.linspace(0, v, num_shards + 1).round().astype(np.int64)
    else:
        targets = total * np.arange(1, num_shards) / num_shards
        inner = np.searchsorted(cum, targets, side="left")
        bounds = np.concatenate([[0], inner, [v]]).astype(np.int64)
    # monotone and in range even on degenerate degree distributions
    bounds = np.maximum.accumulate(np.clip(bounds, 0, v))
    bounds[0], bounds[-1] = 0, v
    return bounds


def partition_graph(graph: Graph, num_shards: int,
                    device=None) -> PartitionedGraph:
    """Contiguous 1-D node partition and source-owned edge shards (see the
    module docstring), on ``device`` (``None``: the card, raising without
    one; ``"cpu"`` for the plain versions). ``num_shards == 1`` is the
    identity partition (one shard, no padding, no cut edges)."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    v, e = graph.num_nodes, graph.num_edges
    if num_shards > max(v, 1):
        raise ValueError(f"num_shards={num_shards} exceeds num_nodes={v}")
    device = resolve_device(device, "partition_graph")
    src = np.asarray(graph.edge_index[0], np.int64)
    dst = np.asarray(graph.edge_index[1], np.int64)
    # the shards' kernels and merges need dst-sorted edge lists (a
    # subsequence of a sorted list is sorted)
    if e and np.any(dst[1:] < dst[:-1]):
        raise ValueError("edge_index[1] (destinations) must be sorted "
                         "non-decreasing to partition the graph")

    outdeg = np.bincount(src, minlength=v) if e else np.zeros(v, np.int64)
    node_ptr = _node_boundaries(outdeg, num_shards)

    # the shard of an edge is the owner of its source
    shard_of = (np.searchsorted(node_ptr, src, side="right") - 1 if e
                else np.zeros(0, np.int64))
    counts = np.bincount(shard_of, minlength=num_shards).astype(np.int64)
    e_pad = int(counts.max()) if e else 0
    v_pad = int(np.diff(node_ptr).max()) if v else 0

    src_local = np.zeros((num_shards, e_pad), np.int32)
    dst_global = np.full((num_shards, e_pad), v, np.int32)
    edge_valid = np.zeros((num_shards, e_pad), bool)
    edge_gather = np.zeros((num_shards, e_pad), np.int32)
    node_gather = np.zeros((num_shards, v_pad), np.int32)
    node_valid = np.zeros((num_shards, v_pad), bool)
    cut_edges, halo_nodes = [], []
    for s in range(num_shards):
        lo, hi = int(node_ptr[s]), int(node_ptr[s + 1])
        node_gather[s, :hi - lo] = np.arange(lo, hi)
        node_valid[s, :hi - lo] = True
        # the original order is kept, so each shard's dst stays sorted
        rows = np.flatnonzero(shard_of == s)
        n = rows.size
        src_local[s, :n] = (src[rows] - lo).astype(np.int32)
        dst_global[s, :n] = dst[rows].astype(np.int32)
        edge_valid[s, :n] = True
        edge_gather[s, :n] = rows.astype(np.int32)
        # an edge of a padded graph (dst = V) is dropped, not cut
        remote = ((dst[rows] < lo) | (dst[rows] >= hi)) & (dst[rows] < v)
        cut_edges.append(int(remote.sum()))
        halo_nodes.append(int(np.unique(dst[rows][remote]).size))

    halo = HaloInfo(cut_edges=tuple(cut_edges), halo_nodes=tuple(halo_nodes),
                    total_cut=int(sum(cut_edges)), total_edges=e)
    deg = (np.bincount(dst[dst < v], minlength=v) if e
           else np.zeros(v)).astype(np.float32)

    def dev(a):
        return torch.from_numpy(a).to(device)
    return PartitionedGraph(
        src_local=dev(src_local), dst_global=dev(dst_global),
        edge_valid=dev(edge_valid), edge_gather=dev(edge_gather),
        node_gather=dev(node_gather), node_valid=dev(node_valid),
        deg=dev(deg), num_shards=num_shards, num_nodes=v, num_edges=e,
        nodes_per_shard=v_pad, edges_per_shard=e_pad,
        node_ptr=tuple(int(b) for b in node_ptr), halo=halo)


def _scatter_back(stacked, rows, valid, n: int):
    """Write the valid rows of stacked (S, P, ...) blocks to their global
    slots of an (n, ...) tensor."""
    flat = stacked.reshape(-1, *stacked.shape[2:])
    keep = valid.reshape(-1)
    out = torch.zeros((n, *stacked.shape[2:]), dtype=stacked.dtype,
                      device=stacked.device)
    return out.index_copy_(0, rows.reshape(-1)[keep].long(), flat[keep])


def unpartition_nodes(pg: PartitionedGraph, stacked):
    """Inverse of :meth:`PartitionedGraph.shard_nodes`: stacked (S, V_pad,
    ...) local node blocks back to global (V, ...) order."""
    return _scatter_back(stacked, pg.node_gather, pg.node_valid,
                         pg.num_nodes)


def unpartition_edges(pg: PartitionedGraph, stacked):
    """Inverse of :meth:`PartitionedGraph.shard_edges`: stacked (S, E_pad,
    ...) per-edge values back to global (E, ...) order."""
    return _scatter_back(stacked, pg.edge_gather, pg.edge_valid,
                         pg.num_edges)

"""Seeded GraphSAGE-style k-hop neighbour sampling into CSR-sorted
subgraphs — the front half of the out-of-core mini-batch path, as the
reference's (``repro/data/sampling.py``): numpy on the host, with the
reference's expansion order and generator calls, so the same
``(seed, step)`` gives bitwise the reference's batch, and a shard
directory written by either package reads in the other.

The *graph* stays on the host (or on disk, via
:class:`ShardedGraphStore`), and each training or serving step sees only a
small **subgraph** around a batch of seed nodes —

  * hop ``h`` expands the in-neighbourhoods of the nodes discovered at
    hop ``h-1`` (seeds at hop 0), capped at ``fanouts[h]`` in-edges per
    node. ``fanout=None`` takes the exact full neighbourhood — the mode
    the parity tests use: a depth-``L`` exact subgraph reproduces a
    depth-``L`` GNN's logits on the seed nodes up to float association;
  * local node ids are assigned in discovery order with **seeds first**,
    so the model's output rows ``[0, num_seeds)`` are the seed logits;
  * because nodes are expanded in increasing local-id order and each
    node's in-edges are contiguous, the emitted ``edge_index`` comes out
    **destination-sorted by construction** — the invariant every plan and
    kernel requires (validated, never silently fixed);
  * the subgraph carries the **parent graph's** ``deg_inv_sqrt`` (GCN's
    normaliser is a property of the full graph, not of the sample), its
    features, and its labels.

Sampling is **deterministic in (seed, step)**: one ``Generator`` seeded
from exactly that pair drives the whole batch, and nodes are expanded in
a fixed order — the same step yields the same subgraph on any run, any
thread count, any prefetch depth. Checkpoint replay
(:mod:`repro_torch.train`) and the prefetch pipeline
(:mod:`repro_torch.data.pipeline`) lean on it.

The expansion is a Python loop over every sampled edge: a batch of the
3-hop fanouts (15, 10, 5) around 1024 seeds costs tens of milliseconds of
host time, which a training step on the card does not hide (PERF.md).

Graph access goes through a small store interface (``num_nodes`` /
``in_edges(node)`` / ``gather_nodes(ids)``), with two implementations:
:class:`InMemoryStore` (a CSR view over a resident
:class:`~repro_torch.data.graphs.Graph`) and :class:`ShardedGraphStore` —
the out-of-core layout: contiguous destination ranges (every node's
in-edges live in exactly one shard), one ``.npz`` file per shard, and a
bounded LRU of resident shards.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.graphs import Graph

__all__ = ["Subgraph", "InMemoryStore", "ShardedGraphStore",
           "save_graph_shards", "NeighborSampler"]


@dataclasses.dataclass(frozen=True)
class Subgraph(Graph):
    """A sampled neighbourhood as a first-class :class:`Graph` (plans,
    padding, batching, and every model work on it unchanged), plus the
    sampling bookkeeping:

      * ``node_ids`` — global (parent-store) id of each local node;
        ``node_ids[:num_seeds]`` are the seed nodes, in seed order;
      * ``num_seeds`` — how many leading local nodes are seeds (the rows
        a loss / serving response should restrict to).
    """
    node_ids: Optional[np.ndarray] = None    # (V_sub,) int64 global ids
    num_seeds: int = 0

    def __post_init__(self):
        if self.node_ids is None:
            raise ValueError("Subgraph requires node_ids")
        if not (0 <= self.num_seeds <= self.num_nodes):
            raise ValueError(
                f"num_seeds={self.num_seeds} outside [0, {self.num_nodes}]")

    @property
    def seed_nodes(self) -> np.ndarray:
        """Global ids of the seed nodes (== node_ids[:num_seeds])."""
        return self.node_ids[:self.num_seeds]


# ---------------------------------------------------------------------------
# graph stores: CSR in-edge access, resident or out-of-core
# ---------------------------------------------------------------------------

class InMemoryStore:
    """CSR in-edge view over a resident
    :class:`~repro_torch.data.graphs.Graph`.

    ``edge_index[1]`` is destination-sorted (the library invariant), so
    node ``d``'s in-edges are the contiguous slice
    ``src[indptr[d]:indptr[d+1]]`` — one ``searchsorted`` builds the
    whole index."""

    def __init__(self, graph: Graph):
        dst = graph.edge_index[1]
        if dst.size and np.any(np.diff(dst) < 0):
            raise ValueError("edge_index[1] must be sorted non-decreasing")
        self._g = graph
        self.num_nodes = int(graph.num_nodes)
        self.num_edges = int(graph.num_edges)
        self.feat = int(graph.x.shape[1])
        self.num_classes = int(graph.labels.max()) + 1 if graph.labels.size \
            else 1
        self.indptr = np.searchsorted(
            dst, np.arange(self.num_nodes + 1)).astype(np.int64)
        self.src = graph.edge_index[0]

    def in_edges(self, node: int) -> np.ndarray:
        """Global source ids of ``node``'s in-edges (CSR order; possibly
        empty — isolated nodes are first-class here)."""
        return self.src[self.indptr[node]:self.indptr[node + 1]]

    def in_degree(self, node: int) -> int:
        return int(self.indptr[node + 1] - self.indptr[node])

    def gather_nodes(self, ids: np.ndarray) -> dict:
        """Per-node data rows for the given global ids."""
        ids = np.asarray(ids)
        return {"x": self._g.x[ids],
                "labels": self._g.labels[ids],
                "deg_inv_sqrt": self._g.deg_inv_sqrt[ids]}


def save_graph_shards(graph: Graph, path: str, num_shards: int) -> str:
    """Write ``graph`` as an out-of-core shard directory for
    :class:`ShardedGraphStore`.

    Layout: ``meta.json`` (sizes + the node partition) and one
    ``shard_{i}.npz`` per shard holding a contiguous **destination**
    range's in-edges (``src`` + local ``indptr``) and its nodes' data
    rows. Boundaries are placed by in-edge balance (the same
    edge-balancing idea as the reference's ``partition_graph``, but
    dst-owned: the sampler reads in-neighbourhoods, so a node's in-edges
    must never straddle shards)."""
    if num_shards < 1:
        raise ValueError("num_shards must be >= 1")
    store = InMemoryStore(graph)
    v, e = store.num_nodes, store.num_edges
    # node_ptr[s] .. node_ptr[s+1]: shard s's destination range, boundaries
    # at (approximately) equal cumulative in-edge counts
    targets = (np.arange(1, num_shards) * e) / num_shards
    cuts = np.searchsorted(store.indptr[1:-1], targets, side="left") + 1 \
        if v > 1 else np.zeros(0, np.int64)
    node_ptr = np.concatenate([[0], np.clip(cuts, 0, v), [v]]).astype(np.int64)
    node_ptr = np.maximum.accumulate(node_ptr)
    os.makedirs(path, exist_ok=True)
    for s in range(num_shards):
        lo, hi = int(node_ptr[s]), int(node_ptr[s + 1])
        e_lo, e_hi = int(store.indptr[lo]), int(store.indptr[hi])
        np.savez(os.path.join(path, f"shard_{s}.npz"),
                 indptr=(store.indptr[lo:hi + 1] - e_lo).astype(np.int64),
                 src=store.src[e_lo:e_hi].astype(np.int32),
                 x=graph.x[lo:hi],
                 labels=graph.labels[lo:hi],
                 deg_inv_sqrt=graph.deg_inv_sqrt[lo:hi])
    meta = {"name": graph.name, "num_nodes": v, "num_edges": e,
            "num_shards": num_shards, "feat": store.feat,
            "num_classes": store.num_classes,
            "node_ptr": [int(p) for p in node_ptr]}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    return path


class ShardedGraphStore:
    """Out-of-core graph access over a :func:`save_graph_shards` directory.

    At most ``cache_shards`` shard files are resident at a time (LRU) —
    the host-memory bound that lets graphs far larger than RAM feed the
    sampler. Locality is real, not hoped-for: a batch's seed nodes are
    contiguous ranges only by accident, but every *single* node's whole
    in-neighborhood is one shard, so a k-hop expansion touches O(distinct
    shards of the frontier) loads, amortized by the LRU."""

    def __init__(self, path: str, cache_shards: int = 2):
        if cache_shards < 1:
            raise ValueError("cache_shards must be >= 1")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        self.path = path
        self.name = meta["name"]
        self.num_nodes = int(meta["num_nodes"])
        self.num_edges = int(meta["num_edges"])
        self.num_shards = int(meta["num_shards"])
        self.feat = int(meta["feat"])
        self.num_classes = int(meta["num_classes"])
        self.node_ptr = np.asarray(meta["node_ptr"], np.int64)
        self.cache_shards = int(cache_shards)
        self.loads = 0               # shard file reads (the out-of-core cost)
        self._lru: "collections.OrderedDict[int, dict]" = \
            collections.OrderedDict()

    def _shard_of(self, node: int) -> int:
        return int(np.searchsorted(self.node_ptr, node, side="right") - 1)

    def _shard(self, s: int) -> dict:
        hit = self._lru.get(s)
        if hit is not None:
            self._lru.move_to_end(s)
            return hit
        with np.load(os.path.join(self.path, f"shard_{s}.npz")) as z:
            data = {k: z[k] for k in z.files}
        self.loads += 1
        self._lru[s] = data
        while len(self._lru) > self.cache_shards:
            self._lru.popitem(last=False)
        return data

    def in_edges(self, node: int) -> np.ndarray:
        s = self._shard_of(node)
        shard = self._shard(s)
        local = node - int(self.node_ptr[s])
        return shard["src"][shard["indptr"][local]:shard["indptr"][local + 1]]

    def in_degree(self, node: int) -> int:
        return int(self.in_edges(node).size)

    def gather_nodes(self, ids: np.ndarray) -> dict:
        ids = np.asarray(ids, np.int64)
        out = {"x": np.empty((ids.size, self.feat), np.float32),
               "labels": np.empty(ids.size, np.int32),
               "deg_inv_sqrt": np.empty(ids.size, np.float32)}
        shard_ids = np.searchsorted(self.node_ptr, ids, side="right") - 1
        for s in np.unique(shard_ids):
            rows = np.where(shard_ids == s)[0]
            shard = self._shard(int(s))
            local = ids[rows] - int(self.node_ptr[s])
            for k in out:
                out[k][rows] = shard[k][local]
        return out


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------

class NeighborSampler:
    """Deterministic, seeded k-hop in-neighbor sampler (GraphSAGE fanouts).

    ``fanouts`` — one entry per hop; each is a per-node in-edge cap or
    ``None`` for the exact full neighborhood (``exact=True`` makes every
    hop exact — the parity-testing mode). ``batch_size`` seed nodes are
    drawn per step from ``seed_nodes`` (default: every node), without
    replacement within a batch, as a pure function of ``(seed, step)``.

    Every :meth:`sample` call yields a :class:`Subgraph` whose edges are
    destination-sorted and whose node data comes from the store — an
    empty in-neighborhood (isolated seed) yields a valid zero-edge
    subgraph, reusing the library's empty-edge guarantees end to end.
    """

    def __init__(self, store, fanouts: Sequence[Optional[int]] = (8, 4), *,
                 batch_size: int = 64, seed_nodes=None, exact: bool = False,
                 seed: int = 0, name: str = "sampled"):
        if isinstance(store, Graph):
            store = InMemoryStore(store)
        if not fanouts:
            raise ValueError("fanouts must name at least one hop")
        for f in fanouts:
            if f is not None and f < 1:
                raise ValueError(f"fanout must be >= 1 or None, got {f}")
        self.store = store
        self.fanouts = tuple(None if (exact or f is None) else int(f)
                             for f in fanouts)
        self.exact = bool(exact) or all(f is None for f in self.fanouts)
        self.seed = int(seed)
        self.name = name
        if seed_nodes is None:
            seed_nodes = np.arange(store.num_nodes, dtype=np.int64)
        self.seed_nodes = np.asarray(seed_nodes, np.int64)
        if self.seed_nodes.size == 0:
            raise ValueError("seed_nodes must be non-empty")
        self.batch_size = min(int(batch_size), self.seed_nodes.size)
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")

    def __len__(self) -> int:
        """Steps per epoch — distinct batches before seed reuse levels."""
        return max(self.seed_nodes.size // self.batch_size, 1)

    # -- seed selection -----------------------------------------------------
    def seeds_for(self, step: int) -> np.ndarray:
        """The step's seed nodes: a ``batch_size`` slice of a per-epoch
        permutation of ``seed_nodes`` — every epoch covers every seed
        node once (up to the tail), and the slice is a pure function of
        ``(seed, step)``."""
        epoch, k = divmod(int(step), len(self))
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, 0x5eed, epoch]))
        perm = rng.permutation(self.seed_nodes.size)
        return self.seed_nodes[perm[k * self.batch_size:
                                    (k + 1) * self.batch_size]]

    # -- the sampler core ---------------------------------------------------
    def sample(self, seeds, step: int = 0) -> Subgraph:
        """k-hop subgraph around explicit ``seeds`` (global ids, unique).

        ``step`` only keys the fanout RNG (ignored in exact mode); the
        expansion itself is fully deterministic."""
        seeds = np.asarray(seeds, np.int64)
        if seeds.size != np.unique(seeds).size:
            raise ValueError("seeds must be unique within a batch")
        if seeds.size and (seeds.min() < 0
                           or seeds.max() >= self.store.num_nodes):
            raise ValueError("seed id out of range")
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, 1, int(step)]))

        node_ids = list(seeds)
        local = {int(n): i for i, n in enumerate(seeds)}
        e_src: list = []             # local src per edge
        e_dst: list = []             # local dst per edge (non-decreasing)
        frontier = list(seeds)
        for fanout in self.fanouts:
            next_frontier = []
            # frontier nodes are expanded in ascending local-id order and
            # every new node gets an id past all previously expanded ones,
            # so the appended (dst-contiguous) edges keep edge_index[1]
            # sorted non-decreasing — CSR order by construction
            for d in frontier:
                srcs = self.store.in_edges(int(d))
                if fanout is not None and srcs.size > fanout:
                    srcs = srcs[np.sort(rng.choice(srcs.size, fanout,
                                                   replace=False))]
                dl = local[int(d)]
                for s in srcs:
                    si = int(s)
                    sl = local.get(si)
                    if sl is None:
                        sl = local[si] = len(node_ids)
                        node_ids.append(si)
                        next_frontier.append(si)
                    e_src.append(sl)
                    e_dst.append(dl)
            frontier = next_frontier
        node_ids = np.asarray(node_ids, np.int64)
        edge_index = np.stack([
            np.asarray(e_src, np.int32) if e_src else np.zeros(0, np.int32),
            np.asarray(e_dst, np.int32) if e_dst else np.zeros(0, np.int32)])
        if edge_index[1].size and np.any(np.diff(edge_index[1]) < 0):
            raise AssertionError(
                "sampler invariant violated: destinations not sorted")
        data = self.store.gather_nodes(node_ids)
        return Subgraph(
            name=f"{self.name}-step{step}",
            edge_index=edge_index,
            num_nodes=int(node_ids.size),
            x=np.ascontiguousarray(data["x"], dtype=np.float32),
            labels=np.ascontiguousarray(data["labels"], dtype=np.int32),
            # the PARENT graph's normalizer: GCN's D^{-1/2} is a property
            # of the full graph — recomputing it from sampled degrees
            # would break exact-neighborhood parity
            deg_inv_sqrt=np.ascontiguousarray(data["deg_inv_sqrt"],
                                              dtype=np.float32),
            node_ids=node_ids,
            num_seeds=int(seeds.size),
        )

    def sample_batch(self, step: int) -> Subgraph:
        """One training batch: :meth:`seeds_for` then :meth:`sample` —
        the deterministic ``step -> Subgraph`` function the pipeline's
        producer threads evaluate ahead of the consumer."""
        return self.sample(self.seeds_for(step), step=step)

    # -- sizing helpers -----------------------------------------------------
    def max_sampled_shape(self) -> Tuple[int, int]:
        """A worst-case (V_sub, E_sub) bound for this sampler's batches —
        what a bucket-warmup ladder should cover. Exact-mode bounds use
        the full graph sizes (a k-hop ball can be the whole graph)."""
        if any(f is None for f in self.fanouts):
            return int(self.store.num_nodes), int(self.store.num_edges)
        v = e = self.batch_size
        width = self.batch_size
        for f in self.fanouts:
            new = width * f
            e = e + new if e != self.batch_size else new
            v += new
            width = new
        e = sum(self.batch_size * int(np.prod(self.fanouts[:h + 1]))
                for h in range(len(self.fanouts)))
        return min(v, self.store.num_nodes), min(e, self.store.num_edges)

"""Synthetic graph generator matching the paper's evaluation datasets
(Table II stats).

Degree distributions are power-law; edges come out sorted by destination
(``edge_index[1]`` non-decreasing). Everything here is numpy and draws
from the same seeded generator calls as the reference package, so the
same seed gives bitwise-identical graphs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

# Table II of the paper (name, |V|, |E|)
TABLE_II = [
    ("citeseer", 3_327, 9_104),
    ("cora", 2_708, 10_556),
    ("ppi", 2_245, 61_318),
    ("pubmed", 19_717, 88_648),
    ("amazon-photo", 7_650, 238_162),
    ("flickr", 89_250, 899_756),
    ("ogbn-arxiv", 169_343, 1_166_243),
    ("ogbl-collab", 235_868, 1_285_465),
    ("reddit2", 232_965, 23_213_838),
]


@dataclasses.dataclass(frozen=True)
class Graph:
    name: str
    edge_index: np.ndarray        # (2, E) int32, [1] sorted non-decreasing
    num_nodes: int
    x: np.ndarray                 # (V, F) float32
    labels: np.ndarray            # (V,) int32
    deg_inv_sqrt: np.ndarray      # (V,) float32
    # block-diagonal batch bookkeeping (batch_graphs); None for single graphs
    node_ptr: Optional[np.ndarray] = None    # (G+1,) node offsets per graph
    edge_ptr: Optional[np.ndarray] = None    # (G+1,) edge offsets per graph
    # pad_graph bookkeeping: the real (pre-padding) sizes, or None when the
    # graph has never been padded. Padded edges carry dst = num_nodes
    orig_num_nodes: Optional[int] = None
    orig_num_edges: Optional[int] = None
    # per-instance plan memo (see make_plan); init=False so that
    # dataclasses.replace() starts a fresh memo instead of aliasing the
    # source graph's
    _plan_cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                          compare=False, init=False)

    @property
    def num_edges(self) -> int:
        return self.edge_index.shape[1]

    @property
    def num_graphs(self) -> int:
        return 1 if self.node_ptr is None else len(self.node_ptr) - 1

    def make_plan(self, feat: Optional[int] = None, config=None,
                  device=None, tune: Optional[bool] = None):
        """The reduction schedule for this graph (see
        :mod:`repro_torch.core.plan`), with its source order, on ``device``
        (``None``: the card; ``"cpu"`` for the plain versions).
        ``tune=True`` picks the config from a sweep measured on the card
        (the PerfDB's, once per shape class). Memoized per ``(feat,
        config, tune, device)``: a trainer asking every step pays for it
        once."""
        from repro_torch.core.device import resolve_device
        from repro_torch.core.plan import make_graph_plan
        feat = self.x.shape[1] if feat is None else feat
        device = resolve_device(device, "Graph.make_plan")
        key = (int(feat), config, tune, str(device))
        plan = self._plan_cache.get(key)
        if plan is None:
            plan = self._plan_cache[key] = make_graph_plan(
                self.edge_index, self.num_nodes, feat=feat, config=config,
                device=device, tune=tune)
        return plan

    def partition(self, num_shards: int, device=None):
        """Split into ``num_shards`` source-owned edge shards for sharded
        message passing (:mod:`repro_torch.data.partition`,
        :mod:`repro_torch.core.dist_mp`), on ``device``."""
        from repro_torch.data.partition import partition_graph
        return partition_graph(self, num_shards, device=device)


def synth_graph(name: str, num_nodes: int, num_edges: int, feat: int = 32,
                num_classes: int = 16, alpha: float = 1.3,
                seed: int = 0) -> Graph:
    """Power-law in-degree graph with the given |V|, |E|."""
    rng = np.random.default_rng(seed)
    if num_edges > 0:
        w = rng.zipf(alpha, size=num_nodes).astype(np.float64)
        # cap at E/4 but never below 1 (zipf samples are >= 1)
        w = np.minimum(w, max(num_edges / 4.0, 1.0))
        p = w / w.sum()
        dst = rng.choice(num_nodes, size=num_edges, p=p).astype(np.int32)
        dst.sort(kind="stable")
        src = rng.integers(0, num_nodes, size=num_edges, dtype=np.int32)
    else:
        # empty-edge graph (isolated nodes): a valid (2, 0) edge_index
        dst = np.zeros(0, np.int32)
        src = np.zeros(0, np.int32)
    deg = np.bincount(dst, minlength=num_nodes).astype(np.float32)
    return Graph(
        name=name,
        edge_index=np.stack([src, dst]),
        num_nodes=num_nodes,
        x=rng.standard_normal((num_nodes, feat), dtype=np.float32),
        labels=rng.integers(0, num_classes, num_nodes, dtype=np.int32),
        deg_inv_sqrt=(1.0 / np.sqrt(np.maximum(deg, 1.0))).astype(np.float32),
    )


@dataclasses.dataclass(frozen=True)
class TypedGraph(Graph):
    """A :class:`Graph` whose edges carry relation types (RGCN, relational
    GAT).

    ``edge_index`` stays destination-sorted and ``edge_type`` is aligned
    with those edges. The grouped ``segment_matmul`` needs each relation's
    rows contiguous instead, so construction precomputes the reconciling
    permutation triple once:

      * ``type_perm`` — stable argsort of ``edge_type``: edges in (type,
        dst) order, each relation one contiguous group;
      * ``inv_type_perm`` — its inverse, the reduce's gather operand in
        :func:`repro_torch.core.mp.mp_typed`;
      * ``type_counts`` — rows per relation (zeros for unused relations).

    Construction validates the layout and round-trips the permutation, so
    a malformed typed graph fails at build time."""
    edge_type: Optional[np.ndarray] = None       # (E,) int32, dst-aligned
    num_relations: int = 1
    type_perm: Optional[np.ndarray] = None       # derived; see __post_init__
    inv_type_perm: Optional[np.ndarray] = None
    type_counts: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.edge_type is None:
            raise ValueError("TypedGraph requires edge_type")
        et = np.asarray(self.edge_type, np.int32)
        if et.shape != (self.num_edges,):
            raise ValueError(
                f"edge_type shape {et.shape} != (num_edges={self.num_edges},)")
        if et.size and (et.min() < 0 or et.max() >= self.num_relations):
            raise ValueError(
                f"edge_type ids must lie in [0, {self.num_relations}); "
                f"got range [{et.min()}, {et.max()}]")
        if np.any(np.diff(self.edge_index[1]) < 0):
            raise ValueError("edge_index[1] (destinations) must be sorted "
                             "non-decreasing")
        object.__setattr__(self, "edge_type", et)
        if self.type_perm is None:
            perm = np.argsort(et, kind="stable").astype(np.int32)
            inv = np.empty_like(perm)
            inv[perm] = np.arange(perm.size, dtype=np.int32)
            counts = np.bincount(et, minlength=self.num_relations)
            object.__setattr__(self, "type_perm", perm)
            object.__setattr__(self, "inv_type_perm", inv)
            object.__setattr__(self, "type_counts", counts.astype(np.int32))
        perm, inv, counts = self.type_perm, self.inv_type_perm, self.type_counts
        if not np.array_equal(perm[inv], np.arange(perm.size)):
            raise ValueError("type_perm/inv_type_perm do not round-trip")
        if np.any(np.diff(et[perm]) < 0):
            raise ValueError("type_perm does not sort edge_type")
        if int(counts.sum()) != et.size or not np.array_equal(
                counts, np.bincount(et, minlength=self.num_relations)):
            raise ValueError("type_counts disagree with edge_type")

    @property
    def typed_src(self) -> np.ndarray:
        """Source ids in (type, dst) order — the grouped matmul's gather."""
        return self.edge_index[0][self.type_perm]

    def make_relation_plan(self, feat: Optional[int] = None, config=None,
                           device=None, tune: Optional[bool] = None):
        """The grouped-matmul schedule over the relation groups (see
        :func:`repro_torch.core.plan.make_relation_plan`), on ``device``;
        memoized like :meth:`make_plan`."""
        from repro_torch.core.device import resolve_device
        from repro_torch.core.plan import make_relation_plan
        feat = self.x.shape[1] if feat is None else feat
        device = resolve_device(device, "TypedGraph.make_relation_plan")
        key = ("relation", int(feat), config, tune, str(device))
        plan = self._plan_cache.get(key)
        if plan is None:
            plan = self._plan_cache[key] = make_relation_plan(
                self.type_counts, num_rows=self.num_edges, feat=feat,
                config=config, device=device, tune=tune)
        return plan


def synth_typed_graph(name: str, num_nodes: int, num_edges: int,
                      num_relations: int = 4, feat: int = 32,
                      num_classes: int = 16, alpha: float = 1.3,
                      type_alpha: float = 1.2, seed: int = 0) -> TypedGraph:
    """A :func:`synth_graph` whose edges also carry zipf-skewed relation ids
    (``type_alpha`` sets the skew: large values leave most relations
    nearly empty)."""
    g = synth_graph(name, num_nodes, num_edges, feat=feat,
                    num_classes=num_classes, alpha=alpha, seed=seed)
    rng = np.random.default_rng(seed + 1)
    if num_edges > 0:
        w = np.minimum(rng.zipf(type_alpha, size=num_relations)
                       .astype(np.float64), max(num_edges / 2.0, 1.0))
        et = rng.choice(num_relations, size=num_edges,
                        p=w / w.sum()).astype(np.int32)
    else:
        et = np.zeros(0, np.int32)
    return TypedGraph(
        name=g.name, edge_index=g.edge_index, num_nodes=g.num_nodes,
        x=g.x, labels=g.labels, deg_inv_sqrt=g.deg_inv_sqrt,
        edge_type=et, num_relations=num_relations)


def pad_graph(g: Graph, num_nodes: int, num_edges: int) -> Graph:
    """Pad ``g`` to exactly (``num_nodes``, ``num_edges``) without changing
    what any real node computes: padded nodes are isolated (zero features,
    label 0, ``deg_inv_sqrt`` = 1); padded edges carry ``dst = num_nodes``,
    the drop id every kernel skips, so destinations stay sorted. The real
    sizes are kept in ``orig_num_nodes`` / ``orig_num_edges``."""
    v0 = g.orig_num_nodes if g.orig_num_nodes is not None else g.num_nodes
    e0 = g.orig_num_edges if g.orig_num_edges is not None else g.num_edges
    if num_nodes < g.num_nodes or num_edges < g.num_edges:
        raise ValueError(
            f"pad_graph cannot shrink: graph is (V={g.num_nodes}, "
            f"E={g.num_edges}), target (V={num_nodes}, E={num_edges})")
    dv, de = num_nodes - g.num_nodes, num_edges - g.num_edges
    pad_edges = np.stack([np.zeros(de, np.int32),
                          np.full(de, num_nodes, np.int32)])
    return Graph(
        name=g.name,
        edge_index=np.concatenate([g.edge_index, pad_edges], axis=1),
        num_nodes=num_nodes,
        x=np.concatenate(
            [g.x, np.zeros((dv, g.x.shape[1]), g.x.dtype)], axis=0),
        labels=np.concatenate([g.labels, np.zeros(dv, g.labels.dtype)]),
        deg_inv_sqrt=np.concatenate(
            [g.deg_inv_sqrt, np.ones(dv, g.deg_inv_sqrt.dtype)]),
        node_ptr=g.node_ptr,
        edge_ptr=g.edge_ptr,
        orig_num_nodes=v0,
        orig_num_edges=e0,
    )


def unpad_nodes(padded: Graph, values):
    """Slice a (V_padded, ...) per-node array back to the real rows."""
    if padded.orig_num_nodes is None:
        return values
    return values[:padded.orig_num_nodes]


def unpad_edges(padded: Graph, values):
    """Slice an (E_padded, ...) per-edge array back to the real edges."""
    if padded.orig_num_edges is None:
        return values
    return values[:padded.orig_num_edges]


def unpad_graph(padded: Graph) -> Graph:
    """Exact inverse of :func:`pad_graph` (array-for-array)."""
    if padded.orig_num_nodes is None:
        return padded
    v0, e0 = padded.orig_num_nodes, padded.orig_num_edges
    return Graph(
        name=padded.name,
        edge_index=padded.edge_index[:, :e0],
        num_nodes=v0,
        x=padded.x[:v0],
        labels=padded.labels[:v0],
        deg_inv_sqrt=padded.deg_inv_sqrt[:v0],
        node_ptr=padded.node_ptr,
        edge_ptr=padded.edge_ptr,
    )


def batch_graphs(graphs: Sequence[Graph], name: Optional[str] = None) -> Graph:
    """Block-diagonal multi-graph batching (PyG ``Batch`` convention).

    Node ids of graph g are offset by ``sum(|V_0..g-1|)``; the batched
    destinations stay sorted, so one plan covers every member graph."""
    if not graphs:
        raise ValueError("batch_graphs needs at least one graph")
    if len(graphs) == 1 and graphs[0].node_ptr is None:
        # the block-diagonal of one graph IS the graph: share its arrays
        g = graphs[0]
        return Graph(
            name=name or g.name,
            edge_index=g.edge_index,
            num_nodes=g.num_nodes,
            x=g.x,
            labels=g.labels,
            deg_inv_sqrt=g.deg_inv_sqrt,
            node_ptr=np.array([0, g.num_nodes], np.int64),
            edge_ptr=np.array([0, g.num_edges], np.int64),
            orig_num_nodes=g.orig_num_nodes,
            orig_num_edges=g.orig_num_edges,
        )
    if any(g.orig_num_nodes is not None for g in graphs):
        # a padded member's drop edges (dst = its padded V) would offset
        # onto the NEXT member's first node — batch first, then pad
        raise ValueError("batch_graphs cannot batch padded graphs; "
                         "batch first, then pad_graph the batch")
    node_ptr = np.zeros(len(graphs) + 1, np.int64)
    edge_ptr = np.zeros(len(graphs) + 1, np.int64)
    for i, g in enumerate(graphs):
        node_ptr[i + 1] = node_ptr[i] + g.num_nodes
        edge_ptr[i + 1] = edge_ptr[i] + g.num_edges
    edge_index = np.concatenate(
        [g.edge_index.astype(np.int64) + node_ptr[i]
         for i, g in enumerate(graphs)], axis=1).astype(np.int32)
    return Graph(
        name=name or "batch(" + "+".join(g.name for g in graphs) + ")",
        edge_index=edge_index,
        num_nodes=int(node_ptr[-1]),
        x=np.concatenate([g.x for g in graphs], axis=0),
        labels=np.concatenate([g.labels for g in graphs], axis=0),
        deg_inv_sqrt=np.concatenate([g.deg_inv_sqrt for g in graphs], axis=0),
        node_ptr=node_ptr,
        edge_ptr=edge_ptr,
    )


def unbatch_nodes(batched: Graph, values):
    """Split a (V_total, ...) per-node array back into per-graph arrays."""
    if batched.node_ptr is None:
        return [values]
    return [values[batched.node_ptr[i]:batched.node_ptr[i + 1]]
            for i in range(batched.num_graphs)]


def unbatch_edges(batched: Graph, values):
    """Split a (E_total, ...) per-edge array back into per-graph arrays."""
    if batched.edge_ptr is None:
        return [values]
    return [values[batched.edge_ptr[i]:batched.edge_ptr[i + 1]]
            for i in range(batched.num_graphs)]


_TABLE = {name: (v, e) for name, v, e in TABLE_II}


def dataset(name: str, feat: int = 32, seed: int = 0,
            scale: float = 1.0) -> Graph:
    """A paper-dataset stand-in by name ('cora', 'ogbn-arxiv', …) with the
    exact |V|, |E| of Table II (optionally scaled down for smoke tests)."""
    v, e = _TABLE[name]
    v, e = max(8, int(v * scale)), max(8, int(e * scale))
    return synth_graph(name, v, e, feat=feat, seed=seed)


def all_dataset_names():
    return list(_TABLE)

"""Message-passing GNNs on the unified :mod:`repro_torch.core.mp` primitive
(paper §V: GCN, GIN, GraphSAGE; plus multi-head GAT; and the relation-typed
RGCN and relational GAT), as ``nn.Module``s.

Graphs are tensors: ``edge_index`` (2, E) with ``edge_index[1]``
(destinations) sorted non-decreasing. Every layer takes

    layer(x, edge_index, num_nodes, deg_inv_sqrt=None, *, impl=None,
          plan=None, mesh=None, partition=None)

and routes its aggregation through ``mp`` / ``mp_transform``. Passing
``partition=`` (a :class:`~repro_torch.data.partition.PartitionedGraph`,
with ``plan`` its :class:`~repro_torch.core.plan.PartitionedPlan` and
``mesh`` this rank's :class:`~repro_torch.core.dist_mp.ShardMesh`)
routes every aggregation through :mod:`repro_torch.core.dist_mp`: the same
kernels run on the rank's shard and the partials merge by collectives;
the logits stay the replicated global (V, C). The typed families refuse
a partition. Parameters
keep the reference's ``(d_in, d_out)`` layout (``y = x @ w``), so weights
carry across from the JAX package unchanged
(:func:`repro_torch.models.params.from_jax_params`).

Padded edges carry ``dst = num_nodes`` (the drop id); the per-node lookups
of GCN and GAT clamp it to a real node, and the kernels drop those rows.

The typed families (``TYPED_MODELS``) also take ``edge_type`` and, from a
:class:`~repro_torch.data.graphs.TypedGraph`, the permutation triple
``type_perm`` / ``inv_type_perm`` / ``type_counts`` and an ``rplan``
(:class:`~repro_torch.core.plan.RelationPlan`); each of their layers runs
its per-relation transforms as one grouped ``segment_matmul`` launch.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Union

import torch
from torch import nn

from repro_torch import obs
from repro_torch.core import ops as geot
from repro_torch.core.device import resolve_device
from repro_torch.core.mp import mp, mp_transform, mp_typed, type_permutation
from repro_torch.obs.trace import span

__all__ = ["GCNLayer", "GINLayer", "SAGELayer", "GATLayer", "RGCNLayer",
           "RGATLayer", "GNN", "MODELS", "TYPED_MODELS", "init", "forward",
           "loss_fn", "cross_entropy", "make_model_plan"]

# the homogeneous families every graph supports (the serving model space);
# relation-typed families need a TypedGraph and are listed apart
MODELS = ("gcn", "gin", "sage", "gat")
TYPED_MODELS = ("rgcn", "rgat")

# GAT's attention scores (edges × heads) by layer, registered with the
# module so that the obs schema holds it before a GAT runs
_SCORES = obs.get_registry().counter(
    "gat.scores", labels=("layer",),
    help="GAT attention scores computed (edges x heads), by layer")


def _dense(d_in: int, d_out: int, generator, dtype):
    std = 1.0 / math.sqrt(d_in)
    return nn.Parameter(torch.randn(d_in, d_out, generator=generator,
                                    dtype=dtype) * std)


def _zeros(shape, dtype):
    return nn.Parameter(torch.zeros(shape, dtype=dtype))


def _mp(x, edge_index, num_nodes, *, reduce, edge_weight=None, plan=None,
        impl=None, mesh=None, partition=None):
    """Plain or sharded message passing: one switch for every layer
    (``plan`` is a SegmentPlan or, sharded, a PartitionedPlan)."""
    if partition is None:
        return mp(x, edge_index, num_nodes, reduce=reduce,
                  edge_weight=edge_weight, plan=plan, impl=impl)
    from repro_torch.core.dist_mp import mp_sharded
    return mp_sharded(x, partition, reduce=reduce, edge_weight=edge_weight,
                      pplan=plan, mesh=mesh, impl=impl)


def _mp_transform(x, w, edge_index, num_nodes, *, reduce, edge_weight=None,
                  plan=None, impl=None, mesh=None, partition=None):
    if partition is None:
        return mp_transform(x, w, edge_index, num_nodes, reduce=reduce,
                            edge_weight=edge_weight, plan=plan, impl=impl)
    from repro_torch.core.dist_mp import mp_transform_sharded
    return mp_transform_sharded(x, w, partition, reduce=reduce,
                                edge_weight=edge_weight, pplan=plan,
                                mesh=mesh, impl=impl)


def _node_ids(dst, num_nodes: int):
    """Destinations as per-node lookup ids: drop-id edges clamp to a real
    node (their values never reach an output)."""
    return dst.clamp_max(max(num_nodes - 1, 0)).long()


class GCNLayer(nn.Module):
    """GCN: Y = D^{-1/2} A D^{-1/2} X W + b — a weighted sum with the
    transform/aggregate order of ``mp_transform``."""

    def __init__(self, d_in: int, d_out: int, *, generator=None,
                 dtype=torch.float32):
        super().__init__()
        self.w = _dense(d_in, d_out, generator, dtype)
        self.b = _zeros((d_out,), dtype)

    def forward(self, x, edge_index, num_nodes: int, deg_inv_sqrt=None, *,
                impl=None, plan=None, mesh=None, partition=None):
        if deg_inv_sqrt is None:
            raise ValueError("GCNLayer needs deg_inv_sqrt")
        src, dst = edge_index[0], edge_index[1]
        w_e = (deg_inv_sqrt[src.long()]
               * deg_inv_sqrt[_node_ids(dst, num_nodes)])
        out = _mp_transform(x, self.w, edge_index, num_nodes, reduce="sum",
                            edge_weight=w_e, plan=plan, impl=impl, mesh=mesh,
                            partition=partition)
        return out + self.b


class GINLayer(nn.Module):
    """GIN: h' = MLP((1+ε)·h + Σ_neighbours h) — an unweighted sum; the MLP
    is non-linear, so there is no reordering."""

    def __init__(self, d_in: int, d_out: int, *, generator=None,
                 dtype=torch.float32):
        super().__init__()
        self.mlp1 = _dense(d_in, d_out, generator, dtype)
        self.mlp2 = _dense(d_out, d_out, generator, dtype)
        self.b1 = _zeros((d_out,), dtype)
        self.b2 = _zeros((d_out,), dtype)
        self.eps = _zeros((), torch.float32)

    def forward(self, x, edge_index, num_nodes: int, deg_inv_sqrt=None, *,
                impl=None, plan=None, mesh=None, partition=None):
        agg = _mp(x, edge_index, num_nodes, reduce="sum", plan=plan,
                  impl=impl, mesh=mesh, partition=partition)
        h = (1.0 + self.eps) * x + agg
        h = torch.relu(h @ self.mlp1 + self.b1)
        return h @ self.mlp2 + self.b2


class SAGELayer(nn.Module):
    """GraphSAGE (mean aggregator); the neighbour transform may reorder
    (mean commutes with W)."""

    def __init__(self, d_in: int, d_out: int, *, generator=None,
                 dtype=torch.float32):
        super().__init__()
        self.w_self = _dense(d_in, d_out, generator, dtype)
        self.w_neigh = _dense(d_in, d_out, generator, dtype)
        self.b = _zeros((d_out,), dtype)

    def forward(self, x, edge_index, num_nodes: int, deg_inv_sqrt=None, *,
                impl=None, plan=None, mesh=None, partition=None):
        neigh = _mp_transform(x, self.w_neigh, edge_index, num_nodes,
                              reduce="mean", plan=plan, impl=impl, mesh=mesh,
                              partition=partition)
        return x @ self.w_self + neigh + self.b


class GATLayer(nn.Module):
    """Multi-head GAT (Veličković et al., ICLR 2018): attention by one
    multi-head ``segment_softmax`` launch, then one α-weighted sum per head.

    ``concat``: the heads' outputs side by side, so ``d_out`` is the
    heads' widths together (``d_out // heads`` a head); otherwise they are
    averaged and a head is ``d_out`` wide. ``bias``: a bias added after
    the concat or mean. ``skip``: a linear skip connection, ``x @ w_skip +
    b_skip`` added to the output (PyG's ``examples/ppi.py``). The defaults
    are the reference's layer: averaged heads, no bias, no skip. The
    attention (the scores, their per-edge rows and the softmax) is the span
    ``gat.attention``; the weighted sums stay under ``mp.aggregate``."""

    def __init__(self, d_in: int, d_out: int, *, heads: int = 1,
                 concat: bool = False, bias: bool = False,
                 skip: bool = False, generator=None, dtype=torch.float32):
        super().__init__()
        if concat and d_out % heads:
            raise ValueError(f"GATLayer: concatenated heads need d_out "
                             f"({d_out}) to be a multiple of heads ({heads})")
        self.heads, self.concat = heads, concat
        self.head_dim = d_out // heads if concat else d_out
        self.index = 0          # the layer's place in its stack: a label
        scale = 1.0 / math.sqrt(self.head_dim)
        self.w = _dense(d_in, heads * self.head_dim, generator, dtype)
        self.a_src = nn.Parameter(torch.randn(
            heads, self.head_dim, generator=generator, dtype=dtype) * scale)
        self.a_dst = nn.Parameter(torch.randn(
            heads, self.head_dim, generator=generator, dtype=dtype) * scale)
        self.register_parameter("b", _zeros((d_out,), dtype) if bias
                                else None)
        self.register_parameter(
            "w_skip", _dense(d_in, d_out, generator, dtype) if skip else None)
        self.register_parameter("b_skip", _zeros((d_out,), dtype) if skip
                                else None)

    def forward(self, x, edge_index, num_nodes: int, deg_inv_sqrt=None, *,
                impl=None, plan=None, mesh=None, partition=None):
        src, dst = edge_index[0], edge_index[1]
        h = x @ self.w                                       # (V, heads*d)
        hh = h.reshape(h.shape[0], self.heads, self.head_dim)
        with span("gat.attention", heads=self.heads, width=self.head_dim):
            logit_src = torch.einsum("vhd,hd->vh", hh, self.a_src)
            logit_dst = torch.einsum("vhd,hd->vh", hh, self.a_dst)
            # per-edge rows through geot.gather, whose backward is the
            # deterministic sort-and-reduce (not an atomic scatter)
            e = nn.functional.leaky_relu(
                geot.gather(logit_src, src)
                + geot.gather(logit_dst, _node_ids(dst, num_nodes)),
                0.2)                                         # (E, heads)
            _SCORES.inc(e.numel(), layer=str(self.index))
            if partition is None:
                alpha = geot.segment_softmax(e.contiguous(), dst, num_nodes,
                                             impl, None, plan)
            else:
                # the rank's (E_pad, heads) block, fed to the weighted sums
                # as it is, never gathered back to global edge order
                from repro_torch.core.dist_mp import segment_softmax_sharded
                alpha = segment_softmax_sharded(e.contiguous(), partition,
                                                pplan=plan, mesh=mesh,
                                                impl=impl)
        outs = [_mp(hh[:, i, :].contiguous(), edge_index, num_nodes,
                    reduce="sum", edge_weight=alpha[:, i].contiguous(),
                    plan=plan, impl=impl, mesh=mesh, partition=partition)
                for i in range(self.heads)]
        out = torch.cat(outs, 1) if self.concat else sum(outs) / self.heads
        if self.b is not None:
            out = out + self.b
        if self.w_skip is not None:
            out = out + x @ self.w_skip + self.b_skip
        return out


def _require_typed(name: str, edge_type, partition=None) -> None:
    if edge_type is None:
        raise ValueError(f"{name} needs edge_type (a relation-typed graph; "
                         "see repro_torch.data.graphs.TypedGraph)")
    if partition is not None:
        raise NotImplementedError("typed layers are single-shard for now")


class RGCNLayer(nn.Module):
    """RGCN: h' = h·W_self + mean_{(s,d,r)} h_s·W_r + b — the mean over all
    incoming typed messages (the reference's single-normalizer form of
    Schlichtkrull's per-relation 1/c_{i,r}): one grouped matmul and one
    mean reduce per layer."""

    def __init__(self, d_in: int, d_out: int, *, num_relations: int = 4,
                 generator=None, dtype=torch.float32):
        super().__init__()
        self.w_rel = nn.Parameter(torch.randn(
            num_relations, d_in, d_out, generator=generator, dtype=dtype)
            / math.sqrt(d_in))
        self.w_self = _dense(d_in, d_out, generator, dtype)
        self.b = _zeros((d_out,), dtype)

    def forward(self, x, edge_index, num_nodes: int, deg_inv_sqrt=None, *,
                impl=None, plan=None, mesh=None, partition=None,
                edge_type=None, type_perm=None, inv_type_perm=None,
                type_counts=None, rplan=None):
        _require_typed("RGCNLayer", edge_type, partition)
        agg = mp_typed(x, self.w_rel, edge_index, edge_type, num_nodes,
                       type_perm=type_perm, inv_type_perm=inv_type_perm,
                       type_counts=type_counts, reduce="mean", plan=plan,
                       rplan=rplan, impl=impl)
        return x @ self.w_self + agg + self.b


class RGATLayer(nn.Module):
    """Relational multi-head GAT (the reference's one-launch variant):

        e = LeakyReLU( a_src[r]·(h_s W_r) + a_dst[r]·h_d )

    scores the transformed source against the relation's view of the raw
    destination, so only sources need the per-relation transform: one
    grouped ``segment_matmul`` launch per layer. The softmax normalizes over
    each destination's incoming edges (all relations together) in one
    multi-head launch; the α-weighted sums gather the type-ordered messages
    through ``inv_type_perm``. Head outputs are averaged."""

    def __init__(self, d_in: int, d_out: int, *, heads: int = 1,
                 num_relations: int = 4, generator=None, dtype=torch.float32):
        super().__init__()
        self.heads, self.d_out = heads, d_out
        self.w_rel = nn.Parameter(torch.randn(
            num_relations, d_in, heads * d_out, generator=generator,
            dtype=dtype) / math.sqrt(d_in))
        self.a_src = nn.Parameter(torch.randn(
            num_relations, heads, d_out, generator=generator, dtype=dtype)
            / math.sqrt(d_out))
        self.a_dst = nn.Parameter(torch.randn(
            num_relations, heads, d_in, generator=generator, dtype=dtype)
            / math.sqrt(d_in))

    def forward(self, x, edge_index, num_nodes: int, deg_inv_sqrt=None, *,
                impl=None, plan=None, mesh=None, partition=None,
                edge_type=None, type_perm=None, inv_type_perm=None,
                type_counts=None, rplan=None):
        _require_typed("RGATLayer", edge_type, partition)
        src, dst = edge_index[0], edge_index[1]
        type_perm, inv_type_perm, type_counts = type_permutation(
            edge_type, int(self.w_rel.shape[0]), type_perm, inv_type_perm,
            type_counts)
        et_t = edge_type.index_select(0, type_perm)  # per typed row
        # the plan's source order is the graph's: these ops gather by
        # inv_type_perm
        plan = None if plan is None else plan.without_source_order()
        n_rel = int(self.w_rel.shape[0])
        # transformed sources in (type, dst) order: the layer's ONE grouped
        # launch
        msg = geot.grouped_segment_matmul(
            geot.gather(x, src.index_select(0, type_perm)), type_counts,
            self.w_rel, impl, None, rplan)
        msg_h = msg.reshape(msg.shape[0], self.heads, self.d_out)
        a_src = geot.gather(self.a_src.reshape(n_rel, -1), et_t)
        a_dst = geot.gather(self.a_dst.reshape(n_rel, -1), et_t)
        logit_src = torch.einsum("ehd,ehd->eh", msg_h,
                                 a_src.reshape(msg_h.shape))
        logit_dst = torch.einsum(
            "ek,ehk->eh", geot.gather(x, dst.index_select(0, type_perm)),
            a_dst.reshape(-1, self.heads, self.a_dst.shape[-1]))
        e_t = nn.functional.leaky_relu(logit_src + logit_dst, 0.2)
        e = e_t.index_select(0, inv_type_perm)     # back to dst order
        alpha = geot.segment_softmax(e, dst, num_nodes, impl, None, plan)
        out = 0.0
        for i in range(self.heads):
            out = out + geot.index_weight_segment_reduce(
                msg_h[:, i, :].contiguous(), inv_type_perm,
                alpha[:, i].contiguous(), dst, num_nodes, "sum", impl, None,
                plan)
        return out / self.heads


_LAYER = {"gcn": GCNLayer, "gin": GINLayer, "sage": SAGELayer,
          "gat": GATLayer, "rgcn": RGCNLayer, "rgat": RGATLayer}


_ACTIVATIONS = {"relu": torch.relu, "elu": nn.functional.elu}


def _per_layer(value, n: int, what: str) -> list:
    """``value`` for each of ``n`` layers: one value for all, or a
    sequence of ``n``."""
    if isinstance(value, (list, tuple)):
        if len(value) != n:
            raise ValueError(f"{what}: {len(value)} values for {n} layers")
        return list(value)
    return [value] * n


class GNN(nn.Module):
    """A stack of one family's layers with ``activation`` (ReLU, or ELU as
    in GAT's paper) between them (paper §V-F: node classification, 3
    layers). ``dims`` = [d_in, hidden..., classes], each the width of a
    layer's output. GAT's options: ``heads`` and ``concat`` one value for
    every layer or one a layer (a concatenating layer's output is its
    heads' widths together), ``bias`` and ``skip`` (:class:`GATLayer`). A
    forward is the span ``gnn.forward``, each layer (its aggregation, self
    transform, bias and activation) a ``gnn.layer`` under it."""

    def __init__(self, family: str, dims: Sequence[int], *,
                 heads: Union[int, Sequence[int]] = 1,
                 concat: Union[bool, Sequence[bool]] = False,
                 bias: bool = False, skip: bool = False,
                 activation: str = "relu", num_relations: int = 4,
                 generator=None, dtype=torch.float32):
        super().__init__()
        if family not in _LAYER:
            raise ValueError(f"unknown model {family!r}; one of "
                             f"{MODELS + TYPED_MODELS}")
        if activation not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}; one of "
                             f"{tuple(_ACTIVATIONS)}")
        n = len(dims) - 1
        heads, concat = _per_layer(heads, n, "heads"), \
            _per_layer(concat, n, "concat")
        if family != "gat" and (any(concat) or bias or skip):
            raise ValueError("concat, bias and skip are GAT's options")
        self.family, self.activation = family, activation
        self.dims = [int(d) for d in dims]
        kws = [{} for _ in range(n)]
        for i, kw in enumerate(kws):
            if family in ("gat", "rgat"):
                kw["heads"] = heads[i]
            if family == "gat":
                kw.update(concat=concat[i], bias=bias, skip=skip)
            if family in TYPED_MODELS:
                kw["num_relations"] = num_relations
        self.layers = nn.ModuleList(
            _LAYER[family](self.dims[i], self.dims[i + 1], generator=generator,
                           dtype=dtype, **kws[i])
            for i in range(n))
        if family == "gat":
            for i, layer in enumerate(self.layers):
                layer.index = i

    def forward(self, x, edge_index, num_nodes: int, deg_inv_sqrt=None, *,
                impl: Optional[str] = None, plan=None, mesh=None,
                partition=None, edge_type=None, type_perm=None,
                inv_type_perm=None, type_counts=None, rplan=None):
        typed = {}
        if self.family in TYPED_MODELS:
            typed = dict(edge_type=edge_type, type_perm=type_perm,
                         inv_type_perm=inv_type_perm,
                         type_counts=type_counts, rplan=rplan)
        act = _ACTIVATIONS[self.activation]
        last = len(self.layers) - 1
        with span("gnn.forward", family=self.family, layers=last + 1):
            if partition is not None and plan is None \
                    and self.family not in TYPED_MODELS:
                plan = partition.make_plan(feat=max(self.dims))
            h = x
            for i, layer in enumerate(self.layers):
                with span("gnn.layer", index=i, d_in=self.dims[i],
                          d_out=self.dims[i + 1]):
                    h = layer(h, edge_index, num_nodes, deg_inv_sqrt,
                              impl=impl, plan=plan, mesh=mesh,
                              partition=partition, **typed)
                    if i < last:
                        h = act(h)
            return h


def init(family: str, d_in: int, hidden: int, num_classes: int,
         num_layers: int = 3, *, heads: int = 1, num_relations: int = 4,
         seed: int = 0, device=None) -> GNN:
    """A ``num_layers`` model with random weights drawn on the CPU from a
    ``torch.Generator`` seeded with ``seed`` (the same weights on any
    device), then moved to ``device``: the card for ``None`` (raising
    without one), the CPU only for ``device="cpu"``. ``heads`` > 1 builds
    multi-head attention layers (GAT/RGAT); ``num_relations`` sizes the
    per-relation transforms of the typed families."""
    device = resolve_device(device, "gnn.init")
    generator = torch.Generator().manual_seed(seed)
    dims: List[int] = [d_in] + [hidden] * (num_layers - 1) + [num_classes]
    model = GNN(family, dims, heads=heads, num_relations=num_relations,
                generator=generator)
    return model.to(device)


def forward(model: GNN, x, edge_index, num_nodes: int, deg_inv_sqrt=None,
            impl: Optional[str] = None, plan=None, *, mesh=None,
            partition=None, edge_type=None, type_perm=None,
            inv_type_perm=None, type_counts=None, rplan=None):
    """Logits (V, C) of ``model`` on one graph; ``plan`` is one
    :class:`~repro_torch.core.plan.SegmentPlan` over the destinations,
    reused by every layer. ``partition`` / ``mesh``: run every aggregation
    sharded across the ranks (``plan`` then the partition's
    :class:`~repro_torch.core.plan.PartitionedPlan`, built when omitted);
    the logits stay the replicated global (V, C). Typed families also take
    ``edge_type`` (plus the optional permutation triple and ``rplan``)."""
    return model(x, edge_index, num_nodes, deg_inv_sqrt, impl=impl, plan=plan,
                 mesh=mesh, partition=partition,
                 edge_type=edge_type, type_perm=type_perm,
                 inv_type_perm=inv_type_perm, type_counts=type_counts,
                 rplan=rplan)


def loss_fn(model: GNN, x, edge_index, labels, num_nodes: int,
            deg_inv_sqrt=None, impl: Optional[str] = None, plan=None, *,
            mesh=None, partition=None, edge_type=None, type_perm=None,
            inv_type_perm=None, type_counts=None, rplan=None):
    """Node-classification cross entropy, mean over the nodes of
    ``logsumexp(logits) - logits[label]`` (the reference's ``loss_fn``),
    with the keyword surface of :func:`forward`."""
    logits = forward(model, x, edge_index, num_nodes, deg_inv_sqrt, impl,
                     plan, mesh=mesh, partition=partition,
                     edge_type=edge_type, type_perm=type_perm,
                     inv_type_perm=inv_type_perm, type_counts=type_counts,
                     rplan=rplan)
    return cross_entropy(logits, labels)


def cross_entropy(logits, labels, mask=None):
    """mean(logsumexp(logits) - logits[label]) over the rows, in fp32; with
    a (V,) ``mask``, the mean over the rows it weights (the reference's
    masked loss: sum(mask · nll) / max(sum(mask), 1))."""
    logits = logits.float()
    gold = logits.gather(1, labels.long()[:, None])[:, 0]
    nll = torch.logsumexp(logits, dim=-1) - gold
    if mask is None:
        return nll.mean()
    return (mask * nll).sum() / mask.sum().clamp_min(1.0)


def make_model_plan(edge_index, num_nodes: int, feat: int,
                    tune: Optional[bool] = None, config=None, device=None):
    """One :class:`~repro_torch.core.plan.SegmentPlan` for every layer (and
    every backward) of a model on this graph (``feat``: the widest layer
    width), on ``device``. ``tune=True`` selects the config from a sweep
    measured on the card, once per shape class (kept in the PerfDB),
    instead of the generated rules."""
    from repro_torch.core.plan import make_graph_plan
    return make_graph_plan(edge_index, num_nodes, feat=feat, config=config,
                           device=device, tune=tune)

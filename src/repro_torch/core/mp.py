"""Unified message-passing primitive every GNN layer routes through.

* :func:`mp` — gather from the source, reduce into the destination over a
  destination-sorted ``edge_index``: ``reduce`` ∈ {sum, mean, max} ×
  {weighted, unweighted}, each one CUDA kernel launch on the card.

* :func:`mp_transform` — message passing composed with a dense transform
  ``W``, with one of three schedules per layer:

      aggregate(X) @ W        (aggregate-first)   reduce width = d_in
      aggregate(X @ W)        (transform-first)   reduce width = d_out
      fused(X, W)             (fused)             SpMM+GEMM, one launch

  ``order="auto"`` costs the three on the H100 model
  (:func:`choose_order`, with the plan's degree skew): the fused arm only
  with the CUDA kernel and where the Hopper shared-memory gate
  :func:`~repro_torch.kernels.fused_transform_reduce.fusable` holds at the
  config's tile. Reordering is valid only for linear reduces (sum / mean
  commute with ``W``); ``max`` pins transform-first.

* :func:`mp_typed` — relation-typed message passing: the per-relation
  transforms of every edge as one grouped ``segment_matmul`` launch, then
  one gather-reduce whose gather operand is the inverse type permutation.

Spans (:mod:`repro_torch.obs.trace`): ``mp.order`` is the host's choice of
order; ``mp.aggregate`` holds exactly the gather, fused, grouped and
segment launches of each call, whatever kernel implements them, and never
the dense ``x @ w`` of a two-launch order.

``reduce="max"`` fills empty-neighbourhood rows with 0 (exactly the rows
the kernel reports as ``-inf``) rather than the segment-max identity.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import ops as geot
from repro_torch.core.config_space import KernelConfig
from repro_torch.kernels.fused_transform_reduce import fusable
from repro_torch.kernels.ops import resolve_impl
from repro_torch.obs.trace import span

__all__ = ["mp", "mp_transform", "mp_typed", "type_permutation",
           "choose_order", "resolve_order"]

_LINEAR_REDUCES = ("sum", "mean")
_ORDERS = ("auto", "aggregate_first", "transform_first", "fused")


def choose_order(d_in: int, d_out: int, *, plan=None,
                 num_edges: Optional[int] = None,
                 num_nodes: Optional[int] = None,
                 config: Optional[KernelConfig] = None,
                 allow_fused: bool = False, dtype=torch.float32) -> str:
    """The H100 cost model's order for a linear reduce:
    ``"transform_first"``, ``"aggregate_first"`` or (with ``allow_fused``
    and where the fused block fits at the config's tile) ``"fused"``.

    Each order is costed end to end (:mod:`repro_torch.core.costmodel`):
    the two-launch orders run the gather at width d_out or d_in plus the
    dense product; the fused arm skips the (S, d_in) aggregate's round trip
    and the second launch. With a ``plan``, |E|, |V|, the config and the
    degree skew come from it; otherwise ``num_edges`` and ``num_nodes``
    must be given (skew 1). Tie-breaks are the reference's:
    transform-first is the default, aggregate-first must win strictly, and
    the fused arm must beat both strictly."""
    from repro_torch.core import costmodel
    from repro_torch.core.config_space import io_dtype_bytes
    if plan is not None:
        m, s = plan.stats.num_rows, plan.stats.num_segments
        skew = plan.stats.skew
        cfg = config or plan.config
    else:
        if num_edges is None or num_nodes is None:
            raise ValueError("choose_order needs a plan or "
                             "num_edges + num_nodes")
        m, s, skew = int(num_edges), int(num_nodes), 1.0
        cfg = config
    if cfg is None:
        from repro_torch.core.heuristics import select_config
        cfg = select_config(max(m, 1), max(s, 1), max(d_in, d_out),
                            tune=False)
    db = io_dtype_bytes(dtype)
    dense = costmodel.dense_matmul_cost(s, d_in, d_out, db).total_s
    # insertion order is the tie-break (min keeps the first minimum)
    t = {
        "transform_first":
            costmodel.spmm_cost(m, s, d_out, cfg, db, skew=skew).total_s
            + dense,
        "aggregate_first":
            costmodel.spmm_cost(m, s, d_in, cfg, db, skew=skew).total_s
            + dense,
    }
    if allow_fused and fusable(d_in, d_out, dtype, cfg):
        t["fused"] = costmodel.fused_transform_reduce_cost(
            m, s, d_in, d_out, cfg, db, skew=skew).total_s
    return min(t, key=t.get)


def resolve_order(reduce: str, order: str, d_in: int, d_out: int, *,
                  plan=None, num_edges: Optional[int] = None,
                  num_nodes: Optional[int] = None,
                  config: Optional[KernelConfig] = None,
                  allow_fused: bool = False, dtype=torch.float32) -> str:
    """Validate and resolve the transform/aggregate order for one layer.
    Non-linear reduces do not commute with ``W`` and pin transform-first;
    ``"fused"`` needs a linear reduce and the CUDA backend
    (``allow_fused``); ``"auto"`` is :func:`choose_order`."""
    if order not in _ORDERS:
        raise ValueError(f"unknown order: {order!r}")
    if reduce not in _LINEAR_REDUCES:
        if order in ("aggregate_first", "fused"):
            raise ValueError(
                f"reduce={reduce!r} does not commute with the transform; "
                f"{order} would compute a different function")
        return "transform_first"
    if order == "fused" and not allow_fused:
        raise ValueError("order='fused' needs the one-launch CUDA kernel "
                         "(impl='cuda' on CUDA tensors)")
    if order == "auto":
        return choose_order(d_in, d_out, plan=plan, num_edges=num_edges,
                            num_nodes=num_nodes, config=config,
                            allow_fused=allow_fused, dtype=dtype)
    return order


def _drop_empty_max(y):
    """Replace exactly -inf (empty neighbourhoods of a max), so a
    legitimate +inf/NaN aggregate still surfaces downstream."""
    return torch.where(y == float("-inf"), torch.zeros_like(y), y)


def _aggregate(x, edge_index, num_nodes: int, reduce: str, edge_weight,
               plan, impl: Optional[str], config: Optional[KernelConfig],
               **attrs):
    """The gather-reduce of :func:`mp` and of :func:`mp_transform`'s
    two-launch orders, as the span ``mp.aggregate`` (``attrs``: the
    order, where there is one)."""
    if reduce not in ("sum", "mean", "max"):
        raise ValueError(f"unknown reduce: {reduce!r}")
    src, dst = edge_index[0], edge_index[1]
    with span("mp.aggregate", reduce=reduce, width=int(x.shape[-1]),
              **attrs):
        if edge_weight is None:
            y = geot.index_segment_reduce(x, src, dst, num_nodes, reduce,
                                          impl, config, plan)
        else:
            y = geot.index_weight_segment_reduce(x, src, edge_weight, dst,
                                                 num_nodes, reduce, impl,
                                                 config, plan)
    return _drop_empty_max(y) if reduce == "max" else y


def mp(x, edge_index, num_nodes: int, *, reduce: str = "sum",
       edge_weight=None, plan=None, impl: Optional[str] = None,
       config: Optional[KernelConfig] = None):
    """Message passing: Y[d] = reduce_{(s,d) ∈ E} (w_e ·) X[s].

    ``edge_index``: (2, E) with ``edge_index[1]`` sorted non-decreasing;
    ``plan``: SegmentPlan over the destinations, shared by every layer."""
    return _aggregate(x, edge_index, num_nodes, reduce, edge_weight, plan,
                      impl, config)


def mp_transform(x, w, edge_index, num_nodes: int, *, reduce: str = "sum",
                 edge_weight=None, plan=None, impl: Optional[str] = None,
                 config: Optional[KernelConfig] = None, order: str = "auto"):
    """Message passing with a dense transform: aggregate(X·W),
    aggregate(X)·W, or the one-launch fused SpMM+GEMM (``order="auto"``
    applies :func:`choose_order`, as the span ``mp.order``). The dense
    product of the two-launch orders stays outside ``mp.aggregate``."""
    impl = resolve_impl(x, impl)
    if config is None and plan is not None:
        config = plan.config
    with span("mp.order") as chosen:
        order = resolve_order(reduce, order, int(x.shape[-1]),
                              int(w.shape[-1]), plan=plan,
                              num_edges=int(edge_index.shape[-1]),
                              num_nodes=num_nodes, config=config,
                              allow_fused=(impl == "cuda"), dtype=x.dtype)
        chosen.set(order=order)
    if order == "fused":
        src, dst = edge_index[0], edge_index[1]
        with span("mp.aggregate", reduce=reduce, width=int(x.shape[-1]),
                  order=order):
            return geot.fused_transform_reduce(x, w, src, edge_weight, dst,
                                               num_nodes, reduce, impl,
                                               config, plan)
    if order == "aggregate_first":
        return _aggregate(x, edge_index, num_nodes, reduce, edge_weight,
                          plan, impl, config, order=order) @ w
    return _aggregate(x @ w, edge_index, num_nodes, reduce, edge_weight,
                      plan, impl, config, order=order)


def type_permutation(edge_type, num_types: int, type_perm=None,
                     inv_type_perm=None, type_counts=None):
    """The (type_perm, inv_type_perm, type_counts) triple of dst-aligned
    ``edge_type``, each computed here only when not given: a stable argsort
    (rows in (type, dst) order), its inverse, and rows per relation."""
    if type_perm is None:
        type_perm = torch.argsort(edge_type, stable=True)
    if type_counts is None:
        type_counts = torch.bincount(edge_type.long(), minlength=num_types)
    if inv_type_perm is None:
        inv_type_perm = torch.empty_like(type_perm)
        inv_type_perm[type_perm] = torch.arange(
            type_perm.shape[0], dtype=type_perm.dtype,
            device=type_perm.device)
    return type_perm, inv_type_perm, type_counts


def mp_typed(x, w, edge_index, edge_type, num_nodes: int, *,
             type_perm=None, inv_type_perm=None, type_counts=None,
             reduce: str = "sum", edge_weight=None, plan=None, rplan=None,
             impl: Optional[str] = None,
             config: Optional[KernelConfig] = None):
    """Heterogeneous message passing:

        Y[d] = reduce_{(s,d,r) ∈ E} (w_e ·) X[s] @ W[r]

    ``edge_index`` (2, E) destination-sorted; ``edge_type`` (E,) aligned
    with it; ``w`` (R, d_in, d_out). The sources are gathered in (type, dst)
    order, so each relation's rows are contiguous, and transformed by ONE
    grouped ``segment_matmul`` launch; the reduce then gathers those rows
    back through ``inv_type_perm``, so the un-permute costs no launch.

    The permutation triple comes precomputed from a
    :class:`~repro_torch.data.graphs.TypedGraph` or is derived here.
    ``plan``: SegmentPlan over the destinations; ``rplan``: RelationPlan
    over the type groups."""
    if reduce not in ("sum", "mean", "max"):
        raise ValueError(f"unknown reduce: {reduce!r}")
    src, dst = edge_index[0], edge_index[1]
    type_perm, inv_type_perm, type_counts = type_permutation(
        edge_type, int(w.shape[0]), type_perm, inv_type_perm, type_counts)
    # the reduce gathers by inv_type_perm, not by the sources a graph
    # plan's source order was built for
    plan = None if plan is None else plan.without_source_order()
    typed_src = src.index_select(0, type_perm)
    with span("mp.aggregate", reduce=reduce, width=int(x.shape[-1])):
        msg = geot.gather(x, typed_src)
        msg = geot.grouped_segment_matmul(msg, type_counts, w, impl, None,
                                          rplan)
        if edge_weight is None:
            y = geot.index_segment_reduce(msg, inv_type_perm, dst, num_nodes,
                                          reduce, impl, config, plan)
        else:
            y = geot.index_weight_segment_reduce(msg, inv_type_perm,
                                                 edge_weight, dst, num_nodes,
                                                 reduce, impl, config, plan)
    return _drop_empty_max(y) if reduce == "max" else y

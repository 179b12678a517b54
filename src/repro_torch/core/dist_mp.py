"""Sharded message passing on ``torch.distributed`` (the port of
``repro/core/dist_mp.py``).

The reference is one controller over a 1-D ``"shard"`` device mesh
(``shard_map``). The port is SPMD: one process a shard, every rank
running the same program, each on its own device (a
:class:`ShardMesh` names the process group, the rank and the device).
The single-device :mod:`repro_torch.core.mp` primitive becomes two
stages on every rank:

  1. **local**: the rank runs the same kernels as a single device
     (:mod:`repro_torch.kernels`: the gather, the softmax,
     segment_reduce) over its own edge shard, with its own
     :class:`~repro_torch.core.plan.SegmentPlan` from a
     :class:`~repro_torch.core.plan.PartitionedPlan`. Features are read
     from the rank's own node block: an edge lives with its source (see
     :mod:`repro_torch.data.partition`).
  2. **merge**: the partial aggregates of cut (halo) edges are combined
     across ranks by torch collectives outside the kernels, with the
     reduce's own algebra:

       sum      all-reduce (or the ring of
                :func:`repro_torch.distributed.collectives.ring_allreduce`)
       mean     the all-reduced partial *sums*, then one divide by the
                global in-degree ``pg.deg``: never a mean of means
       max      all-gather, then the max. At tied maxima spanning ranks
                the gradient is split evenly among the tied ranks: a
                valid subgradient (it sums to the cotangent), as the
                reference documents
       softmax  the two-stage online-softmax merge: every rank's local
                softmax is exact for its local statistics; the global
                answer rescales it by ``z_loc / z_glob`` per segment, both
                sum-exps taken at the all-reduced global max

Every entry point takes the reference's *global* arguments (node features
(V, F), per-edge values (E, ...) in the graph's dst-sorted order) and
returns the replicated global result, so a sharded call is a drop-in for
its single-device twin up to float-summation order. A rank's per-edge
block (E_pad, ...) is accepted where the reference accepts the stacked
(S, E_pad, ...) values: :func:`segment_softmax_sharded` returns the rank's
block, and ``mp_sharded(edge_weight=...)`` takes it.

**Gradients.** Each merge is an explicit ``torch.autograd.Function``
placed so that every rank's replicated parameters get the single-device
gradient, bitwise equal on every rank, with no gradient all-reduce:

  * the *entry* into a shard (the rank's node or edge block of a
    replicated tensor: x, GCN's edge weights, GAT's logits) is the
    identity forward and an **all-reduce** of the scattered cotangent
    backward (the blocks are disjoint, so the sum is exact);
  * the output merge of :func:`mp_sharded` feeds computation every rank
    repeats: all-reduce forward, **identity** backward (an all-reduce
    there would give S times the gradient);
  * the max merge sends the cotangent only to the ranks whose partial is
    the maximum;
  * the softmax's ``z_glob`` is consumed by rank-local computation: its
    backward **is** an all-reduce. The max statistic carries no gradient.

The caller picks the backend in ``init_process_group`` (NCCL across
cards, gloo on the CPU or several ranks on one card); nothing here
switches backends or falls back to the CPU. With gloo a CUDA tensor's
collective goes through host memory.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import ops as geot
from repro_torch.core.config_space import KernelConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.mp import _drop_empty_max, resolve_order
from repro_torch.kernels import ops as kops

__all__ = ["ShardMesh", "make_shard_mesh", "check_mesh", "mp_sharded",
           "mp_transform_sharded", "segment_softmax_sharded"]

# bytes this process's merges moved through collectives (forward and
# backward), a plain counter like the kernels' launch counts
collective_bytes = 0


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """The 1-D mesh of one rank: its process group (``None``: the default
    group), its rank and the group's size, and its device."""
    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device


def make_shard_mesh(num_shards: int, *, group=None, device=None) -> ShardMesh:
    """This rank's :class:`ShardMesh` over ``group`` (the default group for
    ``None``), on ``device`` (``None``: the current card, raising without
    one; ``"cpu"`` for the plain versions). Raises unless
    ``torch.distributed`` is initialised and the group has ``num_shards``
    ranks (the reference raises when the mesh has too few devices)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"a {num_shards}-shard mesh needs torch.distributed initialised "
            "(init_process_group with one process a shard)")
    size = dist.get_world_size(group)
    if size != num_shards:
        raise ValueError(f"the mesh needs {num_shards} ranks, the process "
                         f"group has {size}")
    return ShardMesh(group=group, rank=dist.get_rank(group), size=size,
                     device=resolve_device(device, "make_shard_mesh"))


def check_mesh(mesh) -> ShardMesh:
    """``mesh`` itself if it is a :class:`ShardMesh`; any other mesh (the
    reference's JAX ``Mesh``, say) raises: the port shards only over
    ``torch.distributed`` ranks."""
    if not isinstance(mesh, ShardMesh):
        raise NotImplementedError(
            "the port shards over torch.distributed ranks: pass the "
            "ShardMesh of make_shard_mesh (ROADMAP Queue A item 6), got "
            f"{type(mesh).__name__}")
    return mesh


def _check(pg, mesh: Optional[ShardMesh], t) -> ShardMesh:
    mesh = (make_shard_mesh(pg.num_shards, device=t.device) if mesh is None
            else check_mesh(mesh))
    if mesh.size != pg.num_shards:
        raise ValueError(f"the mesh has {mesh.size} ranks but the partition "
                         f"has {pg.num_shards} shards")
    for what, where in (("partition", pg.device), ("mesh", mesh.device)):
        if where != t.device:
            raise ValueError(f"the {what} lies on {where}, the data on "
                             f"{t.device}")
    return mesh


def _all_reduce(t, group, op=dist.ReduceOp.SUM):
    global collective_bytes
    out = t.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    collective_bytes += out.numel() * out.element_size()
    return out


class _Entry(torch.autograd.Function):
    """A rank's block of a replicated tensor: ``full[rows]`` (rows where
    ``valid`` is False zeroed when ``zero_padding``). Backward: the
    cotangent scattered to the valid rows' global slots and all-reduced,
    so every rank holds the whole gradient."""

    @staticmethod
    def forward(ctx, full, rows, valid, zero_padding, group):
        ctx.save_for_backward(rows, valid)
        ctx.num_rows, ctx.group = int(full.shape[0]), group
        out = full.index_select(0, rows.long())
        if zero_padding:
            mask = valid.reshape(-1, *([1] * (full.dim() - 1)))
            out = torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                                     device=out.device))
        return out

    @staticmethod
    def backward(ctx, g):
        rows, valid = ctx.saved_tensors
        grad = torch.zeros((ctx.num_rows, *g.shape[1:]), dtype=g.dtype,
                           device=g.device)
        grad.index_copy_(0, rows[valid].long(), g[valid])
        return _all_reduce(grad, ctx.group), None, None, None, None


class _SumMerge(torch.autograd.Function):
    """All-reduce forward (``collective`` "psum" or "ring"); identity
    backward: the merged sum feeds computation every rank repeats."""

    @staticmethod
    def forward(ctx, part, group, collective):
        if collective == "ring":
            global collective_bytes
            from repro_torch.distributed.collectives import ring_allreduce
            kops.account("merge", "ring_allreduce")
            collective_bytes += part.numel() * part.element_size()
            return ring_allreduce(part.contiguous(), group).clone()
        kops.account("merge", "psum")
        return _all_reduce(part, group)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _MaxMerge(torch.autograd.Function):
    """All-gather, then the max over ranks. Backward: the cotangent to the
    ranks whose partial is the maximum, split evenly among tied ones."""

    @staticmethod
    def forward(ctx, part, group):
        global collective_bytes
        kops.account("merge", "pmax")
        part = part.contiguous()
        parts = [torch.empty_like(part)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, part, group=group)
        collective_bytes += len(parts) * part.numel() * part.element_size()
        y = torch.stack(parts).amax(0)
        ties = sum((p == y).float() for p in parts)
        ctx.save_for_backward((part == y).float() / ties.clamp_min(1.0))
        return y

    @staticmethod
    def backward(ctx, g):
        (share,) = ctx.saved_tensors
        return (g.float() * share).to(g.dtype), None


class _SumMergeLocal(torch.autograd.Function):
    """All-reduce forward and backward: the sum feeds rank-local
    computation (the softmax's global sum-exp), so each rank's cotangent
    of it is a part of the whole."""

    @staticmethod
    def forward(ctx, part, group):
        ctx.group = group
        return _all_reduce(part, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def _node_block(pg, x, mesh: ShardMesh):
    r = mesh.rank
    return _Entry.apply(x, pg.node_gather[r], pg.node_valid[r], False,
                        mesh.group)


def _edge_block(pg, vals, mesh: ShardMesh):
    """Per-edge values -> the rank's (E_pad, ...) block: global (E, ...)
    values through the entry, the rank's own block as it is. When E equals
    E_pad (one shard owns every edge) global wins; either reading gives
    the same values and gradients then, as padding rows get none."""
    r = mesh.rank
    if vals.shape[:1] == (pg.num_edges,):
        return _Entry.apply(vals, pg.edge_gather[r], pg.edge_valid[r], True,
                            mesh.group)
    if vals.shape[:1] == (pg.edges_per_shard,):
        return vals
    raise ValueError(
        f"per-edge values must be global ({pg.num_edges}, ...) or this "
        f"rank's block ({pg.edges_per_shard}, ...), got {tuple(vals.shape)}")


def mp_sharded(x, pg, *, reduce: str = "sum", edge_weight=None, pplan=None,
               mesh: Optional[ShardMesh] = None, impl: Optional[str] = None,
               config: Optional[KernelConfig] = None,
               collective: str = "psum"):
    """Sharded message passing: ``Y[d] = reduce_{(s,d) in E} (w_e ·) X[s]``
    over a :class:`~repro_torch.data.partition.PartitionedGraph`.

    ``x``: global (V, F) node features, replicated on every rank;
    ``edge_weight``: global (E,) or this rank's (E_pad,) block; ``pplan``:
    a :class:`~repro_torch.core.plan.PartitionedPlan` (built on demand when
    omitted); ``mesh``: this rank's :class:`ShardMesh` (the default group's
    on x's device when omitted). Returns the replicated global (V, F)
    aggregate, matching ``core.mp.mp`` (max fills empty neighbourhoods
    with 0)."""
    if reduce not in ("sum", "mean", "max"):
        raise ValueError(f"unknown reduce: {reduce!r}")
    if collective not in ("psum", "ring"):
        raise ValueError(f"unknown collective: {collective!r}")
    mesh = _check(pg, mesh, x)
    if pplan is None:
        pplan = pg.make_plan(feat=int(x.shape[-1]), config=config)
    r, v = mesh.rank, pg.num_nodes
    plan = pplan.local_plan(r)
    src, dst = pg.src_local[r], pg.dst_global[r]
    xb = _node_block(pg, x, mesh)
    # mean = the merged partial *sums*, then one divide by the global
    # in-degree (merged into pg.deg at partition time)
    kernel_reduce = "sum" if reduce == "mean" else reduce
    if edge_weight is None:
        part = geot.index_segment_reduce(xb, src, dst, v, kernel_reduce, impl,
                                         config, plan)
    else:
        wb = _edge_block(pg, edge_weight, mesh)
        part = geot.index_weight_segment_reduce(xb, src, wb, dst, v,
                                                kernel_reduce, impl, config,
                                                plan)
    if reduce == "max":
        return _drop_empty_max(_MaxMerge.apply(part, mesh.group))
    s = _SumMerge.apply(part, mesh.group, collective)
    if reduce == "mean":
        s = s / pg.deg.clamp_min(1.0)[:, None].to(s.dtype)
    return s


def mp_transform_sharded(x, w, pg, *, reduce: str = "sum", edge_weight=None,
                         pplan=None, mesh: Optional[ShardMesh] = None,
                         impl: Optional[str] = None,
                         config: Optional[KernelConfig] = None,
                         collective: str = "psum", order: str = "auto"):
    """Sharded ``mp_transform``: aggregate(X·W) or aggregate(X)·W with the
    single-device path's cost-model order, the dense product on the
    replicated side, the aggregation on the shards. The fused one-launch
    arm is never taken (``allow_fused=False``): the merge must run between
    the aggregate and the transform, so each rank's (V, d_in) partial has
    to exist. Non-linear reduces (``max``) pin transform-first."""
    order = resolve_order(reduce, order, int(x.shape[-1]), int(w.shape[-1]),
                          plan=pplan, num_edges=pg.num_edges,
                          num_nodes=pg.num_nodes, config=config,
                          allow_fused=False, dtype=x.dtype)
    kw = dict(reduce=reduce, edge_weight=edge_weight, pplan=pplan, mesh=mesh,
              impl=impl, config=config, collective=collective)
    if order == "aggregate_first":
        return mp_sharded(x, pg, **kw) @ w
    return mp_sharded(x @ w, pg, **kw)


def segment_softmax_sharded(e, pg, *, pplan=None,
                            mesh: Optional[ShardMesh] = None,
                            impl: Optional[str] = None,
                            config: Optional[KernelConfig] = None):
    """Sharded segment softmax over destinations (GAT attention).

    ``e``: global (E,) or (E, H) logits, or this rank's block. Each rank
    runs the softmax kernel over its own edges, then corrects it by the
    two-stage online-softmax merge:

        m_glob = max over ranks of segment_max(e)       (no gradient)
        z_loc  = segment_sum(exp(e - m_glob))           (at the global max)
        p      = p_loc · z_loc / all_reduce(z_loc)

    both statistics on the segment_reduce kernel over the rank's plan.
    Segments wholly on one rank rescale by 1. Returns this rank's
    (E_pad[, H]) block of attention weights, exactly 0 on padding: feed it
    to :func:`mp_sharded` as ``edge_weight``."""
    mesh = _check(pg, mesh, e)
    if pplan is None:
        pplan = pg.make_plan(feat=int(e.shape[-1]) if e.dim() > 1 else 1,
                             config=config)
    r, v = mesh.rank, pg.num_nodes
    plan = pplan.local_plan(r)
    dst = pg.dst_global[r]
    el = _edge_block(pg, e, mesh)
    p_loc = geot.segment_softmax(el.contiguous(), dst, v, impl, config, plan)
    # the merge's statistics: the collective halo algebra, accounted apart
    # from the aggregation (the p_loc launch above), as the reference does
    kops.account("merge", "segment_softmax_stats")
    squeeze = el.dim() == 1
    # neither a padding slot nor an edge a padded graph drops (dst = V)
    mask = (dst < v)[:, None]
    e2 = torch.where(mask, el[:, None] if squeeze else el,
                     torch.zeros((), dtype=el.dtype, device=el.device))
    m_loc = kops.segment_reduce(e2.detach().float().contiguous(), dst, v,
                                "max", plan=plan, impl=impl)
    m_glob = _all_reduce(m_loc, mesh.group, dist.ReduceOp.MAX)
    m_safe = torch.where(torch.isfinite(m_glob), m_glob,
                         torch.zeros_like(m_glob))
    ex = torch.where(mask,
                     torch.exp(e2.float() - geot._take0(m_safe, dst, v)),
                     torch.zeros((), device=e2.device))
    z_loc = geot.segment_reduce(ex.contiguous(), dst, v, "sum", impl, config,
                                plan)
    z_glob = _SumMergeLocal.apply(z_loc, mesh.group)
    # z_loc is the rank's sum-exp at the *global* max, so the exp(m_loc -
    # m_glob) of the textbook merge is inside it; a segment with no local
    # edge has z_loc = 0 and feeds no local row
    factor = z_loc / z_glob.clamp_min(1e-20)
    p2 = p_loc[:, None] if squeeze else p_loc
    p2 = torch.where(mask, p2.float() * geot._take0(factor, dst, v),
                     torch.zeros((), device=p2.device)).to(p_loc.dtype)
    return p2[:, 0] if squeeze else p2

"""Mixture-of-Experts layer on the GeoT segment ops, ported from
``repro.models.moe``.

Routing tokens to experts is a sorted segment-reduction problem:

  dispatch — assignments sorted by expert id (the sortedness contract of
             paper §II-B), positions within an expert from the segment
             offsets; the token rows gathered with ``gather``, whose
             backward is a sorted segment reduction (the gather kernel on
             CUDA tensors, bitwise repeatable);
  experts  — a grouped GEMM over the expert segments (``segment_matmul``:
             the Hopper kernel under ``impl="cuda"``) on the dropless path,
             or a dense (E, C, D) batched matmul on the capacity path;
  combine  — ``index_weight_segment_reduce`` keyed by token id (already
             sorted) with the router probabilities as weights: the paper's
             fused SpMM op (§IV), the gather kernel on CUDA tensors.

``moe(impl=)``: ``"capacity"`` (static-shape GShard-style buffers, the
default), ``"ragged"`` (dropless, every op on its plain version, as the
reference's ``"ragged"`` runs ``impl="ref"``) or ``"cuda"`` (dropless, the
three expert products on the segment_matmul kernel and the combine on the
gather kernel: the counterpart of the reference's ``"pallas"``; raises on
CPU tensors).

Under a sharding context (:mod:`repro_torch.distributed.sharding`)
``"capacity"`` takes :func:`moe_shard_map`, the reference's expert-parallel
MoE: each rank dispatches its data shard's tokens to its own experts and
combines them on the gather kernel, and one all-reduce over "model" sums
the experts' parts. ``"ragged"`` and ``"cuda"`` take
:func:`moe_ragged_shard_map`, its dropless counterpart: each rank runs its
own experts' assignments through segment_matmul. Both run the global layer
whole on every rank where the experts or the tokens do not divide the
mesh.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import ops as geot
from repro_torch.distributed import sharding as shd
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import P, Params, dense_init, normal

IMPLS = ("capacity", "ragged", "cuda")


def moe_init(gen, cfg: ModelConfig, dtype, device) -> Params:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    std = 1.0 / math.sqrt(d)
    prm = {
        "router": dense_init(gen, d, e, ("embed", "expert"), torch.float32,
                             device),
        "w_up": P(normal(gen, (e, d, f), dtype, device, std),
                  ("expert", "embed", "mlp")),
        "w_gate": P(normal(gen, (e, d, f), dtype, device, std),
                    ("expert", "embed", "mlp")),
        "w_down": P(normal(gen, (e, f, d), dtype, device, std / 4),
                    ("expert", "mlp", "embed")),
    }
    if cfg.num_shared_experts:
        prm["shared"] = layers.mlp_init(
            gen, cfg, dtype, device,
            d_ff=cfg.moe_d_ff * cfg.num_shared_experts)
    return Params(**prm)


def _route(prm, x2d, cfg: ModelConfig):
    """Router: top-k expert ids (int32), their combine weights (in x's
    dtype) and the Switch-style load-balancing loss."""
    probs = torch.softmax(x2d.float() @ prm.router, dim=-1)
    # lax.top_k puts the lower expert id first among exactly equal
    # probabilities; torch.topk leaves the order of ties unspecified. Only
    # an exact tie can differ: across the k-th place it can pick another
    # expert, within the top k it can reorder them (the combine sums them,
    # so only the aux loss's first choice could move).
    top_p, top_e = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    if cfg.norm_topk:
        top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    e = cfg.num_experts
    frac_tokens = F.one_hot(top_e[..., 0], e).float().mean(0)
    frac_probs = probs.mean(0)
    aux = e * torch.sum(frac_tokens * frac_probs)
    return top_e.to(torch.int32), top_p.to(x2d.dtype), aux


def _experts_dense(prm, xd, cfg: ModelConfig):
    """(E, C, D) → (E, C, D): each expert's gated MLP on its slots."""
    act = layers._ACTS[cfg.act]
    hu = torch.bmm(xd, prm.w_up)
    hg = torch.bmm(xd, prm.w_gate)
    return torch.bmm(act(hg) * hu, prm.w_down)


def _assignments(top_e, top_p, t: int, k: int):
    """Flat (T·k,) expert ids, weights and token ids (token-sorted)."""
    tok = torch.arange(t, dtype=torch.int32, device=top_e.device)
    return (top_e.reshape(-1), top_p.reshape(-1),
            tok.repeat_interleave(k))


def _inverse(order):
    """inv with inv[order[i]] = i."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], dtype=order.dtype,
                              device=order.device)
    return inv


def _positions(e_flat, e: int):
    """Each assignment's position within its expert, in assignment order:
    the assignments sorted by expert (the GeoT sortedness contract), less
    the segment offsets of their experts."""
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    starts = torch.searchsorted(
        e_sorted, torch.arange(e, dtype=torch.int32, device=e_flat.device))
    pos_sorted = torch.arange(e_flat.shape[0], device=e_flat.device) - \
        starts[e_sorted.long()]
    return pos_sorted[_inverse(order)]


def moe_capacity(prm, x, cfg: ModelConfig, capacity: Optional[int] = None):
    """Static-shape MoE. x: (B, S, D) → ((B, S, D), aux loss). An expert
    takes at most ``capacity`` assignments (rounded up to 32), in token
    order; the rest are dropped. The combine runs on the gather kernel for
    CUDA tensors, on its plain version for CPU tensors."""
    b, s, d = x.shape
    t = b * s
    x2d = x.reshape(t, d)
    top_e, top_p, aux = _route(prm, x2d, cfg)
    k, e = cfg.top_k, cfg.num_experts
    if capacity is None:
        capacity = max(1, int(t * k * cfg.capacity_factor / e))
        capacity = min(capacity, t)
    capacity = -(-capacity // 32) * 32
    e_flat, w_flat, tok_flat = _assignments(top_e, top_p, t, k)

    # dispatch: an assignment's position within its expert
    pos = _positions(e_flat, e)
    keep = pos < capacity
    slot = torch.where(keep, e_flat.long() * capacity + pos, e * capacity)
    # the (T·k, D) gathered rows are batch-aligned (tok_flat is sorted):
    # pinned to the data axes, as the reference pins them
    msg = shd.ashard(geot.gather(x2d, tok_flat), "batch", None)
    # the reference's scatter drops slot e·capacity: here it lands in one
    # extra row that is sliced off
    xd = torch.zeros((e * capacity + 1, d), dtype=x.dtype, device=x.device)
    xd[slot] = msg
    # EP: experts on "model", capacity slots on the data axes
    xd3 = shd.ashard(xd[:-1].reshape(e, capacity, d), "expert", "capacity",
                     None)
    yd = _experts_dense(prm, xd3, cfg)
    yd = shd.ashard(yd, "expert", "capacity", None).reshape(e * capacity, d)

    # combine: gather rows by slot, weight by router prob, reduce over the
    # (sorted) token ids; a dropped assignment reads a real row with weight 0
    slot_safe = torch.clamp_max(slot, e * capacity - 1)
    out2d = geot.index_weight_segment_reduce(
        yd, slot_safe, torch.where(keep, w_flat, torch.zeros_like(w_flat)),
        tok_flat, t)
    if cfg.num_shared_experts:
        out2d = out2d + layers.mlp(prm.shared, x2d, cfg)
    return out2d.reshape(b, s, d).to(x.dtype), aux


def moe_ragged(prm, x, cfg: ModelConfig, impl: str = "ref"):
    """Dropless MoE by sort + grouped GEMM. ``impl``: ``"ref"`` (every op
    on its plain version) or ``"cuda"`` (segment_matmul's kernel for the
    three expert products, the gather kernel for the combine)."""
    if impl not in ("ref", "cuda"):
        raise ValueError(f"moe_ragged: impl must be 'ref' or 'cuda', got "
                         f"{impl!r}")
    b, s, d = x.shape
    t = b * s
    x2d = x.reshape(t, d)
    top_e, top_p, aux = _route(prm, x2d, cfg)
    e_flat, w_flat, tok_flat = _assignments(top_e, top_p, t, cfg.top_k)

    order = torch.argsort(e_flat, stable=True)
    tok_sorted = tok_flat[order]
    group_sizes = torch.bincount(e_flat, minlength=cfg.num_experts).to(
        torch.int32)

    xs = geot.gather(x2d, tok_sorted, impl=impl)
    act = layers._ACTS[cfg.act]
    hu = geot.segment_matmul(xs, group_sizes, prm.w_up, impl=impl)
    hg = geot.segment_matmul(xs, group_sizes, prm.w_gate, impl=impl)
    ys = geot.segment_matmul(act(hg) * hu, group_sizes, prm.w_down,
                             impl=impl)

    # combine in the original (token-sorted) assignment order: the fused
    # SpMM (§IV); on "cuda" the op picks the gather kernel for CUDA tensors
    out2d = geot.index_weight_segment_reduce(
        ys, _inverse(order), w_flat, tok_flat, t,
        impl=None if impl == "cuda" else impl)
    if cfg.num_shared_experts:
        out2d = out2d + layers.mlp(prm.shared, x2d, cfg)
    return out2d.reshape(b, s, d).to(x.dtype), aux


def _dispatch_local(x_loc, te_loc, tp_loc, wu, wg, wd, *, cfg: ModelConfig,
                    e_m: int, cap: int, m_rank: int):
    """One rank's part of :func:`moe_shard_map`: the GeoT dispatch of its
    data shard's assignments that target its ``e_m`` experts (sorted by
    expert, ``cap`` slots each), the dense expert products, and the
    combine on ``index_weight_segment_reduce`` (the gather kernel on CUDA
    tensors). Returns this rank's partial (T_loc, D) output."""
    t_loc, d = x_loc.shape
    e_flat, w_flat, tok_flat = _assignments(te_loc, tp_loc, t_loc, cfg.top_k)
    pos = _positions(e_flat, cfg.num_experts)
    mine = torch.div(e_flat, e_m, rounding_mode="floor") == m_rank
    keep = (pos < cap) & mine
    slot = torch.where(keep, (e_flat.long() - m_rank * e_m) * cap + pos,
                       e_m * cap)
    xd = torch.zeros((e_m * cap + 1, d), dtype=x_loc.dtype,
                     device=x_loc.device)
    xd[slot] = geot.gather(x_loc, tok_flat)
    xd3 = xd[:-1].reshape(e_m, cap, d)
    act = layers._ACTS[cfg.act]
    yd = torch.bmm(act(torch.bmm(xd3, wg)) * torch.bmm(xd3, wu), wd)
    slot_safe = torch.clamp_max(slot, e_m * cap - 1)
    out = geot.index_weight_segment_reduce(
        yd.reshape(e_m * cap, d), slot_safe,
        torch.where(keep, w_flat, torch.zeros_like(w_flat)), tok_flat, t_loc)
    return out.to(x_loc.dtype)


def _route_local(x_loc, router, *, cfg: ModelConfig):
    """:func:`_route` on one data shard: the top-k ids and weights of its
    tokens, and the aux loss's per-expert sums over them (the first
    choices' counts and the router probabilities), to be summed over the
    data shards."""
    probs = torch.softmax(x_loc.float() @ router, dim=-1)
    top_p, top_e = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    if cfg.norm_topk:
        top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    counts = F.one_hot(top_e[..., 0], cfg.num_experts).float().sum(0)
    return (top_e.to(torch.int32), top_p.to(x_loc.dtype), counts,
            probs.sum(0))


def _replicated_moe(prm, x, cfg: ModelConfig, mesh, fn):
    """``fn(prm, x, cfg)`` (:func:`moe_capacity` or :func:`moe_ragged`)
    whole on every rank (x and every weight replicated, so each rank
    computes the same output and gradients)."""
    import types
    from torch.distributed.tensor import Replicate
    rep = [Replicate()] * mesh.ndim
    names = [k for k, _ in prm.named_parameters()]

    def body(x_l, *ws):
        tree: dict = {}
        for name, w in zip(names, ws):
            *path, leaf = name.split(".")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = w

        def ns(node):
            return types.SimpleNamespace(**{
                k: ns(v) if isinstance(v, dict) else v
                for k, v in node.items()})
        return fn(ns(tree), x_l, cfg)

    return layers._local_map(body, (rep, rep), (rep,) * (1 + len(names)),
                             mesh)(x, *(p for _, p in prm.named_parameters()))


def _expert_parallel(prm, x, cfg: ModelConfig, make_body, whole):
    """The expert-parallel frame of :func:`moe_shard_map` and
    :func:`moe_ragged_shard_map` on the DTensors of a sharding context.
    Routing runs on each data shard (the aux loss from the global counts
    and probability sums); ``make_body(e_m, m_rank, t_loc)`` gives the
    rank's part: ``(x_loc, top_e, top_p, w_up, w_gate, w_down) -> (T_loc,
    D)``, the weights this rank's ``e_m`` experts with the hidden dim
    gathered; one all-reduce over "model", in x's dtype, sums the parts.
    Where E does not divide "model", or the tokens the data axes, it runs
    ``whole`` on every rank, replicated (the reference's fallback)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh, plan = shd.current_context()
    sizes = shd.mesh_sizes(mesh)
    names = list(mesh.mesh_dim_names)
    m_ax = plan.model_axes[0]
    msize = sizes[m_ax]
    dsize = math.prod(sizes[a] for a in plan.batch_axes)
    e = cfg.num_experts
    b, s, d = x.shape
    t = b * s
    rep = [Replicate()] * mesh.ndim
    if e % msize != 0 or (b % dsize != 0 and t % dsize != 0):
        return _replicated_moe(prm, x, cfg, mesh, whole)   # unshardable
    x2d = x.reshape(t, d)
    dpl = list(rep)                       # (T, ·): tokens on the data axes
    for a in plan.batch_axes:
        dpl[names.index(a)] = Shard(0)
    # routing on each data shard, replicated over "model"; the router's
    # gradient is a sum over the data shards
    gpl = [Partial() if p.is_shard() else p for p in dpl]
    top_e, top_p, counts, psum = layers._local_map(
        functools.partial(_route_local, cfg=cfg),
        (dpl, dpl, gpl, gpl), (dpl, rep), mesh,
        in_grad_pls=(dpl, gpl))(x2d, prm.router)
    aux = e * torch.sum((counts / t) * (psum / t))

    # the experts: this rank's E/|model| of them, the hidden dim gathered
    wpl = list(rep)
    wpl[names.index(m_ax)] = Shard(0)
    wgpl = [Partial() if p.is_replicate() and names[i] in plan.batch_axes
            else p for i, p in enumerate(wpl)]
    # x and the router weights are replicated over "model"; each rank's
    # experts give them their own partial gradient
    xgpl = list(dpl)
    xgpl[names.index(m_ax)] = Partial()
    opl = list(xgpl)                      # the parts, summed over "model"
    body = make_body(e // msize, mesh.get_local_rank(m_ax), t // dsize)
    part = layers._local_map(
        body, opl, (dpl, dpl, dpl, wpl, wpl, wpl), mesh,
        in_grad_pls=(xgpl, dpl, xgpl, wgpl, wgpl, wgpl))(
            x2d, top_e, top_p, prm.w_up, prm.w_gate, prm.w_down)
    if b % dsize == 0:
        # the parts summed at (B, S, D): a gradient that comes back sharded
        # on the sequence is then gathered, where at (T, D) it would be a
        # strided shard of the tokens, whose conversion reads index tensors
        # on the host (no fake trace can)
        out = part.reshape(b, s, d).redistribute(mesh, dpl)
        if cfg.num_shared_experts:
            out = out + layers.mlp(prm.shared, x, cfg)
        return out, aux
    out2d = part.redistribute(mesh, dpl)
    if cfg.num_shared_experts:
        out2d = out2d + layers.mlp(prm.shared, x2d, cfg)
    return out2d.redistribute(mesh, rep).reshape(b, s, d), aux


def moe_shard_map(prm, x, cfg: ModelConfig):
    """Expert-parallel MoE (the reference's ``moe_shard_map``), on the
    DTensors of a sharding context. The input is replicated over the model
    dim (it feeds TP attention), so dispatch is local: each rank routes
    its data shard's T_loc tokens, keeps the assignments that target its
    E/|model| experts (at most ``cap`` = T_loc·k·capacity_factor/E,
    rounded up to 8, each: capacity from the *local* token count), runs
    them with the experts' hidden dim all-gathered (FSDP), combines on the
    gather kernel, and one all-reduce over "model", in x's dtype, sums the
    parts. Where E or the tokens do not divide the mesh it runs the global
    :func:`moe_capacity` on every rank, replicated (the reference's
    fallback)."""
    def make_body(e_m, m_rank, t_loc):
        cap = max(1, int(t_loc * cfg.top_k * cfg.capacity_factor
                         / cfg.num_experts))
        return functools.partial(_dispatch_local, cfg=cfg, e_m=e_m,
                                 cap=-(-cap // 8) * 8, m_rank=m_rank)
    return _expert_parallel(prm, x, cfg, make_body, moe_capacity)


def _own_first(e_flat, e_m: int, m_rank: int):
    """(mine, order, group_sizes): which assignments target the ``e_m``
    experts of model rank ``m_rank``, the stable order that puts them
    first in expert order (the rest after them, in their own order), and
    those experts' (e_m,) group sizes."""
    local = e_flat - m_rank * e_m
    mine = (local >= 0) & (local < e_m)
    key = torch.where(mine, local, torch.full_like(local, e_m))
    order = torch.argsort(key, stable=True)
    group_sizes = torch.bincount(key, minlength=e_m + 1)[:e_m].to(
        torch.int32)
    return mine, order, group_sizes


def _ragged_local(x_loc, te_loc, tp_loc, wu, wg, wd, *, cfg: ModelConfig,
                  e_m: int, m_rank: int, impl: str):
    """One rank's part of :func:`moe_ragged_shard_map`: its data shard's
    T_loc·k assignments sorted so that those of its ``e_m`` experts come
    first, in expert order (the rest after them, in token order);
    segment_matmul over its own experts' group sizes, so the rows past
    them come out 0; the combine on ``index_weight_segment_reduce`` with
    the other ranks' weights 0. Every shape is static (the rows are all
    T_loc·k assignments whichever rank owns them), so the forward reads
    nothing back to the host. Its price is the rows past the groups: at
    |model| = m about (m − 1)/m of them, run through the gather, the
    activation and the products as zeros and kept for the backward. On
    the H100 (``chip_smoke.py`` 3j (f)) that costs less than reading the
    live count at m = 2, whose sync drains the launch queue, and about as
    much at m = 16, where the rows kept are 16× the live ones."""
    t_loc = x_loc.shape[0]
    e_flat, w_flat, tok_flat = _assignments(te_loc, tp_loc, t_loc,
                                            cfg.top_k)
    mine, order, group_sizes = _own_first(e_flat, e_m, m_rank)
    xs = geot.gather(x_loc, tok_flat[order], impl=impl)
    act = layers._ACTS[cfg.act]
    hu = geot.segment_matmul(xs, group_sizes, wu, impl=impl)
    hg = geot.segment_matmul(xs, group_sizes, wg, impl=impl)
    ys = geot.segment_matmul(act(hg) * hu, group_sizes, wd, impl=impl)
    out = geot.index_weight_segment_reduce(
        ys, _inverse(order), torch.where(mine, w_flat,
                                         torch.zeros_like(w_flat)),
        tok_flat, t_loc, impl=None if impl == "cuda" else impl)
    return out.to(x_loc.dtype)


def moe_ragged_shard_map(prm, x, cfg: ModelConfig, impl: str = "ref"):
    """Dropless expert-parallel MoE, the counterpart of
    :func:`moe_shard_map` without capacity, on the DTensors of a sharding
    context. Each rank routes its data shard, runs every assignment of its
    E/|model| experts through segment_matmul (:func:`_ragged_local`) and
    combines on ``index_weight_segment_reduce``; one all-reduce over
    "model" sums the parts. No assignment drops, so each token's output is
    the reference's GSPMD :func:`moe_ragged` up to summation order.
    ``impl``: ``"ref"`` (the plain versions) or ``"cuda"`` (the kernels;
    raises on CPU tensors). Where E or the tokens do not divide the mesh,
    :func:`moe_ragged` runs whole on every rank."""
    if impl not in ("ref", "cuda"):
        raise ValueError(f"moe_ragged_shard_map: impl must be 'ref' or "
                         f"'cuda', got {impl!r}")

    def make_body(e_m, m_rank, t_loc):
        return functools.partial(_ragged_local, cfg=cfg, e_m=e_m,
                                 m_rank=m_rank, impl=impl)
    return _expert_parallel(prm, x, cfg, make_body, functools.partial(
        moe_ragged, impl=impl))


def moe(prm, x, cfg: ModelConfig, impl: str = "capacity"):
    if impl not in IMPLS:
        raise ValueError(f"unknown moe impl {impl!r}; one of {IMPLS}")
    sharded = shd.sharding_active() and shd.is_dtensor(x)
    if impl == "capacity":
        return moe_shard_map(prm, x, cfg) if sharded else \
            moe_capacity(prm, x, cfg)
    dropless = "ref" if impl == "ragged" else "cuda"
    if sharded:
        return moe_ragged_shard_map(prm, x, cfg, impl=dropless)
    return moe_ragged(prm, x, cfg, impl=dropless)

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
CPU tensors). The reference's expert-parallel ``moe_shard_map`` comes with
the sharding slice.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import ops as geot
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import Params, dense_init, normal

IMPLS = ("capacity", "ragged", "cuda")


def moe_init(gen, cfg: ModelConfig, dtype, device) -> Params:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    std = 1.0 / math.sqrt(d)
    prm = {
        "router": dense_init(gen, d, e, torch.float32, device),
        "w_up": normal(gen, (e, d, f), dtype, device, std),
        "w_gate": normal(gen, (e, d, f), dtype, device, std),
        "w_down": normal(gen, (e, f, d), dtype, device, std / 4),
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
    a = t * k
    e_flat, w_flat, tok_flat = _assignments(top_e, top_p, t, k)

    # dispatch: sort the assignments by expert (the GeoT sortedness
    # contract); an assignment's position within its expert
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    starts = torch.searchsorted(
        e_sorted, torch.arange(e, dtype=torch.int32, device=x.device))
    pos_sorted = torch.arange(a, device=x.device) - starts[e_sorted.long()]
    pos = pos_sorted[_inverse(order)]
    keep = pos < capacity
    slot = torch.where(keep, e_flat.long() * capacity + pos, e * capacity)
    # the reference's scatter drops slot e·capacity: here it lands in one
    # extra row that is sliced off
    xd = torch.zeros((e * capacity + 1, d), dtype=x.dtype, device=x.device)
    xd[slot] = geot.gather(x2d, tok_flat)
    yd = _experts_dense(prm, xd[:-1].reshape(e, capacity, d), cfg)
    yd = yd.reshape(e * capacity, d)

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


def moe(prm, x, cfg: ModelConfig, impl: str = "capacity"):
    if impl == "capacity":
        return moe_capacity(prm, x, cfg)
    if impl in ("ragged", "cuda"):
        return moe_ragged(prm, x, cfg, impl="ref" if impl == "ragged"
                          else "cuda")
    raise ValueError(f"unknown moe impl {impl!r}; one of {IMPLS}")

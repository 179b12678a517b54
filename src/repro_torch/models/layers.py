"""The LM's building blocks, ported from ``repro.models.layers``: norms,
RoPE, the embedding, attention (online softmax over KV blocks for whole
sequences, and single-token decode against a KV cache) and the MLP.

Each function reads a :class:`~repro_torch.models.params.Params` holding
the reference's parameter dict under the same keys. The arithmetic follows
the reference step by step, in the same dtypes: norm statistics in fp32
with the elementwise math in the input dtype, attention scores and
softmax in fp32. Attention has no Pallas kernel in the reference (plain
``jnp``), so it is plain PyTorch here, mirroring the reference's blocked
online softmax rather than calling a fused library kernel.

Sharding (:mod:`repro_torch.distributed.sharding`): inside an
``activation_sharding`` context the parameters and activations are
DTensors. The reference's ``ashard`` pins are kept (the identity outside a
context), and the regions DTensor cannot propagate through run on each
rank's local tensors under ``local_map``: attention per (batch shard, head
shard), decode attention against each rank's shard of the KV cache (a
sequence-sharded cache merges its max and sum-exp over the mesh), the
embedding lookup per vocabulary shard, and :func:`tp_out_project`, the
reference's hand-scheduled tensor-parallel projection.

The embedding's backward is the paper's sorted segment reduction, as the
reference's custom VJP: the cotangent rows sorted by token id and summed in
fp32 with :func:`repro_torch.core.ops.segment_reduce` (the segment_reduce
kernel on CUDA tensors). Under sharding it is the reference's unsorted
fp32 scatter-add of each data shard's rows, a partial table summed across
the data ranks into the table's own placements.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import ops as geot
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import (Params, dense_init, embed_init,
                                       ones_init, zeros_init)

NEG = -1e30          # the reference's mask value


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_init(cfg: ModelConfig, device, dim: Optional[int] = None) -> Params:
    dim = dim or cfg.d_model
    prm = {"scale": ones_init((dim,), ("embed",), torch.float32, device)}
    if cfg.norm == "layernorm":
        prm["bias"] = zeros_init((dim,), ("embed",), torch.float32, device)
    return Params(**prm)


def apply_norm(prm, x, cfg: ModelConfig, eps: float = 1e-5):
    """Statistics in fp32, elementwise math in the input dtype (the
    reference's E[x²] − E[x]² form for LayerNorm)."""
    dt = x.dtype
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        ms = xf.square().mean(-1, keepdim=True)
        var = torch.clamp_min(ms - mu.square(), 0.0)
        inv = torch.rsqrt(var + eps)
        return (x - mu.to(dt)) * inv.to(dt) * prm.scale.to(dt) \
            + prm.bias.to(dt)
    inv = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return x * inv.to(dt) * prm.scale.to(dt)


def simple_rms(x, scale, eps: float = 1e-6):
    xf = x.float()
    out = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (out * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (with partial-rotary support, e.g. StableLM's 25%)
# ---------------------------------------------------------------------------

def rope(x, positions, theta: float, partial: float = 1.0):
    """x: (..., S, H, D); positions: (..., S). cos and sin are cast to
    x's dtype before the rotation, as in the reference."""
    d = x.shape[-1]
    rot = int(d * partial) // 2 * 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    freqs = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                          device=x.device) / rot))
    ang = positions[..., None].float() * freqs            # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return torch.cat([out, xp], -1)


# ---------------------------------------------------------------------------
# embedding
# ---------------------------------------------------------------------------

def embedding_init(gen, cfg: ModelConfig, dtype, device) -> Params:
    return Params(table=embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                   dtype, device))


def _dims_sharding(pls, dim: int) -> list:
    """The mesh dims whose placement in ``pls`` shards tensor dim ``dim``."""
    return [i for i, p in enumerate(pls)
            if p.is_shard() and p.dim == dim]


class _EmbedLookup(torch.autograd.Function):
    """``table[ids]`` whose backward is a sorted segment reduction (the
    reference's ``_embed_lookup``): the flat ids argsorted (stable), the
    cotangent rows gathered in that order, summed in fp32 into one segment
    a vocabulary row, cast to the table's dtype.

    Sharded (a DTensor table, inside a context): each rank looks its ids up
    in its vocabulary shard of the table (the hidden dim gathered), rows
    outside the shard 0, a partial sum over the vocabulary's mesh dims.
    The backward is the reference's sharded branch: an unsorted fp32
    scatter-add of this rank's cotangent rows into a whole table, partial
    over the mesh dims the ids are sharded on, redistributed to the
    table's own placements, then cast."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.scopes = kops.fusion_scopes()
        ctx.vocab = int(table.shape[0])
        ctx.save_for_backward(ids)
        if shd.is_dtensor(table):
            return _embed_sharded_fwd(ctx, table, ids)
        return F.embedding(ids.long(), table)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        (ids,) = ctx.saved_tensors
        if shd.is_dtensor(g):
            return _embed_sharded_bwd(ctx, g, ids), None
        flat_ids = ids.reshape(-1)
        flat_g = g.reshape(-1, g.shape[-1])
        order = torch.argsort(flat_ids, stable=True)
        # recorded where the forward ran (the card's backward thread holds
        # no fusion scope of its own)
        with kops.in_fusion_scopes(ctx.scopes):
            dtab = geot.segment_reduce(
                flat_g.index_select(0, order).float(),
                flat_ids.index_select(0, order).to(torch.int32), ctx.vocab)
        return dtab.to(g.dtype), None


def _as_dtensor(x, mesh):
    """``x`` as a DTensor on ``mesh`` (a plain tensor: replicated)."""
    if shd.is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _embed_sharded_fwd(ctx, table, ids):
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    ids = _as_dtensor(ids, mesh)
    tpl = list(table.placements)
    # gather the hidden dim (FSDP); keep the vocabulary shards
    tab = table.redistribute(mesh, [p if p.is_shard(0) else Replicate()
                                    for p in tpl]).to_local()
    vocab_dims = _dims_sharding(tpl, 0)
    lo = 0
    for i in vocab_dims:
        lo = lo * mesh.size(i) + mesh.get_local_rank(i)
    lo *= tab.shape[0]
    local_ids = ids.to_local().long() - lo
    inside = (local_ids >= 0) & (local_ids < tab.shape[0])
    out = F.embedding(torch.where(inside, local_ids, 0), tab)
    out = out * inside[..., None].to(out.dtype)
    ipl = list(ids.placements)
    ctx.mesh, ctx.table_pls, ctx.ids_pls = mesh, tpl, ipl
    pls = [Shard(p.dim) if p.is_shard() else
           (Partial() if i in vocab_dims else Replicate())
           for i, p in enumerate(ipl)]
    shape = tuple(ids.shape) + (table.shape[1],)
    return DTensor.from_local(out, mesh, pls, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def _embed_sharded_bwd(ctx, g, ids):
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = ctx.mesh
    g = g.redistribute(mesh, [p if p.is_shard() else Replicate()
                              for p in ctx.ids_pls]).to_local()
    ids = _as_dtensor(ids, mesh).to_local()
    dtab = torch.zeros((ctx.vocab, g.shape[-1]), dtype=torch.float32,
                       device=g.device)
    dtab.index_add_(0, ids.reshape(-1).long(),
                    g.reshape(-1, g.shape[-1]).float())
    part = DTensor.from_local(
        dtab, mesh, [Partial() if p.is_shard() else Replicate()
                     for p in ctx.ids_pls], run_check=False)
    return part.redistribute(mesh, ctx.table_pls).to(g.dtype)


def embed(prm, ids):
    return _EmbedLookup.apply(prm.table, ids)


def unembed(prm, x, cfg: ModelConfig):
    """Tied head: x @ tableᵀ scaled in the io dtype, then fp32."""
    return ((x @ prm.table.T) * cfg.logit_scale).float()


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor          # (B, S_max, KH, D)
    v: torch.Tensor
    length: int              # tokens already cached (the shared counter)


def attention_init(gen, cfg: ModelConfig, dtype, device) -> Params:
    d = cfg.d_model
    prm = {
        "wq": dense_init(gen, d, cfg.q_dim, ("embed", "heads"), dtype, device),
        "wk": dense_init(gen, d, cfg.kv_dim, ("embed", "kv"), dtype, device),
        "wv": dense_init(gen, d, cfg.kv_dim, ("embed", "kv"), dtype, device),
        "wo": dense_init(gen, cfg.q_dim, d, ("heads", "embed"), dtype, device),
    }
    if cfg.use_bias:
        prm["bq"] = zeros_init((cfg.q_dim,), ("heads",), dtype, device)
        prm["bk"] = zeros_init((cfg.kv_dim,), ("kv",), dtype, device)
        prm["bv"] = zeros_init((cfg.kv_dim,), ("kv",), dtype, device)
        prm["bo"] = zeros_init((d,), ("embed",), dtype, device)
    if cfg.qk_norm:
        prm["q_norm"] = ones_init((cfg.head_dim,), (None,), torch.float32,
                                  device)
        prm["k_norm"] = ones_init((cfg.head_dim,), (None,), torch.float32,
                                  device)
    return Params(**prm)


def _split_heads(t, b: int, s: int, heads: int, head_dim: int):
    """(B, S, heads·head_dim) → (B, S, heads, head_dim). A DTensor whose
    last dim is sharded over more ranks than divide the heads (2 KV heads
    on a 4-way model dim) is first gathered on it, as GSPMD reshards for
    the reference."""
    if shd.is_dtensor(t):
        from torch.distributed.tensor import Replicate
        last = t.dim() - 1
        pls = list(t.placements)
        ways = math.prod(t.device_mesh.size(i) for i, p in enumerate(pls)
                         if p.is_shard(last))
        if heads % ways:
            t = t.redistribute(t.device_mesh, [
                Replicate() if p.is_shard(last) else p for p in pls])
    return t.reshape(b, s, heads, head_dim)


def _project_qkv(prm, x, cfg: ModelConfig, positions,
                 apply_rope: bool = True):
    b, s, _ = x.shape
    q, k, v = x @ prm.wq, x @ prm.wk, x @ prm.wv
    if cfg.use_bias:
        q, k, v = q + prm.bq, k + prm.bk, v + prm.bv
    q = _split_heads(q, b, s, cfg.num_heads, cfg.head_dim)
    k = _split_heads(k, b, s, cfg.num_kv_heads, cfg.head_dim)
    v = _split_heads(v, b, s, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = simple_rms(q, prm.q_norm)
        k = simple_rms(k, prm.k_norm)
    if apply_rope and cfg.pos == "rope":
        q = rope(q, positions, cfg.rope_theta, cfg.partial_rotary)
        k = rope(k, positions, cfg.rope_theta, cfg.partial_rotary)
    return q, k, v


def _blocked_attention(q, k, v, causal: bool, block: int = 1024):
    """Online-softmax attention over KV blocks of ``block`` positions, in
    fp32: O(S·block) score memory instead of O(S²). The reference pads the
    last block and masks the padding to -1e30, which contributes exactly
    0 once a row has seen a real position (every row does in its first
    block); the port slices the last block short instead."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    g = h // k.shape[2]                                  # GQA group size
    qf = (q * (1.0 / math.sqrt(d))).float()
    q_pos = torch.arange(sq, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    for start in range(0, skv, block):
        kcb = k[:, start:start + block].repeat_interleave(g, dim=2).float()
        vcb = v[:, start:start + block].repeat_interleave(g, dim=2).float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kcb)
        if causal:
            kv_pos = torch.arange(start, start + kcb.shape[1],
                                  device=q.device)
            mask = kv_pos[None, :] <= q_pos[:, None]
            s = torch.where(mask[None, None], s, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vcb)
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.transpose(1, 2).to(q.dtype)               # (B, S, H, D)


def _local_map(fn, out_pls, in_pls, mesh, in_grad_pls=None):
    """``fn`` on each rank's local tensors: its DTensor arguments
    redistributed to ``in_pls`` and unwrapped, its outputs wrapped with
    ``out_pls`` (the reference's ``shard_map`` with those specs).
    ``in_grad_pls`` gives an input's gradient placements where they
    differ from its own (a replicated input whose gradients are partial
    sums, one a rank)."""
    from torch.distributed.tensor.experimental import local_map
    return local_map(fn, out_placements=out_pls, in_placements=in_pls,
                     in_grad_placements=in_grad_pls, device_mesh=mesh,
                     redistribute_inputs=True)


def _attention_sharded(q, k, v, causal: bool, block: int):
    """:func:`_blocked_attention` per (batch shard, head shard): the
    reference pins q to ("batch", None, "act_heads", None); here K/V
    share the head shards when the KV heads divide the model dim too,
    else every head is kept on every rank of it."""
    mesh, plan = shd.current_context()
    msize = shd.mesh_sizes(mesh)[plan.model_axes[0]]
    heads = "act_heads" if q.shape[2] % msize == 0 and \
        k.shape[2] % msize == 0 else None
    axes = ("batch", None, heads, None)
    pq = shd.placements(shd.spec_for_axes(axes, q.shape, plan, mesh), mesh)
    pk = shd.placements(shd.spec_for_axes(axes, k.shape, plan, mesh), mesh)
    fn = functools.partial(_blocked_attention, causal=causal, block=block)
    return _local_map(fn, pq, (pq, pk, pk), mesh)(q, k, v)


def attention(prm, x, cfg: ModelConfig, positions=None, causal: bool = True,
              kv: Optional[tuple] = None, block: int = 1024):
    """Full-sequence attention (prefill). ``kv`` overrides the K/V source
    (cross-attention, never causal)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(prm, x, cfg, positions)
    if kv is not None:
        k, v = kv
        causal = False
    if shd.sharding_active() and shd.is_dtensor(q):
        out = _attention_sharded(q, k, v, causal, block)
    else:
        out = _blocked_attention(q, k, v, causal, block=block)
    out = out.reshape(b, s, cfg.q_dim) @ prm.wo
    if cfg.use_bias:
        out = out + prm.bo
    return out


def attention_decode(prm, x, cfg: ModelConfig, cache: KVCache,
                     lengths=None):
    """Single-token decode against a KV cache, (B, 1, D) → (B, 1, D).

    ``lengths``: optional (B,) per-slot cache lengths (continuous batching:
    each slot at its own position, with its own validity mask); else the
    shared ``cache.length``. The new K/V rows are written into the cache
    tensors in place (the reference returns updated copies); the returned
    cache holds the same tensors and the length + 1."""
    b = x.shape[0]
    dev = x.device
    if lengths is None:
        pos = torch.full((b, 1), cache.length, dtype=torch.long, device=dev)
    else:
        lengths = lengths.to(device=dev, dtype=torch.long)
        pos = lengths[:, None]
    q, k_new, v_new = _project_qkv(prm, x, cfg, pos)
    if shd.sharding_active() and shd.is_dtensor(cache.k):
        out = _decode_sharded(q, k_new, v_new, cache, lengths, cfg)
        out = out @ prm.wo
        if cfg.use_bias:
            out = out + prm.bo
        return out, KVCache(cache.k, cache.v, cache.length + 1)
    s_max = cache.k.shape[1]
    if lengths is None:
        cache.k[:, cache.length] = k_new[:, 0].to(cache.k.dtype)
        cache.v[:, cache.length] = v_new[:, 0].to(cache.v.dtype)
        valid = (torch.arange(s_max, device=dev) <= cache.length)[None]
    else:
        rows = torch.arange(b, device=dev)
        cache.k[rows, lengths] = k_new[:, 0].to(cache.k.dtype)
        cache.v[rows, lengths] = v_new[:, 0].to(cache.v.dtype)
        valid = torch.arange(s_max, device=dev)[None, :] <= lengths[:, None]
    g = cfg.num_heads // cfg.num_kv_heads
    qh = q.reshape(b, 1, cfg.num_kv_heads, g, cfg.head_dim).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qh * (1.0 / math.sqrt(cfg.head_dim)),
                     cache.k.float())
    s = torch.where(valid[:, None, None, None, :], s, NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, cache.v.float())
    out = out.reshape(b, 1, cfg.q_dim).to(x.dtype) @ prm.wo
    if cfg.use_bias:
        out = out + prm.bo
    return out, KVCache(cache.k, cache.v, cache.length + 1)


def _decode_local(q, k_new, v_new, kc, vc, lengths, *, length: int,
                  offset: int, groups, cfg: ModelConfig):
    """One rank's decode attention: the new K/V rows written into its
    cache shard (positions ``offset`` … of the sequence) where they fall in
    it, scores and softmax against the shard. With the sequence sharded
    (``groups``: the process groups of its mesh dims) the max, the sum of
    exponentials and the weighted values are merged across the shards,
    the reduction GSPMD makes for the reference."""
    import torch.distributed as dist
    b, s_loc = kc.shape[0], kc.shape[1]
    dev = q.device
    pos = torch.arange(offset, offset + s_loc, device=dev)
    if lengths is None:
        if offset <= length < offset + s_loc:
            kc[:, length - offset] = k_new[:, 0].to(kc.dtype)
            vc[:, length - offset] = v_new[:, 0].to(vc.dtype)
        valid = (pos <= length)[None]
    else:
        lengths = lengths.long()
        rows = ((lengths >= offset) & (lengths < offset + s_loc)).nonzero()[:, 0]
        kc[rows, lengths[rows] - offset] = k_new[rows, 0].to(kc.dtype)
        vc[rows, lengths[rows] - offset] = v_new[rows, 0].to(vc.dtype)
        valid = pos[None, :] <= lengths[:, None]
    kh = kc.shape[2]
    g = q.shape[2] // kh
    qh = q.reshape(b, 1, kh, g, cfg.head_dim).float()
    sc = torch.einsum("bqkgd,bskd->bkgqs",
                      qh * (1.0 / math.sqrt(cfg.head_dim)), kc.float())
    sc = torch.where(valid[:, None, None, None, :], sc, NEG)
    if not groups:
        p = torch.softmax(sc, dim=-1)
        out = torch.einsum("bkgqs,bskd->bqkgd", p, vc.float())
    else:
        m = sc.amax(-1, keepdim=True)
        for grp in groups:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=grp)
        p = torch.exp(sc - m)
        den = p.sum(-1)                                   # (b, kh, g, 1)
        acc = torch.einsum("bkgqs,bskd->bqkgd", p, vc.float())
        for grp in groups:
            dist.all_reduce(den, group=grp)
            dist.all_reduce(acc, group=grp)
        out = acc / den.permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, 1, q.shape[2] * cfg.head_dim).to(q.dtype)


def _decode_sharded(q, k_new, v_new, cache: KVCache, lengths, cfg):
    """Decode attention against a sharded KV cache (a DTensor (B, S, KH,
    D) slice of the decode state, laid out by ``decode_state_specs``):
    q and the new K/V take the cache's batch and head shards and are
    replicated over its sequence shards; each rank writes and reads its
    own shard under ``local_map``. Returns the (B, 1, q_dim) output."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache.k.device_mesh
    cpl = list(cache.k.placements)
    seq_dims = _dims_sharding(cpl, 1)
    qpl = [p if p.is_shard(0) or p.is_shard(2) else Replicate() for p in cpl]
    offset = 0
    for i in seq_dims:
        offset = offset * mesh.size(i) + mesh.get_local_rank(i)
    offset *= cache.k.to_local().shape[1]
    groups = [mesh.get_group(i) for i in seq_dims]
    lpl = [Shard(0) if p.is_shard(0) else Replicate() for p in cpl]
    opl = [Shard(0) if p.is_shard(0) else
           (Shard(2) if p.is_shard(2) else Replicate()) for p in cpl]
    if lengths is not None:
        lengths = _as_dtensor(lengths, mesh)
    fn = functools.partial(_decode_local, length=cache.length, offset=offset,
                           groups=groups, cfg=cfg)
    return _local_map(fn, opl, (qpl, qpl, qpl, cpl, cpl,
                                lpl if lengths is not None else None),
                      mesh)(q, k_new, v_new, cache.k, cache.v, lengths)


def tp_out_project(x, w, axes):
    """``x @ w`` with the contraction dim sharded over "model", the
    reference's hand-scheduled TP projection: the matmul per shard under
    ``local_map`` (W's output dim gathered when FSDP shards it), then one
    all-reduce over "model" in x's dtype. ``axes``: w's logical axes.
    Outside a context, or when the contraction is not model-sharded, a
    plain ``x @ w``. A plain ``x`` (whole on every rank) returns a plain
    result."""
    ctx = shd.current_context()
    if ctx is None:
        return x @ w
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh, plan = ctx
    sizes = shd.mesh_sizes(mesh)
    m_ax = plan.model_axes[0]
    w_spec = shd.spec_for_axes(shd.effective_axes(axes, w.dim()), w.shape,
                               plan, mesh)
    if w_spec[0] != m_ax or x.shape[-1] % sizes[m_ax] != 0:
        return x @ w                      # contraction not model-sharded
    plain = not shd.is_dtensor(x)
    x, w = _as_dtensor(x, mesh), _as_dtensor(w, mesh)
    names = list(mesh.mesh_dim_names)
    dsize = math.prod(sizes[a] for a in plan.batch_axes)
    batch = x.shape[0] % dsize == 0
    xpl, opl = [Replicate()] * mesh.ndim, [Replicate()] * mesh.ndim
    for a in plan.batch_axes:
        if batch:
            xpl[names.index(a)] = opl[names.index(a)] = Shard(0)
    xpl[names.index(m_ax)] = Shard(x.dim() - 1)
    opl[names.index(m_ax)] = Partial()
    wpl = [Replicate()] * mesh.ndim
    wpl[names.index(m_ax)] = Shard(0)     # FSDP: W's output dim gathered
    # each data shard's rows give W its own partial gradient
    wgpl = [Partial() if batch and p.is_replicate() and
            names[i] in plan.batch_axes else p for i, p in enumerate(wpl)]

    def body(x_l, w_l):
        return x_l @ w_l                  # partial over "model"

    out = _local_map(body, opl, (xpl, wpl), mesh,
                     in_grad_pls=(xpl, wgpl))(x, w)
    out = out.redistribute(mesh, [Replicate() if p.is_partial() else p
                                  for p in opl])
    return out.full_tensor() if plain else out


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device,
                  num_layers: Optional[int] = None) -> KVCache:
    n = num_layers if num_layers is not None else cfg.num_layers
    shape = (n, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

# jax.nn.gelu is the tanh approximation by default
_ACTS = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
         "relu": F.relu}


def mlp_init(gen, cfg: ModelConfig, dtype, device,
             d_ff: Optional[int] = None) -> Params:
    d_ff = d_ff or cfg.d_ff
    prm = {
        "w_up": dense_init(gen, cfg.d_model, d_ff, ("embed", "mlp"), dtype,
                           device),
        "w_down": dense_init(gen, d_ff, cfg.d_model, ("mlp", "embed"), dtype,
                             device),
    }
    if cfg.mlp_gated:
        prm["w_gate"] = dense_init(gen, cfg.d_model, d_ff, ("embed", "mlp"),
                                   dtype, device)
    if cfg.use_bias:
        prm["b_up"] = zeros_init((d_ff,), ("mlp",), dtype, device)
        prm["b_down"] = zeros_init((cfg.d_model,), ("embed",), dtype,
                                   device)
    return Params(**prm)


def mlp(prm, x, cfg: ModelConfig):
    act = _ACTS[cfg.act]
    h = x @ prm.w_up
    if cfg.use_bias:
        h = h + prm.b_up
    h = act(x @ prm.w_gate) * h if cfg.mlp_gated else act(h)
    out = h @ prm.w_down
    if cfg.use_bias:
        out = out + prm.b_down
    return out

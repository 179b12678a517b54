"""The LM's building blocks, ported from ``repro.models.layers``: norms,
RoPE, the embedding, attention (online softmax over KV blocks for whole
sequences, and single-token decode against a KV cache) and the MLP.

Each function reads a :class:`~repro_torch.models.params.Params` holding
the reference's parameter dict under the same keys. The arithmetic follows
the reference step by step, in the same dtypes: norm statistics in fp32
with the elementwise math in the input dtype, attention scores and
softmax in fp32. Attention has no Pallas kernel in the reference (plain
``jnp``), so it is plain PyTorch here, mirroring the reference's blocked
online softmax rather than calling a fused library kernel. The GSPMD
sharding annotations of the reference are the identity on one device and
are dropped; its tensor-parallel projection belongs to the sharding slice.

The embedding's backward is the paper's sorted segment reduction, as the
reference's custom VJP: the cotangent rows sorted by token id and summed in
fp32 with :func:`repro_torch.core.ops.segment_reduce` (the segment_reduce
kernel on CUDA tensors).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import ops as geot
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
    prm = {"scale": ones_init((dim,), torch.float32, device)}
    if cfg.norm == "layernorm":
        prm["bias"] = zeros_init((dim,), torch.float32, device)
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


class _EmbedLookup(torch.autograd.Function):
    """``table[ids]`` whose backward is a sorted segment reduction (the
    reference's ``_embed_lookup``): the flat ids argsorted (stable), the
    cotangent rows gathered in that order, summed in fp32 into one segment
    a vocabulary row, cast to the table's dtype. The reference's sharded
    branch (a plain scatter-add when ``sharding_active()``) comes with the
    LM-sharding slice."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.scopes = kops.fusion_scopes()
        ctx.vocab = int(table.shape[0])
        ctx.save_for_backward(ids)
        return F.embedding(ids.long(), table)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        (ids,) = ctx.saved_tensors
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
        "wq": dense_init(gen, d, cfg.q_dim, dtype, device),
        "wk": dense_init(gen, d, cfg.kv_dim, dtype, device),
        "wv": dense_init(gen, d, cfg.kv_dim, dtype, device),
        "wo": dense_init(gen, cfg.q_dim, d, dtype, device),
    }
    if cfg.use_bias:
        prm["bq"] = zeros_init((cfg.q_dim,), dtype, device)
        prm["bk"] = zeros_init((cfg.kv_dim,), dtype, device)
        prm["bv"] = zeros_init((cfg.kv_dim,), dtype, device)
        prm["bo"] = zeros_init((d,), dtype, device)
    if cfg.qk_norm:
        prm["q_norm"] = ones_init((cfg.head_dim,), torch.float32, device)
        prm["k_norm"] = ones_init((cfg.head_dim,), torch.float32, device)
    return Params(**prm)


def _project_qkv(prm, x, cfg: ModelConfig, positions,
                 apply_rope: bool = True):
    b, s, _ = x.shape
    q, k, v = x @ prm.wq, x @ prm.wk, x @ prm.wv
    if cfg.use_bias:
        q, k, v = q + prm.bq, k + prm.bk, v + prm.bv
    q = q.reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
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
        "w_up": dense_init(gen, cfg.d_model, d_ff, dtype, device),
        "w_down": dense_init(gen, d_ff, cfg.d_model, dtype, device),
    }
    if cfg.mlp_gated:
        prm["w_gate"] = dense_init(gen, cfg.d_model, d_ff, dtype, device)
    if cfg.use_bias:
        prm["b_up"] = zeros_init((d_ff,), dtype, device)
        prm["b_down"] = zeros_init((cfg.d_model,), dtype, device)
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

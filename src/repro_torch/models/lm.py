"""LM assembly for every architecture of ``repro_torch.configs``, ported
from ``repro.models.lm``.

A stack is a (possibly heterogeneous) sequence of blocks; a block's kind is
(mixer, ffn) with mixer ∈ {attn, mamba, rwkv} and ffn ∈ {mlp, moe}. The
reference scans over periods of kinds with per-slot stacked parameters; the
port runs one module a layer, in layer order, and keeps
:func:`stack_plan` for the kinds and the layout of the decode caches (batch
on axis 0 of a lead layer's cache, on axis 1 of a period slot's, after the
stacked-periods axis). Encoder-decoder (Whisper) and prefix-embedding (VLM)
variants reuse the same blocks.

    model = LM(cfg)                                   # on the card
    logits, aux = model(tokens, moe_impl="cuda")      # (B, S, V) fp32
    state = init_decode_state(cfg, batch, max_len, torch.bfloat16)
    logits, state = decode_step(model, tokens[:, :1], state)
    loss, metrics = loss_fn(model, cfg, batch)        # or a {name: tensor}

Training: :func:`loss_fn` is the next-token cross entropy plus the MoE
aux loss, on an :class:`LM` or on a flat ``{name: tensor}`` dict of its
parameters (run through ``torch.func.functional_call`` on a meta-device
skeleton: the trainer's form). ``remat_policy`` checkpoints each block of
the stack: ``"none"``, ``"full"`` (recompute the whole block in the
backward) or ``"dots"`` (keep the outputs of matmuls without batch dims,
recompute the rest: the reference's ``checkpoint_dots_with_no_batch_dims``).
The three give the same gradients. A recomputed block launches its kernels
again, and the kernels' launch counters count those launches too: under
``"full"`` or ``"dots"`` a step's counts include the recomputed forwards.
Serving builds no graph: :func:`decode_step` runs under ``no_grad`` and
the parameters of an :class:`LM` are frozen.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.utils import checkpoint as ckpt_lib

from repro_torch.core.device import resolve_device
from repro_torch.distributed.sharding import (ashard, is_dtensor,
                                              place_tensor)
from repro_torch.models import layers
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import (P, Params, dense_init, generator,
                                       normal)

# ---------------------------------------------------------------------------
# kinds & periodicity
# ---------------------------------------------------------------------------


def layer_kind(cfg: ModelConfig, i: int):
    if cfg.rwkv:
        mixer = "rwkv"
    elif cfg.is_attn_layer(i):
        mixer = "attn"
    else:
        mixer = "mamba"
    return (mixer, "moe" if cfg.is_moe_layer(i) else "mlp")


def stack_plan(cfg: ModelConfig, num_layers: Optional[int] = None):
    """(lead_kinds, period_kinds, num_periods), as the reference's."""
    n = num_layers if num_layers is not None else cfg.num_layers
    kinds = [layer_kind(cfg, i) for i in range(n)]
    if cfg.unroll_layers:
        return kinds, [], 0
    lead = cfg.first_dense
    body = kinds[lead:]
    if not body:
        return kinds, [], 0
    for p in range(1, len(body) + 1):
        if len(body) % p == 0 and all(
                body[i] == body[i % p] for i in range(len(body))):
            return kinds[:lead], body[:p], len(body) // p
    return kinds, [], 0  # unreachable


def moment_groups(cfg: ModelConfig, names) -> tuple:
    """The parameters the reference stacks into one tensor: for each
    period slot and each of its parameters, that parameter's names in
    every period (``layers.{lead + p·width + s}.<path>``, in period
    order), one tuple a stacked tensor; ``names`` the LM's parameter
    names (lead layers and the rest are in no group). The reference scales
    an int8 moment over its stacked tensor, so these share one scale
    (:func:`repro_torch.optim.adamw.update_`)."""
    lead, period, _ = stack_plan(cfg)
    groups: dict = {}
    for name in names:
        parts = name.split(".")
        if parts[0] != "layers" or int(parts[1]) < len(lead):
            continue
        j = int(parts[1]) - len(lead)
        key = (j % len(period), ".".join(parts[2:]))
        groups.setdefault(key, []).append((j // len(period), name))
    return tuple(tuple(n for _, n in sorted(v)) for v in groups.values())


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _mixer_init(gen, cfg, kind, dtype, device):
    if kind == "attn":
        return layers.attention_init(gen, cfg, dtype, device)
    if kind == "mamba":
        return ssm_lib.ssm_init(gen, cfg, dtype, device)
    return rwkv_lib.rwkv_init(gen, cfg, dtype, device)


def _ffn_init(gen, cfg, kind, dtype, device):
    if kind == "moe":
        return moe_lib.moe_init(gen, cfg, dtype, device)
    if cfg.rwkv:
        return rwkv_lib.channel_mix_init(gen, cfg, dtype, device)
    return layers.mlp_init(gen, cfg, dtype, device)


class Block(Params):
    """One block's parameters; calling it runs :func:`block_forward` (so
    that ``functional_call`` can rebind them in a recomputed block)."""

    def forward(self, x, cfg: ModelConfig, kind, **kw):
        return block_forward(self, x, cfg, kind, **kw)


def block_init(gen, cfg: ModelConfig, kind, dtype, device,
               cross: bool = False) -> Block:
    prm = {
        "norm1": layers.norm_init(cfg, device),
        "mixer": _mixer_init(gen, cfg, kind[0], dtype, device),
        "norm2": layers.norm_init(cfg, device),
        "ffn": _ffn_init(gen, cfg, kind[1], dtype, device),
    }
    if cross:
        prm["norm_x"] = layers.norm_init(cfg, device)
        prm["cross"] = layers.attention_init(gen, cfg, dtype, device)
    return Block(**prm)


def _slice(cache, i: int):
    """Slice i of a stacked cache's leading axis, as views (the same
    NamedTuple type, or a plain (k, v) pair)."""
    views = [a[i] for a in cache]
    return type(cache)(*views) if hasattr(cache, "_fields") else tuple(views)


def _zero_state(cfg: ModelConfig, mixer: str, batch: int, device):
    """A recurrent mixer's state at the start of a sequence."""
    init = ssm_lib.init_ssm_state if mixer == "mamba" \
        else rwkv_lib.init_rwkv_state
    return _slice(init(cfg, batch, 1, device), 0)


def block_forward(prm, x, cfg: ModelConfig, kind, positions=None,
                  causal: bool = True, enc_kv=None,
                  moe_impl: str = "capacity"):
    """Whole-sequence block (prefill). Returns (x, MoE aux loss)."""
    mixer, ffn = kind
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = layers.apply_norm(prm.norm1, x, cfg)
    if mixer == "attn":
        mix = layers.attention(prm.mixer, h, cfg, positions, causal)
    elif mixer == "mamba":
        mix, _ = ssm_lib.ssm_forward(
            prm.mixer, h, cfg, _zero_state(cfg, mixer, x.shape[0], x.device))
    else:
        mix, _ = rwkv_lib.rwkv_time_mix(
            prm.mixer, h, cfg, _zero_state(cfg, mixer, x.shape[0], x.device))

    if cfg.parallel_block:
        # cohere-style: attention and MLP read the same normed input
        return x + mix + layers.mlp(prm.ffn, h, cfg), aux

    x = x + mix
    if "cross" in prm and enc_kv is not None:
        hx = layers.apply_norm(prm.norm_x, x, cfg)
        x = x + layers.attention(prm.cross, hx, cfg, positions, kv=enc_kv)
    h2 = layers.apply_norm(prm.norm2, x, cfg)
    if ffn == "moe":
        f, aux = moe_lib.moe(prm.ffn, h2, cfg, impl=moe_impl)
    elif cfg.rwkv:
        f, _ = rwkv_lib.rwkv_channel_mix(
            prm.ffn, h2, cfg, _zero_state(cfg, "rwkv", x.shape[0], x.device))
    else:
        f = layers.mlp(prm.ffn, h2, cfg)
    return x + f, aux


REMAT_POLICIES = ("none", "dots", "full")


def _remat(policy: str):
    """The checkpoint context of ``policy`` (None for ``"none"``). "dots"
    keeps the outputs of ``aten.mm`` (the projections, the router, the MLP
    and the head: matmuls without batch dims) and recomputes the rest,
    batched matmuls (attention scores, the capacity path's experts)
    included, as ``checkpoint_dots_with_no_batch_dims`` does."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; one of "
                         f"{REMAT_POLICIES}")
    if policy == "none":
        return None
    if policy == "dots":
        return functools.partial(ckpt_lib.create_selective_checkpoint_contexts,
                                 [torch.ops.aten.mm.default])
    return ckpt_lib.noop_context_fn


def _run_block(bp: Block, x, cfg: ModelConfig, kind, context_fn, **kw):
    """``block_forward`` under the checkpoint context ``context_fn`` of
    :func:`_remat` (None: none). The recomputed block rebinds the
    parameters it read in the forward: under an outer ``functional_call``
    the module holds them only for the forward."""
    if context_fn is None:
        return block_forward(bp, x, cfg, kind, **kw)
    params = dict(bp.named_parameters())

    def run(x):
        return torch.func.functional_call(bp, params, (x, cfg, kind), kw,
                                          strict=True)
    return ckpt_lib.checkpoint(run, x, use_reentrant=False,
                               context_fn=context_fn)


def _cross_kv(bp, enc_out, cfg):
    """An encoder output projected through a block's cross-attention K/V
    (no RoPE)."""
    _, k, v = layers._project_qkv(bp.cross, enc_out, cfg, positions=None,
                                  apply_rope=False)
    return k, v


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class LM(Params):
    """The LM of ``cfg`` with its parameters under the reference's keys:
    ``embed``, ``final_norm``, ``lm_head`` (untied), ``pos_embed``
    (learned positions), ``layers`` (one block a layer, in layer order:
    the reference's ``lead`` then its ``period`` slots unstacked) and the
    Whisper encoder's ``enc_blocks``, ``enc_norm``, ``enc_pos``.

    Built on ``device`` (None: the card, raising without one; ``"cpu"``
    for the plain versions) in ``dtype`` (default ``cfg.dtype``; norms,
    the router and the SSM/RWKV gates stay fp32, as in the reference),
    with weights drawn from a ``torch.Generator`` seeded with ``seed``
    (the reference's distributions; ``seed=None`` leaves them
    uninitialised for :func:`~repro_torch.models.params.from_jax_lm_params`
    to fill)."""

    def __init__(self, cfg: ModelConfig, dtype=None, device=None,
                 seed: Optional[int] = 0):
        device = resolve_device(device, "LM")
        dtype = dtype or getattr(torch, cfg.dtype)
        gen = generator(seed, device)
        lead_kinds, period_kinds, n_periods = stack_plan(cfg)
        kinds = list(lead_kinds) + list(period_kinds) * n_periods
        prm = {"embed": layers.embedding_init(gen, cfg, dtype, device),
               "final_norm": layers.norm_init(cfg, device)}
        if not cfg.tie_embeddings:
            prm["lm_head"] = dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                        ("embed", "vocab"), dtype, device)
        if cfg.pos == "learned":
            prm["pos_embed"] = P(normal(gen, (cfg.max_seq, cfg.d_model),
                                        dtype, device, 0.02), (None, "embed"))
        prm["layers"] = nn.ModuleList(
            block_init(gen, cfg, kind, dtype, device,
                       cross=cfg.cross_attention) for kind in kinds)
        if cfg.encoder_layers:
            prm["enc_blocks"] = nn.ModuleList(
                block_init(gen, cfg, ("attn", "mlp"), dtype, device)
                for _ in range(cfg.encoder_layers))
            prm["enc_norm"] = layers.norm_init(cfg, device)
            prm["enc_pos"] = P(normal(gen, (cfg.max_seq, cfg.d_model),
                                      dtype, device, 0.02), (None, "embed"))
        super().__init__(**prm)
        self.cfg = cfg
        self.kinds = kinds
        self.num_lead = len(lead_kinds)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.table.dtype

    def encode(self, enc_embeds):
        """The Whisper encoder over (stubbed) frame embeddings (B, S, D)."""
        cfg = self.cfg
        x = enc_embeds + self.enc_pos[: enc_embeds.shape[1]]
        for bp in self.enc_blocks:
            x, _ = block_forward(bp, x, cfg, ("attn", "mlp"), causal=False)
        return layers.apply_norm(self.enc_norm, x, cfg)

    def head(self, x):
        """Final norm and the (tied or untied) head: fp32 logits."""
        cfg = self.cfg
        x = layers.apply_norm(self.final_norm, x, cfg)
        if cfg.tie_embeddings:
            return layers.unembed(self.embed, x, cfg)
        return (x @ self.lm_head).float() * cfg.logit_scale

    def forward(self, tokens, prefix_embeds=None, enc_embeds=None,
                moe_impl: str = "capacity", remat_policy: str = "none"):
        """tokens: (B, S) → (logits (B, P + S, padded vocab) fp32, the
        summed MoE aux loss). ``prefix_embeds``: (B, P, D) stubbed modality
        frontend output (VLM), prepended to the token embeddings;
        ``enc_embeds``: (B, S_enc, D) encoder-side stub (Whisper);
        ``remat_policy``: each block's checkpointing (see the module
        docstring)."""
        cfg = self.cfg
        context_fn = _remat(remat_policy)
        x = layers.embed(self.embed, tokens)
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        x = ashard(x, "batch", "seq", None)
        b, s, _ = x.shape
        if cfg.pos == "learned":
            x = x + self.pos_embed[:s]
        positions = torch.arange(s, device=x.device).expand(b, s)
        enc_out = None
        if enc_embeds is not None and cfg.encoder_layers:
            enc_out = self.encode(enc_embeds)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for bp, kind in zip(self.layers, self.kinds):
            kv = _cross_kv(bp, enc_out, cfg) if enc_out is not None else None
            x = ashard(x, "batch", "seq", None)     # re-pinned a layer
            x, aux = _run_block(bp, x, cfg, kind, context_fn,
                                positions=positions, causal=True, enc_kv=kv,
                                moe_impl=moe_impl)
            aux_total = aux_total + aux
        # pinned before the head as the reference's scan carry is: a last
        # block's pending partial sum over "model" would otherwise meet the
        # FSDP head weight and DTensor would gather the whole batch's logits
        # on every rank
        x = ashard(x, "batch", "seq", None)
        return ashard(self.head(x), "batch", "seq", "act_vocab"), aux_total


def loss_fn(model_or_params, cfg: ModelConfig, batch,
            remat_policy: str = "full", moe_impl: str = "capacity",
            aux_weight: float = 0.01):
    """Next-token cross entropy (+ ``aux_weight`` × the summed MoE
    load-balance aux), as the reference's: fp32 logits, prefix positions
    dropped, ``batch["mask"]`` (default all ones) weighting each position.
    ``model_or_params``: an :class:`LM` of ``cfg``, or a flat
    ``{name: tensor}`` dict named as its ``named_parameters()`` (run on a
    meta-device skeleton through ``torch.func.functional_call``). ``batch``
    holds ``tokens`` and ``labels`` (B, S) and optionally ``mask``,
    ``prefix_embeds`` and ``enc_embeds``. Returns ``(loss, {"ce",
    "moe_aux"})``."""
    tokens = batch["tokens"]
    kw = dict(prefix_embeds=batch.get("prefix_embeds"),
              enc_embeds=batch.get("enc_embeds"), moe_impl=moe_impl,
              remat_policy=remat_policy)
    if isinstance(model_or_params, LM):
        logits, aux = model_or_params(tokens, **kw)
    else:
        logits, aux = torch.func.functional_call(
            LM(cfg, device="meta", seed=None), dict(model_or_params),
            (tokens,), kw, strict=True)
    # align: prefix positions (if any) produce no loss
    logits = logits[:, logits.shape[1] - tokens.shape[1]:]
    # sharded: whole vocabulary rows a rank for the normaliser and the
    # gold logit's gather (the identity outside a sharding context)
    logits = ashard(logits, "batch", "seq", None)
    args = (logits, batch["labels"].long())
    if batch.get("mask") is not None:
        args += (batch["mask"],)
    if is_dtensor(logits):
        total, count = _ce_sums_sharded(*args)
    else:
        total, count = _ce_sums(*args)
    ce = total / torch.clamp_min(count, 1.0)
    return ce + aux_weight * aux, {"ce": ce, "moe_aux": aux}


class _MaskedCrossEntropySum(torch.autograd.Function):
    """``sum((logsumexp(logits) - logits[label]) · mask)`` over the
    positions. Its backward writes ``softmax · g·mask`` and takes
    ``g·mask`` off at the gold logits in place: one tensor of the logits'
    size, where autograd's would make three (the exponentials, the gold
    gather's scatter and their sum). The same values as autograd's, to
    the bit: the same products, and x + 0 = x."""

    @staticmethod
    def forward(ctx, logits, labels, mask):
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, labels[..., None],
                                    dim=-1)[..., 0]
        ctx.save_for_backward(logits, logz, labels, mask)
        return torch.sum((logz - gold) * mask)

    @staticmethod
    def backward(ctx, g):
        logits, logz, labels, mask = ctx.saved_tensors
        gm = (g * mask)[..., None]
        grad = (logits - logz[..., None]).exp_().mul_(gm)
        grad.scatter_add_(-1, labels[..., None], -gm)
        return grad, None, None


def _ce_sums(logits, labels, mask=None):
    """The masked sum of ``logz - gold`` over the positions, and the
    mask's sum."""
    mask = torch.ones(labels.shape, dtype=torch.float32,
                      device=logits.device) if mask is None else mask.float()
    return _MaskedCrossEntropySum.apply(logits, labels, mask), mask.sum()


def _ce_sums_sharded(logits, *rest):
    """:func:`_ce_sums` on each rank's own rows of the DTensor logits (the
    batch on the data axes, the vocabulary whole): the gold logit's gather
    and its backward stay local to the shard, and only the two scalar sums
    cross ranks (partial over the dims the rows are sharded on)."""
    from torch.distributed.tensor import Partial
    mesh, pl = logits.device_mesh, list(logits.placements)
    rest = tuple(r if is_dtensor(r) else place_tensor(r, mesh, pl)
                 for r in rest)
    sums = [Partial() if p.is_shard() else p for p in pl]
    return layers._local_map(_ce_sums, (sums, sums), (pl,) * (1 + len(rest)),
                             mesh)(logits, *rest)


# ---------------------------------------------------------------------------
# decode (a one-token serve step against the caches)
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    """The caches of every layer: ``lead`` one a lead layer (batch on axis
    0), ``period`` one a period slot stacked over the periods (periods on
    axis 0, batch on axis 1); attention layers hold a ``(k, v)`` pair,
    Mamba an ``SSMState``, RWKV an ``RWKVState``. ``length`` counts the
    tokens fed (the shared position when no per-slot lengths are given)."""
    lead: tuple
    period: tuple
    length: int


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device=None) -> DecodeState:
    """Zeroed caches for ``batch`` sequences of up to ``max_len`` tokens
    (KV in ``dtype``, recurrent states fp32) on ``device`` (None: the
    card)."""
    device = resolve_device(device, "init_decode_state")
    lead_kinds, period_kinds, n_periods = stack_plan(cfg)

    def mk(kind, n):
        if kind[0] == "attn":
            shape = (n, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
            return (torch.zeros(shape, dtype=dtype, device=device),
                    torch.zeros(shape, dtype=dtype, device=device))
        if kind[0] == "mamba":
            return ssm_lib.init_ssm_state(cfg, batch, n, device)
        return rwkv_lib.init_rwkv_state(cfg, batch, n, device)

    lead = tuple(_slice(mk(kind, 1), 0) for kind in lead_kinds)
    period = tuple(mk(kind, n_periods) for kind in period_kinds)
    return DecodeState(lead, period, 0)


def _layer_cache(state: DecodeState, i: int, num_lead: int):
    """Layer i's cache as views into the state's tensors (a period layer's
    slice of its slot's stacked caches)."""
    if i < num_lead:
        return state.lead[i]
    j = i - num_lead
    width = len(state.period)
    return _slice(state.period[j % width], j // width)


def _store(views, new) -> None:
    """Write a layer's new cache into its views of the state (the
    reference returns a new state; the port keeps the same tensors)."""
    for view, val in zip(views, new):
        if val is not view:
            view.copy_(val)


def _block_decode(bp, x, cfg, kind, cache, length: int, enc_kv=None,
                  moe_impl: str = "capacity", lengths=None):
    mixer, ffn = kind
    h = layers.apply_norm(bp.norm1, x, cfg)
    if mixer == "attn":
        mix, new_kv = layers.attention_decode(
            bp.mixer, h, cfg, layers.KVCache(cache[0], cache[1], length),
            lengths=lengths)
        new_cache = (new_kv.k, new_kv.v)
    elif mixer == "mamba":
        mix, new_cache = ssm_lib.ssm_forward(bp.mixer, h, cfg, cache)
    else:
        mix, new_cache = rwkv_lib.rwkv_time_mix(bp.mixer, h, cfg, cache)

    if cfg.parallel_block:
        return x + mix + layers.mlp(bp.ffn, h, cfg), new_cache

    x = x + mix
    if "cross" in bp and enc_kv is not None:
        hx = layers.apply_norm(bp.norm_x, x, cfg)
        x = x + layers.attention(bp.cross, hx, cfg, kv=enc_kv)
    h2 = layers.apply_norm(bp.norm2, x, cfg)
    if ffn == "moe":
        f, _ = moe_lib.moe(bp.ffn, h2, cfg, impl=moe_impl)
    elif cfg.rwkv:
        f, new_cache = rwkv_lib.rwkv_channel_mix(bp.ffn, h2, cfg, new_cache)
    else:
        f = layers.mlp(bp.ffn, h2, cfg)
    return x + f, new_cache


@torch.no_grad()
def decode_step(model: LM, tokens, state: DecodeState, enc_out=None,
                moe_impl: str = "capacity", lengths=None):
    """tokens: (B, 1) → (logits (B, 1, padded vocab) fp32, new state).

    ``lengths``: optional (B,) per-slot cache lengths (continuous
    batching, :mod:`repro_torch.serve.lm`); default: the shared
    ``state.length``. The caches are updated in place: the returned state
    holds the same tensors, its length advanced by one."""
    cfg = model.cfg
    x = ashard(layers.embed(model.embed, tokens), "batch", None, None)
    if cfg.pos == "learned":
        if lengths is None:
            x = x + model.pos_embed[state.length:state.length + 1]
        else:
            x = x + model.pos_embed[lengths.long()][:, None]
    for i, (bp, kind) in enumerate(zip(model.layers, model.kinds)):
        kv = _cross_kv(bp, enc_out, cfg) \
            if enc_out is not None and "cross" in bp else None
        cache = _layer_cache(state, i, model.num_lead)
        x, new_cache = _block_decode(bp, x, cfg, kind, cache, state.length,
                                     enc_kv=kv, moe_impl=moe_impl,
                                     lengths=lengths)
        _store(cache, new_cache)
    return model.head(x), DecodeState(state.lead, state.period,
                                      state.length + 1)

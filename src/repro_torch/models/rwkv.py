"""RWKV6 "Finch" block (arXiv:2404.05892), ported from
``repro.models.rwkv``: attention-free time-mix with data-dependent decay
(the LoRA-parameterised per-token decay) and a squared-ReLU channel-mix.

As in the reference: token-shift interpolation uses static per-channel µ
and the output normalisation is a per-head RMS. The recurrence runs as a
loop over time in fp32, so decode is O(1) a token.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.params import (P, Params, dense_init, ones_init,
                                       uniform)

_DECAY_LORA = 64


class RWKVState(NamedTuple):
    wkv: torch.Tensor      # (B, H, Dk, Dv) per-head linear-attention state
    tm_prev: torch.Tensor  # (B, D) previous token (time-mix shift)
    cm_prev: torch.Tensor  # (B, D) previous token (channel-mix shift)


def rwkv_init(gen, cfg: ModelConfig, dtype, device) -> Params:
    d = cfg.d_model
    def mu():
        return P(uniform(gen, (d,), torch.float32, device), ("embed",))
    return Params(
        mu_r=mu(), mu_k=mu(), mu_v=mu(), mu_w=mu(), mu_g=mu(),
        wr=dense_init(gen, d, d, ("embed", "heads"), dtype, device),
        wk=dense_init(gen, d, d, ("embed", "heads"), dtype, device),
        wv=dense_init(gen, d, d, ("embed", "heads"), dtype, device),
        wg=dense_init(gen, d, d, ("embed", "heads"), dtype, device),
        wo=dense_init(gen, d, d, ("heads", "embed"), dtype, device),
        # data-dependent decay LoRA: w_t = exp(-exp(w0 + tanh(x A) B))
        w0=P(torch.full((d,), -6.0, dtype=torch.float32, device=device),
             ("embed",)),
        a_w=dense_init(gen, d, _DECAY_LORA, ("embed", None), torch.float32,
                       device),
        b_w=dense_init(gen, _DECAY_LORA, d, (None, "embed"), torch.float32,
                       device),
        u=P(torch.zeros((d,), dtype=torch.float32, device=device),
            ("embed",)),
        ln_out=ones_init((d,), ("embed",), torch.float32, device),
    )


def _lerp(x, x_prev, mu):
    return x + (x_prev - x) * mu.to(x.dtype)


def _decay(prm, xw):
    lora = torch.tanh(xw.float() @ prm.a_w) @ prm.b_w
    return torch.exp(-torch.exp(prm.w0 + lora))              # (…, D) ∈ (0,1)


def _whole_heads(t, h: int):
    """A DTensor whose last dim (H·Dk) is sharded over mesh dims that do not
    divide its H heads, gathered on that dim (a reshape to heads cannot
    split a head; the state keeps such heads whole too,
    ``decode_state_specs``); anything else as it is."""
    from repro_torch.distributed import sharding as shd
    if not shd.is_dtensor(t):
        return t
    last = t.dim() - 1
    parts = 1
    for n, p in zip(t.device_mesh.mesh.shape, t.placements):
        if p.is_shard(last):
            parts *= int(n)
    if h % parts == 0:
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [Replicate() if p.is_shard(last)
                                          else p for p in t.placements])


def _wkv_step(state, r, k, v, w, u, h, dk):
    """One recurrence step on the (B, H, Dk, Dv) state."""
    b = r.shape[0]
    rh, kh, vh, wh = (t.reshape(b, h, dk) for t in (r, k, v, w))
    uh = u.reshape(h, dk)
    kv = kh[..., :, None] * vh[..., None, :]                  # (B,H,Dk,Dv)
    y = torch.einsum("bhk,bhkv->bhv", rh, state + uh[None, :, :, None] * kv)
    state = wh[..., :, None] * state + kv
    return state, y.reshape(b, h * dk)


def rwkv_time_mix(prm, x, cfg: ModelConfig, state: RWKVState):
    """x: (B, S, D) → (out, new state), a sequential loop over S."""
    b, s, d = x.shape
    h, dk = cfg.num_heads, cfg.head_dim
    x_prev = torch.cat([state.tm_prev[:, None].to(x.dtype), x[:, :-1]], 1)
    r = _lerp(x, x_prev, prm.mu_r) @ prm.wr
    k = _lerp(x, x_prev, prm.mu_k) @ prm.wk
    v = _lerp(x, x_prev, prm.mu_v) @ prm.wv
    g = F.silu(_lerp(x, x_prev, prm.mu_g) @ prm.wg)
    w = _decay(prm, _lerp(x, x_prev, prm.mu_w))              # (B,S,D) fp32
    r, k, v, w, u = (_whole_heads(t, h) for t in (r, k, v, w, prm.u))
    wkv = state.wkv
    ys = []
    for t in range(s):
        wkv, y_t = _wkv_step(wkv, r[:, t].float(), k[:, t].float(),
                             v[:, t].float(), w[:, t], u, h, dk)
        ys.append(y_t)
    y = torch.stack(ys, 1)                                   # (B,S,D)
    # per-head RMS (the GroupNorm stand-in), then gate + output proj
    yh = y.reshape(b, s, h, dk)
    yh = yh * torch.rsqrt(yh.square().mean(-1, keepdim=True) + 1e-5)
    y = (yh.reshape(b, s, d) * prm.ln_out).to(x.dtype) * g
    return y @ prm.wo, RWKVState(wkv, x[:, -1].float(), state.cm_prev)


def channel_mix_init(gen, cfg: ModelConfig, dtype, device) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    return Params(
        mu_k=P(uniform(gen, (d,), torch.float32, device), ("embed",)),
        wk=dense_init(gen, d, f, ("embed", "mlp"), dtype, device),
        wv=dense_init(gen, f, d, ("mlp", "embed"), dtype, device),
        wr=dense_init(gen, d, d, ("embed", "embed2"), dtype, device),
    )


def rwkv_channel_mix(prm, x, cfg: ModelConfig, state: RWKVState):
    x_prev = torch.cat([state.cm_prev[:, None].to(x.dtype), x[:, :-1]], 1)
    xk = _lerp(x, x_prev, prm.mu_k)
    k = torch.square(F.relu(xk @ prm.wk))
    out = torch.sigmoid(x @ prm.wr) * (k @ prm.wv)
    return out, RWKVState(state.wkv, state.tm_prev, x[:, -1].float())


def init_rwkv_state(cfg: ModelConfig, batch: int, num_layers: int,
                    device) -> RWKVState:
    h, dk = cfg.num_heads, cfg.head_dim
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32,  # noqa
                                       device=device)
    return RWKVState(zeros(num_layers, batch, h, dk, dk),
                     zeros(num_layers, batch, cfg.d_model),
                     zeros(num_layers, batch, cfg.d_model))

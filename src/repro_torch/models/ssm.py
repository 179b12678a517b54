"""Mamba selective-SSM block (Jamba's hybrid stack, arXiv:2403.19887),
ported from ``repro.models.ssm``: in-proj → causal depthwise conv1d →
data-dependent (Δ, B, C) → diagonal state-space scan → gated out-proj. The
scan is a loop over time in fp32, as the reference's ``lax.scan``; a
decode step carries the conv window and the SSM state (O(1) a token).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.params import (P, Params, dense_init, normal,
                                       uniform, zeros_init)


class SSMState(NamedTuple):
    conv: torch.Tensor   # (B, d_conv-1, d_inner) rolling conv window
    h: torch.Tensor      # (B, d_inner, d_state) SSM state


def _dt_rank(cfg: ModelConfig) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def ssm_init(gen, cfg: ModelConfig, dtype, device) -> Params:
    d = cfg.d_model
    di, ds, dtr = cfg.expand * d, cfg.d_state, _dt_rank(cfg)
    a = torch.arange(1, ds + 1, dtype=torch.float32,
                     device=device)[None].repeat(di, 1)
    dt = torch.clamp_min(uniform(gen, (di,), torch.float32, device) * 0.099
                         + 0.001, 1e-4)
    return Params(
        in_proj=dense_init(gen, d, 2 * di, ("embed", "mlp"), dtype, device),
        conv_w=P(normal(gen, (cfg.d_conv, di), torch.float32, device,
                        1.0 / math.sqrt(cfg.d_conv)), (None, "mlp")),
        conv_b=zeros_init((di,), ("mlp",), torch.float32, device),
        x_proj=dense_init(gen, di, dtr + 2 * ds, ("mlp", None), dtype,
                          device),
        dt_proj=dense_init(gen, dtr, di, (None, "mlp"), torch.float32,
                           device),
        dt_bias=P(torch.log(torch.expm1(dt)), ("mlp",)),
        a_log=P(torch.log(a), ("mlp", None)),
        d_skip=P(torch.ones((di,), dtype=torch.float32, device=device),
                 ("mlp",)),
        out_proj=dense_init(gen, di, d, ("mlp", "embed"), dtype, device),
    )


def _selective_scan(prm, xc, cfg: ModelConfig, h0):
    """xc: (B, S, di) after the conv. Returns (y (B, S, di) fp32,
    h_final)."""
    dtr, ds = _dt_rank(cfg), cfg.d_state
    dbl = xc @ prm.x_proj
    dt = F.softplus(dbl[..., :dtr].float() @ prm.dt_proj + prm.dt_bias)
    bmat = dbl[..., dtr:dtr + ds].float()
    cmat = dbl[..., dtr + ds:].float()
    a = -torch.exp(prm.a_log)                                    # (di, ds)
    h = h0
    ys = []
    for t in range(xc.shape[1]):
        dtt = dt[:, t]
        da = torch.exp(dtt[..., None] * a)                       # (B, di, ds)
        dbx = (dtt * xc[:, t].float())[..., None] * bmat[:, t, None, :]
        h = da * h + dbx
        ys.append(torch.einsum("bds,bs->bd", h, cmat[:, t]))
    y = torch.stack(ys, 1) + xc.float() * prm.d_skip
    return y, h


def ssm_forward(prm, x, cfg: ModelConfig, state: SSMState):
    """x: (B, S, D) → (out, new state)."""
    s = x.shape[1]
    di = cfg.expand * cfg.d_model
    xz = x @ prm.in_proj
    xin, z = xz[..., :di], xz[..., di:]
    # causal depthwise conv1d with the carried window
    window = torch.cat([state.conv.to(xin.dtype), xin], dim=1)
    segs = [window[:, i: i + s] * prm.conv_w[i].to(xin.dtype)
            for i in range(cfg.d_conv)]
    xc = F.silu(sum(segs) + prm.conv_b.to(xin.dtype))
    y, h_final = _selective_scan(prm, xc, cfg, state.h)
    out = (y * F.silu(z.float())).to(x.dtype) @ prm.out_proj
    return out, SSMState(window[:, s:].float(), h_final)


def init_ssm_state(cfg: ModelConfig, batch: int, num_layers: int,
                   device) -> SSMState:
    di = cfg.expand * cfg.d_model
    return SSMState(
        torch.zeros((num_layers, batch, cfg.d_conv - 1, di),
                    dtype=torch.float32, device=device),
        torch.zeros((num_layers, batch, di, cfg.d_state),
                    dtype=torch.float32, device=device))

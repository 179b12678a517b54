"""AdamW with configurable state precision (fp32 / bf16 / int8-quantized
moments): the reference's math (``repro/optim/adamw.py``) on torch tensors.

Plain functions, not ``torch.optim.AdamW``: the update is the reference's
to the operation (global-norm clip, bias corrections, ``u + wd·p`` before
the lr step), in fp32, so that a trajectory can be held against the JAX
package's. Parameter and moment trees are dicts of tensors (a moment of an
int8 state is a :class:`QTensor`); the step count lives on the host, so
the bias corrections and the learning rate are fp32 host scalars and an
update reads nothing back from the card.

int8 states use per-tensor absmax scaling; the quantization error is
re-absorbed every step, since moments are reconstructed, updated in fp32
and re-quantized.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"      # float32 | bfloat16 | int8


class QTensor(NamedTuple):
    """int8 payload + fp32 absmax scale (per tensor)."""
    q: torch.Tensor
    scale: torch.Tensor


class AdamWState(NamedTuple):
    step: int                    # updates applied so far
    mu: Dict[str, object]        # first moments, one per parameter
    nu: Dict[str, object]        # second moments


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _encode(x, dtype: str):
    if dtype == "int8":
        scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
        return QTensor(torch.round(x / scale).to(torch.int8), scale)
    return x.to(_DTYPES[dtype])


def _decode(x, dtype: str):
    if dtype == "int8":
        return x.q.float() * x.scale
    return x.float()


def init(params: Dict[str, torch.Tensor], cfg: AdamWConfig) -> AdamWState:
    """Zero moments beside each parameter, in ``cfg.state_dtype``."""
    def zeros():
        return {k: _encode(torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device), cfg.state_dtype)
                for k, p in params.items()}
    return AdamWState(0, zeros(), zeros())


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, fp32, on the leaves'
    device."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


def update(grads: Dict[str, torch.Tensor], state: AdamWState,
           params: Dict[str, torch.Tensor], cfg: AdamWConfig,
           lr_scale=1.0):
    """Returns (new_params, new_state, metrics). New parameters are fresh
    leaf tensors with the old ones' ``requires_grad``."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    step = state.step + 1
    t = np.float32(step)
    bc1 = float(np.float32(1.0) - np.float32(cfg.b1) ** t)
    bc2 = float(np.float32(1.0) - np.float32(cfg.b2) ** t)
    lr = float(np.float32(cfg.lr) * np.float32(lr_scale))
    sd = cfg.state_dtype
    new_p, new_mu, new_nu = {}, {}, {}
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k].float() * clip
            mu = cfg.b1 * _decode(state.mu[k], sd) + (1.0 - cfg.b1) * g
            nu = (cfg.b2 * _decode(state.nu[k], sd)
                  + (1.0 - cfg.b2) * torch.square(g))
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
            u = u + cfg.weight_decay * p.float()
            new_p[k] = (p.float() - lr * u).to(p.dtype).requires_grad_(
                p.requires_grad)
            new_mu[k], new_nu[k] = _encode(mu, sd), _encode(nu, sd)
    return new_p, AdamWState(step, new_mu, new_nu), {
        "grad_norm": gnorm.detach(), "lr": lr}

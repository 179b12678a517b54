"""AdamW with configurable state precision (fp32 / bf16 / int8-quantized
moments): the reference's math (``repro/optim/adamw.py``) on torch tensors.

Plain functions, not ``torch.optim.AdamW``: the update is the reference's
to the operation (global-norm clip, bias corrections, ``u + wd·p`` before
the lr step), in fp32, so that a trajectory can be held against the JAX
package's. Parameter and moment trees are dicts of tensors (a moment of an
int8 state is a :class:`QTensor`); the step count lives on the host, so
the bias corrections and the learning rate are fp32 host scalars and an
update reads nothing back from the card.

int8 states use absmax scaling; the quantization error is re-absorbed
every step, since moments are reconstructed, updated in fp32 and
re-quantized. The scale is a tensor's own absmax, or a group's
(``groups=``): the reference stacks an LM's period slot over its layers
and scales the stacked moment as one tensor, the port holds one tensor a
layer (:func:`repro_torch.models.lm.moment_groups` names the groups), so
each member of a group is scaled by the max over all of its layers.

:func:`update_` writes the update into the parameters' and moments' own
tensors (the trainer's step: no second copy of either lives on the card,
which an LM at full width could not hold); :func:`update` runs the same
arithmetic on copies and leaves its arguments as they were. Both give the
same bits.
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


def _units(names, groups) -> list:
    """``names`` as the tuples that share a scale: each group of
    ``groups`` whole, at its first member's place, every other name
    alone."""
    group_of = {k: tuple(g) for g in (groups or ()) for k in g}
    units, seen = [], set()
    for k in names:
        unit = group_of.get(k, (k,))
        if unit[0] not in seen:
            seen.add(unit[0])
            units.append(unit)
    return units


def init(params: Dict[str, torch.Tensor], cfg: AdamWConfig) -> AdamWState:
    """Zero moments beside each parameter, in ``cfg.state_dtype``."""
    def zeros():     # zeros_like: a sharded parameter's moments shard alike
        return {k: _encode(torch.zeros_like(p, dtype=torch.float32,
                                            requires_grad=False),
                           cfg.state_dtype)
                for k, p in params.items()}
    return AdamWState(0, zeros(), zeros())


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, fp32, on the leaves'
    device."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


def _copy_moment(m):
    if isinstance(m, QTensor):
        return QTensor(m.q.clone(), m.scale.clone())
    return m.clone()


def _store(slot, value, dtype: str) -> None:
    """Write an updated fp32 moment into its state tensor (already there
    for an fp32 state, which is updated in place)."""
    if dtype == "int8":
        enc = _encode(value, dtype)
        slot.q.copy_(enc.q)
        slot.scale.copy_(enc.scale)
    elif value is not slot:
        slot.copy_(value)


def update(grads: Dict[str, torch.Tensor], state: AdamWState,
           params: Dict[str, torch.Tensor], cfg: AdamWConfig,
           lr_scale=1.0, groups=None):
    """Returns (new_params, new_state, metrics). New parameters are fresh
    leaf tensors with the old ones' ``requires_grad``; ``params`` and
    ``state`` are left as they were. ``groups``: as :func:`update_`."""
    params = {k: p.detach().clone().requires_grad_(p.requires_grad)
              for k, p in params.items()}
    state = AdamWState(state.step,
                       {k: _copy_moment(m) for k, m in state.mu.items()},
                       {k: _copy_moment(m) for k, m in state.nu.items()})
    return update_(grads, state, params, cfg, lr_scale, groups)


def update_(grads: Dict[str, torch.Tensor], state: AdamWState,
            params: Dict[str, torch.Tensor], cfg: AdamWConfig,
            lr_scale=1.0, groups=None):
    """:func:`update` written into ``params``' and ``state``'s own
    tensors, one parameter at a time (its fp32 temporaries are the only
    extra memory). Returns ``(params, new_state, metrics)``: the same
    dicts and tensors, the state's step advanced.

    ``groups``: tuples of parameter names whose int8 moments are scaled
    together, by the absmax over all of them (each member's scale tensor
    gets the group's); None, or a name in no group, scales a moment by its
    own absmax. A group's updated moments are computed twice, once for
    the absmax and once to quantize and apply them, so that no more than
    one member's fp32 moments live at a time; both passes give the same
    bits."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    step = state.step + 1
    t = np.float32(step)
    bc1 = float(np.float32(1.0) - np.float32(cfg.b1) ** t)
    bc2 = float(np.float32(1.0) - np.float32(cfg.b2) ** t)
    lr = float(np.float32(cfg.lr) * np.float32(lr_scale))
    sd = cfg.state_dtype

    def moments(k):
        g = grads[k].float() * clip
        # the reference's b·m + (1 - b)·g, each product rounded alike
        mu = _decode(state.mu[k], sd).mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
        nu = _decode(state.nu[k], sd).mul_(cfg.b2).add_(
            torch.square(g).mul_(1.0 - cfg.b2))
        return mu, nu

    with torch.no_grad():
        for unit in _units(params, groups if sd == "int8" else None):
            s_mu = s_nu = None
            if len(unit) > 1:
                for k in unit:
                    mu, nu = moments(k)
                    a_mu, a_nu = torch.max(torch.abs(mu)), \
                        torch.max(torch.abs(nu))
                    del mu, nu
                    s_mu = a_mu if s_mu is None else torch.maximum(s_mu, a_mu)
                    s_nu = a_nu if s_nu is None else torch.maximum(s_nu, a_nu)
                s_mu = torch.clamp(s_mu, min=1e-12) / 127.0
                s_nu = torch.clamp(s_nu, min=1e-12) / 127.0
            for k in unit:
                mu, nu = moments(k)
                if s_mu is None:
                    _store(state.mu[k], mu, sd)
                    _store(state.nu[k], nu, sd)
                else:     # the payload now, the group's scale at the end
                    state.mu[k].q.copy_(torch.round(mu / s_mu).to(torch.int8))
                    state.nu[k].q.copy_(torch.round(nu / s_nu).to(torch.int8))
                # (mu / bc1) / (sqrt(nu / bc2) + eps) + wd·p, then p - lr·u
                den = (nu / bc2).sqrt_().add_(cfg.eps)
                del nu
                u = (mu / bc1).div_(den)
                del mu, den
                p = params[k]
                u.add_(p.float() * cfg.weight_decay).mul_(lr)
                if p.dtype == torch.float32:
                    p.sub_(u)
                else:
                    p.copy_(p.float().sub_(u))
                del u
            if s_mu is not None:
                for k in unit:
                    state.mu[k].scale.copy_(s_mu)
                    state.nu[k].scale.copy_(s_nu)
    return params, AdamWState(step, state.mu, state.nu), {
        "grad_norm": gnorm.detach(), "lr": lr}

"""LR schedules (warmup + cosine decay), addressable by name via
:func:`get`: every schedule shares the ``(step, warmup_steps,
total_steps)`` signature and returns a multiplicative scale on the
optimizer's base LR. Computed on the host in fp32, as the reference
(``repro/optim/schedule.py``) computes it in jnp fp32."""
from __future__ import annotations

import numpy as np

_F = np.float32


def warmup_cosine(step, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> float:
    """Multiplicative LR scale in [min_ratio, 1]."""
    step = _F(step)
    warm = step / _F(max(warmup_steps, 1))
    prog = (step - _F(warmup_steps)) / _F(max(total_steps - warmup_steps, 1))
    prog = np.clip(prog, _F(0.0), _F(1.0))
    cos = _F(min_ratio) + _F((1.0 - min_ratio) * 0.5) * (
        _F(1.0) + np.cos(_F(np.pi) * prog))
    return float(warm if step < warmup_steps else cos)


def constant(step, warmup_steps: int = 0, total_steps: int = 0) -> float:
    """Flat scale 1 after the linear warmup (``total_steps`` unused)."""
    step = _F(step)
    return float(step / _F(max(warmup_steps, 1)) if step < warmup_steps
                 else _F(1.0))


_SCHEDULES = {"warmup_cosine": warmup_cosine, "constant": constant}


def get(name: str):
    """Resolve a schedule by name (the ``TrainerConfig.lr_schedule`` knob)."""
    try:
        return _SCHEDULES[name]
    except KeyError:
        raise ValueError(f"unknown LR schedule {name!r}; "
                         f"known: {sorted(_SCHEDULES)}") from None

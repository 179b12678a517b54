"""Run-time config selection (paper Fig. 5, right side).

Order of precedence (the reference package's):
  1. measured: the winner of a sweep of the built kernel instances on this
     card, kept in the :class:`~repro_torch.core.autotune.PerfDB` (opt-in:
     ``tune=True``, or ``REPRO_AUTOTUNE=1`` with ``tune=None``);
  2. the generated rules (``_generated_rules.py``, produced by
     ``python -m repro_torch.core.train_rules``);
  3. the hand-crafted shipped values (:func:`hand_crafted_config`), where
     the rules module is missing, and for the ops whose kernels read no
     axis of a config (the softmax, sddmm, segment_matmul): the rules were
     distilled for the M_b and S_b axes only.

One deliberate difference from the reference: a failed measurement
raises. The reference warns and falls back to the rules, which would hide
a kernel instance that failed to build or to launch.
"""
from __future__ import annotations

import math

from repro_torch.core.config_space import (OP_AXIS, TILE_SIZES,
                                           KernelConfig, default_config)

try:  # the generated module is committed; keep the fallback honest
    from repro_torch.core import _generated_rules
except ImportError:  # pragma: no cover
    _generated_rules = None

def select_config(idx_size: int, num_segments: int, feat: int, *,
                  op: str = "segment_reduce", tune: "bool | None" = None,
                  db=None, io_dtype: str = "float32") -> KernelConfig:
    """Pick ⟨schedule, S_b, N_b, M_b, K_c⟩ for ``op`` from O(1) features.

    ``tune=None`` defers to ``REPRO_AUTOTUNE``; ``tune=True`` sweeps once
    per shape class on the card (and raises without one) and reuses the
    PerfDB entry after; ``tune=False`` pins the rules. ``db`` is an
    explicit PerfDB (tests, hermetic runs); ``io_dtype`` picks the measured
    tier's shelf (the rules are dtype-blind)."""
    if op not in OP_AXIS:
        raise ValueError(f"unknown op {op!r}; registered: {tuple(OP_AXIS)}")
    if tune is None:
        from repro_torch.core.autotune import autotune_enabled
        tune = autotune_enabled()
    if tune:
        from repro_torch.core import autotune
        return autotune.tune(op=op, idx_size=int(idx_size),
                             num_segments=int(num_segments), feat=int(feat),
                             db=db, io_dtype=io_dtype).config
    if _generated_rules is None or OP_AXIS[op] is None:
        return hand_crafted_config(idx_size, num_segments, feat)
    log2_size = math.log2(max(idx_size, 1))
    avg = idx_size / max(num_segments, 1)
    log2_avg = math.log2(max(avg, 2 ** -4))
    log2_feat = math.log2(max(feat, 1))
    return _generated_rules.select(log2_size, log2_avg, log2_feat)


def select_plan_config(idx_size: int, num_segments: int, feat: int, *,
                       tune: "bool | None" = None, db=None) -> KernelConfig:
    """The config of a plan that every aggregation on the graph reads: M_b
    for the gather and segment_reduce, S_b for the fused kernel. The rules
    give both; measured, M_b is the gather sweep's winner and S_b the
    fused sweep's (at ``feat`` → ``feat``; the default tile where no tile
    fits that width)."""
    if tune is None:
        from repro_torch.core.autotune import autotune_enabled
        tune = autotune_enabled()
    if not tune:
        return select_config(idx_size, num_segments, feat, tune=False)
    kw = dict(tune=True, db=db)
    m_b = select_config(idx_size, num_segments, feat,
                        op="gather_segment_reduce", **kw).m_b
    cfg = default_config(feat)
    if fusable_width(feat):
        cfg = select_config(idx_size, num_segments, feat,
                            op="fused_transform_reduce", **kw)
    return KernelConfig("SR", cfg.s_b, default_config(feat).n_b, m_b, 1)


def fusable_width(feat: int) -> bool:
    """Does any built tile's fp32 fused block fit at ``feat`` → ``feat``?"""
    from repro_torch.kernels.fused_transform_reduce import fusable
    return any(fusable(feat, feat, "float32", KernelConfig(s_b=t))
               for t in TILE_SIZES)


def hand_crafted_config(idx_size: int, num_segments: int,
                        feat: int) -> KernelConfig:
    """The engineering-experience baseline of Fig. 8: the shipped values
    (M_b = 64, S_b = 64), kept for the ablation and as the sweep's seed."""
    return default_config(feat)

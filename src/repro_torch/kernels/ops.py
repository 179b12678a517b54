"""Public wrappers around the kernels: backend choice, config resolution,
plan metadata, and launch accounting.

Backend (``impl``):

  * ``None`` — ``"cuda"`` for CUDA tensors, ``"ref"`` for CPU tensors;
  * ``"cuda"`` — the hand-written Hopper kernel; raises on CPU tensors;
  * ``"ref"`` — the plain PyTorch version, on any device (on the card it is
    only ever asked for explicitly, as an oracle);
  * ``"blocked"`` — gather_segment_reduce, segment_reduce and
    segment_softmax: their kernels' row-run schedules in plain PyTorch.

There is no fallback: a CUDA tensor reaches the kernel or the call raises.

Config: the fused kernel and segment_matmul tile by ``plan`` > explicit
``config=`` > the Hopper default. The row-run kernels (gather_segment_reduce,
segment_reduce, segment_softmax) have a run length of their own and read
nothing of a config: for them ``config=`` is only checked against the plan.
Either way a plan's tiling is authoritative and an explicit config must
agree with it.
A plan's metadata must lie on the data's device: no call copies it (build
plans with ``device=``, or move one once with ``plan.to``).

Accounting: each kernel module keeps a plain-int launch counter
(:func:`launch_counts`, :func:`reset_launch_counts`), bumped only where
its kernel launches. :func:`account` / :func:`fusion_scope` record which
kernels (``fused:<op>``) or plain versions (``unfused:<op>:<impl>``) a
block of work ran, so a served step can report what it launched.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import threading
from typing import Optional

import torch

from repro_torch.core.config_space import KernelConfig, default_config
from repro_torch.kernels import fused_transform_reduce as _ftr
from repro_torch.kernels import gather_segment_reduce as _gsr
from repro_torch.kernels import sddmm as _sdd
from repro_torch.kernels import segment_matmul as _smm
from repro_torch.kernels import segment_reduce as _srd
from repro_torch.kernels import segment_softmax as _ssm
from repro_torch.kernels.segment_reduce import _resolve_plan, _round_up, chunk_metadata

IMPLS = ("cuda", "ref", "blocked")
_KERNEL_MODULES = {"gather_segment_reduce": _gsr,
                   "segment_softmax": _ssm,
                   "fused_transform_reduce": _ftr,
                   "segment_reduce": _srd,
                   "sddmm": _sdd,
                   "segment_matmul": _smm}


def resolve_impl(t: torch.Tensor, impl: Optional[str],
                 impls: tuple = IMPLS) -> str:
    """``impl`` for an op whose data lies in ``t`` and that offers
    ``impls``."""
    if impl is None:
        return "cuda" if t.is_cuda else "ref"
    if impl not in impls:
        raise ValueError(f"unknown impl {impl!r}; one of {impls}")
    if impl == "cuda" and not t.is_cuda:
        raise ValueError(f"impl='cuda' needs CUDA tensors, got {t.device}; "
                         "pass CPU tensors with impl=None or 'ref'")
    return impl


# ---------------------------------------------------------------------------
# launch counters (one plain int per kernel, kept by its module)
# ---------------------------------------------------------------------------

def launch_counts() -> dict:
    """Launches of each CUDA kernel since the last reset."""
    return {name: mod.launches for name, mod in _KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _KERNEL_MODULES.values():
        mod.launches = 0


# ---------------------------------------------------------------------------
# fusion accounting: "<kind>:<op>" counters, scoped per thread/context
# ---------------------------------------------------------------------------

_FUSION_LOCK = threading.Lock()
_FUSION_GLOBAL: collections.Counter = collections.Counter()
_FUSION_SCOPES: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_fusion_scopes", default=())


def _fusion_sink() -> collections.Counter:
    scopes = _FUSION_SCOPES.get()
    return scopes[-1] if scopes else _FUSION_GLOBAL


def account(kind: str, op: str) -> None:
    """Record one ``kind`` ∈ {"fused", "unfused"} event on ``op``."""
    with _FUSION_LOCK:
        _fusion_sink()[f"{kind}:{op}"] += 1


def fusion_counts() -> dict:
    """Snapshot of the innermost scope of this context, else the global."""
    with _FUSION_LOCK:
        return dict(_fusion_sink())


@contextlib.contextmanager
def fusion_scope():
    """Inside the block the counters start at zero and record only the
    block's events; on exit they fold into the enclosing counters. Yields
    the scope's live Counter."""
    inner = collections.Counter()
    outer_scopes = _FUSION_SCOPES.get()
    token = _FUSION_SCOPES.set(outer_scopes + (inner,))
    try:
        yield inner
    finally:
        _FUSION_SCOPES.reset(token)
        with _FUSION_LOCK:
            (outer_scopes[-1] if outer_scopes else _FUSION_GLOBAL
             ).update(inner)


# ---------------------------------------------------------------------------
# plan metadata
# ---------------------------------------------------------------------------

def _resolve(plan, num_rows: int, num_segments: int,
             config: Optional[KernelConfig], feat: int) -> KernelConfig:
    config, _ = _resolve_plan(plan, num_rows, num_segments, config, None)
    return config if config is not None else default_config(feat)


def _check_plan(plan, num_rows: int, num_segments: int,
                config: Optional[KernelConfig]) -> None:
    """For the row-run kernels, which read no tiling: the plan must fit
    the data and an explicit config must agree with the plan's."""
    _resolve_plan(plan, num_rows, num_segments, config, None)


def _on_device(plan, t) -> None:
    """Refuse a plan whose metadata lies elsewhere than the data: copying
    it would cost a host-to-device transfer on every launch."""
    if plan.device != t.device:
        raise ValueError(
            f"{type(plan).__name__} metadata lies on {plan.device}, the data "
            f"on {t.device}; build the plan with device={str(t.device)!r} "
            "or move it once with plan.to(...)")


def _metadata(plan, seg_idx, num_segments: int, config: KernelConfig):
    """The fused kernel's (chunk_first, chunk_count) on seg_idx's device:
    the plan's, or computed on the device from the padded index (no host
    round trip)."""
    if plan is not None:
        _on_device(plan, seg_idx)
        return plan.chunk_first, plan.chunk_count
    m = int(seg_idx.shape[0])
    m_pad = _round_up(max(m, 1), config.m_b)
    idxp = torch.full((m_pad,), num_segments, dtype=torch.int32,
                      device=seg_idx.device)
    idxp[:m] = seg_idx
    return chunk_metadata(idxp, num_segments, config.s_b, config.m_b, m_pad)


def _row_ptr(plan, seg_idx, num_segments: int):
    """The segments' row offsets on seg_idx's device: the plan's, or
    computed on the device from the index (no host round trip)."""
    if plan is not None:
        _on_device(plan, seg_idx)
        return plan.row_ptr
    return _gsr.row_offsets(_index32(seg_idx), num_segments)


def _index32(t):
    return t if t.dtype == torch.int32 and t.is_contiguous() else \
        t.to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def gather_segment_reduce(h, gather_idx, seg_idx, num_segments: int,
                          weight=None, reduce: str = "sum",
                          config: Optional[KernelConfig] = None, plan=None,
                          impl: Optional[str] = None):
    """Y[s] = reduce_{seg[i]==s} (w[i]·) H[gather_idx[i]], one launch for
    every reduce ∈ {sum, mean, max}, weighted or not. ``seg_idx`` must be
    sorted non-decreasing. ``config`` is only checked against ``plan``: the
    kernel's run length is its own."""
    if reduce not in _gsr.REDUCES:
        raise ValueError(f"unknown reduce: {reduce!r}")
    impl = resolve_impl(h, impl)
    op = ("gather_segment_reduce" if reduce == "sum"
          else f"gather_segment_reduce_{reduce}")
    if weight is not None:
        op += "_weighted"
        weight = weight.to(h.dtype)
    if impl == "ref":
        account("unfused", f"{op}:ref")
        return _gsr.gather_segment_reduce_ref(h, gather_idx, seg_idx,
                                              num_segments, weight, reduce)
    _check_plan(plan, int(seg_idx.shape[0]), num_segments, config)
    row_ptr = _row_ptr(plan, seg_idx, num_segments)
    if impl == "blocked":
        account("unfused", f"{op}:blocked")
        return _gsr.gather_segment_reduce_blocked(
            h, gather_idx, seg_idx, num_segments, weight, reduce, row_ptr)
    account("fused", op)
    return _gsr.gather_segment_reduce_cuda(
        h.contiguous(), _index32(gather_idx), _index32(seg_idx), num_segments,
        None if weight is None else weight.contiguous(), reduce, row_ptr)


def segment_softmax(x, idx, num_segments: int,
                    config: Optional[KernelConfig] = None, plan=None,
                    impl: Optional[str] = None):
    """Softmax within sorted segments, (E,) or (E, H) logits, one launch.
    ``config`` is only checked against ``plan``: the kernel's run length is
    its own."""
    impl = resolve_impl(x, impl)
    if impl == "ref":
        account("unfused", "segment_softmax:ref")
        return _ssm.segment_softmax_ref(x, idx, num_segments)
    _check_plan(plan, int(idx.shape[0]), num_segments, config)
    row_ptr = _row_ptr(plan, idx, num_segments)
    if impl == "blocked":
        account("unfused", "segment_softmax:blocked")
        return _ssm.segment_softmax_blocked(x, idx, num_segments, row_ptr)
    account("fused", "segment_softmax")
    return _ssm.segment_softmax_cuda(x.contiguous(), _index32(idx),
                                     num_segments, row_ptr)


def fused_transform_reduce(h, w, gather_idx, seg_idx, num_segments: int,
                           weight=None, reduce: str = "sum",
                           config: Optional[KernelConfig] = None, plan=None,
                           impl: Optional[str] = None):
    """One-launch SpMM+GEMM: Y[s] = (reduce_{seg[i]==s} wt[i]·H[gidx[i]]) @ W
    for reduce ∈ {sum, mean}; neither the (|E|, d) edge tensor nor the
    (S, d_in) aggregate is materialized."""
    if reduce not in ("sum", "mean"):
        raise ValueError(f"unknown reduce: {reduce!r} "
                         "(fused transform-reduce supports sum/mean)")
    impl = resolve_impl(h, impl, ("cuda", "ref"))
    op = ("fused_transform_reduce" if weight is None
          else "fused_transform_reduce_weighted")
    if weight is not None:
        weight = weight.to(h.dtype)
    if impl == "ref":
        account("unfused", f"{op}:ref")
        return _ftr.fused_transform_reduce_ref(h, w, gather_idx, seg_idx,
                                               num_segments, weight, reduce)
    config = _resolve(plan, int(seg_idx.shape[0]), num_segments, config,
                      int(h.shape[1]))
    cf, cc = _metadata(plan, seg_idx, num_segments, config)
    account("fused", op)
    return _ftr.fused_transform_reduce_cuda(
        h.contiguous(), w.to(h.dtype).contiguous(), _index32(gather_idx),
        _index32(seg_idx), num_segments,
        None if weight is None else weight.contiguous(), reduce, cf, cc,
        config)


def segment_reduce(x, idx, num_segments: int, reduce: str = "sum",
                   config: Optional[KernelConfig] = None, plan=None,
                   impl: Optional[str] = None):
    """Y[s] = reduce_{idx[i]==s} X[i], one launch for reduce ∈ {sum, mean,
    max} (the mean's count lives in the kernel). ``idx`` must be sorted
    non-decreasing. ``config`` is only checked against ``plan``: the
    kernel's run length is its own."""
    if reduce not in _gsr.REDUCES:
        raise ValueError(f"unknown reduce: {reduce!r}")
    impl = resolve_impl(x, impl)
    op = f"segment_reduce_{reduce}"
    if impl == "ref":
        account("unfused", f"{op}:ref")
        return _srd.segment_reduce_ref(x, idx, num_segments, reduce)
    _check_plan(plan, int(idx.shape[0]), num_segments, config)
    row_ptr = _row_ptr(plan, idx, num_segments)
    if impl == "blocked":
        account("unfused", f"{op}:blocked")
        return _srd.segment_reduce_blocked(x, idx, num_segments, reduce,
                                           row_ptr)
    account("fused", op)
    return _srd.segment_reduce_cuda(x.contiguous(), _index32(idx),
                                    num_segments, reduce, row_ptr)


def sddmm(a, b, row_idx, col_idx, impl: Optional[str] = None):
    """out[i] = <A[row_idx[i]], B[col_idx[i]]>, one launch; fp32 products,
    output in ``a.dtype``. An index out of range raises before the launch."""
    impl = resolve_impl(a, impl, ("cuda", "ref"))
    if impl == "ref":
        account("unfused", "sddmm:ref")
        return _sdd.sddmm_ref(a, b, row_idx, col_idx)
    account("fused", "sddmm")
    return _sdd.sddmm_cuda(a.contiguous(), b.contiguous(), _index32(row_idx),
                           _index32(col_idx))


def segment_matmul(x, group_sizes, w, config: Optional[KernelConfig] = None,
                   plan=None, impl: Optional[str] = None):
    """Grouped GEMM over contiguous row groups, one launch for every
    relation: out[rows of g] = X[rows of g] @ W[g]; rows past
    ``sum(group_sizes)`` are 0.

    ``plan`` may be a :class:`~repro_torch.core.plan.RelationPlan`: its
    ``offsets`` / ``first_group`` / ``group_count`` feed the kernel (no
    per-call search) and its config wins; an explicit config must agree on
    (m_b, n_b). A :class:`~repro_torch.core.plan.SegmentPlan` contributes
    its config only. Without a RelationPlan the metadata is computed on
    the device from ``group_sizes``."""
    impl = resolve_impl(x, impl, ("cuda", "ref"))
    if impl == "ref":
        account("unfused", "segment_matmul:ref")
        return _smm.segment_matmul_ref(x, group_sizes, w)
    num_rows, num_groups = int(x.shape[0]), int(w.shape[0])
    if plan is not None and hasattr(plan, "first_group"):
        plan.validate(num_rows, num_groups)
        if config is None:
            config = plan.config
        elif (config.m_b, config.n_b) != (plan.config.m_b, plan.config.n_b):
            raise ValueError(
                f"explicit config (m_b={config.m_b}, n_b={config.n_b}) "
                f"conflicts with RelationPlan tiling "
                f"(m_b={plan.config.m_b}, n_b={plan.config.n_b})")
        _on_device(plan, x)
        meta = (plan.offsets, plan.first_group, plan.group_count)
    else:
        if config is None and plan is not None:
            config = plan.config
        config = config or default_config(int(w.shape[-1]))
        sizes = torch.as_tensor(group_sizes, device=x.device)
        if sizes.shape != (num_groups,):
            raise ValueError(f"group_sizes must be ({num_groups},), got "
                             f"{tuple(sizes.shape)}")
        meta = _smm.group_metadata(sizes, num_rows, config.m_b)
    account("fused", "segment_matmul")
    return _smm.segment_matmul_cuda(x.contiguous(),
                                    w.to(x.dtype).contiguous(), *meta,
                                    config.m_b)

"""Public wrappers around the kernels: backend choice, config resolution,
plan metadata, and launch accounting.

Backend (``impl``):

  * ``None`` — ``"cuda"`` for CUDA tensors, ``"ref"`` for CPU tensors;
  * ``"cuda"`` — the hand-written Hopper kernel; raises on CPU tensors;
  * ``"ref"`` — the plain PyTorch version, on any device (on the card it is
    only ever asked for explicitly, as an oracle);
  * ``"blocked"`` — gather_segment_reduce, segment_reduce,
    segment_softmax, fused_transform_reduce and segment_matmul (its wgmma
    path's work items): their kernels' schedules in plain PyTorch.

There is no fallback: a CUDA tensor reaches the kernel or the call raises.

Each kernel's launch is a ``torch.library`` custom op (namespace
``repro_torch``: ``gather_segment_reduce``, ``segment_reduce``,
``segment_softmax``, ``fused_transform_reduce``, ``segment_matmul``,
``sddmm``), registered for CUDA tensors, with a fake that gives the
output's shape and dtype: a trace under ``FakeTensorMode`` (the dry run,
:mod:`repro_torch.launch.dryrun`) passes through the kernels without
building or launching one. segment_matmul and the fused kernel register
their FLOPs with ``torch.utils.flop_counter`` (2·M·K·N, 2·S·K·N). The
checks before a launch read shapes and dtypes only, except sddmm's index
check (:func:`sddmm`), which reads the indices on the host and is skipped
on fake tensors; backward passes use :func:`sddmm_rows`, which has none.

Config: every kernel reads its axis from ``plan`` > explicit ``config=``
> :func:`~repro_torch.core.config_space.default_config`. The gather and
segment_reduce run in runs of the config's M_b rows, the fused kernel in
tiles of its S_b segments (each launch loads the built instance; a value
with none raises ValueError before the launch and never runs another),
segment_matmul's metadata tiles rows by M_b; the softmax and sddmm read
no axis. A plan's tiling is authoritative and an explicit
config must agree with it. The ``"blocked"`` mirrors run the same run
length and tile. The backward's transposed walks (:func:`transposed_gather`)
run at the default run length: their index is the graph's sources, not the
shape class the forward's config was selected for.
A plan's metadata must lie on the data's device: no call copies it (build
plans with ``device=``, or move one once with ``plan.to``).

Backward roles: :func:`transposed_gather` runs the gather kernel over a
source-order schedule (the scatter of dH as a gather-reduce, with no
atomics) and :func:`sddmm_rows` the sddmm kernel on pairs that are valid
by construction (no host check); the softmax backward's per-segment sum is
:func:`segment_reduce`.

Accounting: each kernel module keeps a plain-int launch counter
(:func:`launch_counts`, :func:`reset_launch_counts`), bumped only where
its kernel launches; the kernels with two paths (segment_matmul, the
gather, sddmm) also count each launch under the path it took
(:func:`path_launch_counts`). :func:`account` / :func:`fusion_scope` record which
kernels (``fused:<op>``) or plain versions (``unfused:<op>:<impl>``) a
block of work ran, so a served step can report what it launched; every
event is also mirrored into the :mod:`repro_torch.obs` registry
(``kernel.launches``, labels kind and op), as the reference's
``account`` does.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import threading
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.core.config_space import KernelConfig, default_config
from repro_torch.kernels import fused_transform_reduce as _ftr
from repro_torch.kernels import gather_segment_reduce as _gsr
from repro_torch.kernels import sddmm as _sdd
from repro_torch.kernels import segment_matmul as _smm
from repro_torch.kernels import segment_reduce as _srd
from repro_torch.kernels import segment_softmax as _ssm

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


# the kernels with two paths, each picked by its module's ``path`` rule
_PATH_MODULES = {"segment_matmul": _smm, "gather_segment_reduce": _gsr,
                 "sddmm": _sdd}


def path_launch_counts() -> dict:
    """{kernel: {path: launches}} since the last reset, for the kernels
    with two paths: segment_matmul (``wgmma``, ``mma_sync``), the gather
    (``runs``, ``owner``) and sddmm (``runs``, ``wide``); each kernel's
    paths sum to its count in :func:`launch_counts`."""
    return {name: dict(mod.path_launches)
            for name, mod in _PATH_MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _KERNEL_MODULES.values():
        mod.launches = 0
    for mod in _PATH_MODULES.values():
        for which in mod.path_launches:
            mod.path_launches[which] = 0


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


_LAUNCH_METRIC = None


def _launch_metric():
    global _LAUNCH_METRIC
    if _LAUNCH_METRIC is None:
        _LAUNCH_METRIC = obs.get_registry().counter(
            "kernel.launches", labels=("kind", "op"),
            help="kernel launch accounting (fused/unfused)")
    return _LAUNCH_METRIC


def account(kind: str, op: str) -> None:
    """Record one ``kind`` ∈ {"fused", "unfused"} event on ``op``."""
    with _FUSION_LOCK:
        _fusion_sink()[f"{kind}:{op}"] += 1
    _launch_metric().inc(kind=kind, op=op)


def fusion_counts() -> dict:
    """Snapshot of the innermost scope of this context, else the global."""
    with _FUSION_LOCK:
        return dict(_fusion_sink())


def fusion_scopes() -> tuple:
    """The fusion scopes active in this context, for :func:`in_fusion_scopes`
    to record into later."""
    return _FUSION_SCOPES.get()


@contextlib.contextmanager
def in_fusion_scopes(scopes: tuple):
    """Inside the block, record into ``scopes`` (from :func:`fusion_scopes`)
    whatever context runs it: the autograd engine runs a CUDA backward on
    a thread of its own, whose context holds no scope, and the ops' backwards
    record into the scopes their forwards ran in. Events recorded after a
    scope has closed stay in that scope's counter."""
    token = _FUSION_SCOPES.set(scopes)
    try:
        yield
    finally:
        _FUSION_SCOPES.reset(token)


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

def _segment_config(plan, num_rows: int, num_segments: int,
                    config: Optional[KernelConfig], feat: int) -> KernelConfig:
    """The config a segment kernel runs: the plan's (which must fit the
    data, and with which an explicit config must agree on (s_b, m_b)),
    else the explicit one, else the default for ``feat``."""
    if plan is None:
        return config if config is not None else default_config(feat)
    plan.validate(num_rows, num_segments)
    if config is not None and \
            (config.s_b, config.m_b) != (plan.config.s_b, plan.config.m_b):
        raise ValueError(
            f"explicit config (s_b={config.s_b}, m_b={config.m_b}) conflicts "
            f"with plan tiling (s_b={plan.config.s_b}, m_b={plan.config.m_b})")
    return plan.config


def _on_device(plan, t) -> None:
    """Refuse a plan whose metadata lies elsewhere than the data: copying
    it would cost a host-to-device transfer on every launch."""
    if plan.device != t.device:
        raise ValueError(
            f"{type(plan).__name__} metadata lies on {plan.device}, the data "
            f"on {t.device}; build the plan with device={str(t.device)!r} "
            "or move it once with plan.to(...)")


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
    sorted non-decreasing. Runs of the config's M_b rows, or, for an input
    of few rows on the card, the owner path, which needs no row offsets
    (:func:`~repro_torch.kernels.gather_segment_reduce.path`)."""
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
    num_rows = int(seg_idx.shape[0])
    m_b = _segment_config(plan, num_rows, num_segments, config,
                          int(h.shape[-1])).m_b
    # the owner path finds each segment's rows itself: without a plan no
    # row offsets are built for it
    owner = impl == "cuda" and _gsr.path(num_rows) == "owner"
    row_ptr = (None if owner and plan is None
               else _row_ptr(plan, seg_idx, num_segments))
    if impl == "blocked":
        account("unfused", f"{op}:blocked")
        return _gsr.gather_segment_reduce_blocked(
            h, gather_idx, seg_idx, num_segments, weight, reduce, row_ptr,
            m_b)
    account("fused", op)
    return _gsr.gather_segment_reduce_cuda(
        h.contiguous(), _index32(gather_idx), _index32(seg_idx), num_segments,
        None if weight is None else weight.contiguous(), reduce, row_ptr, m_b)


def transposed_gather(g, rows, src, row_ptr, num_out: int, weight=None,
                      impl: Optional[str] = None):
    """dH[v] = sum_{i: src[i]==v} (w[i]·) G[rows[i]]: a backward's scatter
    into the source rows, as one gather-reduce over edges sorted by source
    (``src`` non-decreasing, ``row_ptr`` its (num_out + 1,) int64 offsets;
    edges with ``src >= num_out`` are dropped). fp32 sums in a fixed order,
    output in G's dtype; the weight is taken in G's dtype (pass fp32 G and
    an fp32 weight to keep the weight unrounded)."""
    impl = resolve_impl(g, impl)
    op = "transposed_gather" + ("" if weight is None else "_weighted")
    if weight is not None:
        weight = weight.to(g.dtype)
    if impl == "ref":
        account("unfused", f"{op}:ref")
        return _gsr.gather_segment_reduce_ref(g, rows, src, num_out, weight)
    if impl == "blocked":
        account("unfused", f"{op}:blocked")
        return _gsr.gather_segment_reduce_blocked(g, rows, src, num_out,
                                                  weight, "sum", row_ptr)
    account("fused", op)
    return _gsr.gather_segment_reduce_cuda(
        g.contiguous(), _index32(rows), _index32(src), num_out,
        None if weight is None else weight.contiguous(), "sum", row_ptr)


def segment_softmax(x, idx, num_segments: int,
                    config: Optional[KernelConfig] = None, plan=None,
                    impl: Optional[str] = None):
    """Softmax within sorted segments, (E,) or (E, H) logits, one launch.
    ``config`` is only checked against ``plan``: the kernel's run length is
    a constant of its own."""
    impl = resolve_impl(x, impl)
    if impl == "ref":
        account("unfused", "segment_softmax:ref")
        return _ssm.segment_softmax_ref(x, idx, num_segments)
    _segment_config(plan, int(idx.shape[0]), num_segments, config, 1)
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
    (S, d_in) aggregate is materialized. ``seg_idx`` must be sorted
    non-decreasing. Tiles of the config's S_b segments."""
    if reduce not in ("sum", "mean"):
        raise ValueError(f"unknown reduce: {reduce!r} "
                         "(fused transform-reduce supports sum/mean)")
    impl = resolve_impl(h, impl)
    op = ("fused_transform_reduce" if weight is None
          else "fused_transform_reduce_weighted")
    if weight is not None:
        weight = weight.to(h.dtype)
    if impl == "ref":
        account("unfused", f"{op}:ref")
        return _ftr.fused_transform_reduce_ref(h, w, gather_idx, seg_idx,
                                               num_segments, weight, reduce)
    s_b = _segment_config(plan, int(seg_idx.shape[0]), num_segments, config,
                          int(h.shape[-1])).s_b
    row_ptr = _row_ptr(plan, seg_idx, num_segments)
    if impl == "blocked":
        account("unfused", f"{op}:blocked")
        return _ftr.fused_transform_reduce_blocked(
            h, w.to(h.dtype), gather_idx, seg_idx, num_segments, weight,
            reduce, row_ptr, s_b)
    account("fused", op)
    return _ftr.fused_transform_reduce_cuda(
        h.contiguous(), w.to(h.dtype).contiguous(), _index32(gather_idx),
        _index32(seg_idx), num_segments,
        None if weight is None else weight.contiguous(), reduce, row_ptr, s_b)


def segment_reduce(x, idx, num_segments: int, reduce: str = "sum",
                   config: Optional[KernelConfig] = None, plan=None,
                   impl: Optional[str] = None):
    """Y[s] = reduce_{idx[i]==s} X[i], one launch for reduce ∈ {sum, mean,
    max} (the mean's count lives in the kernel). ``idx`` must be sorted
    non-decreasing. Runs of the config's M_b rows."""
    if reduce not in _gsr.REDUCES:
        raise ValueError(f"unknown reduce: {reduce!r}")
    impl = resolve_impl(x, impl)
    op = f"segment_reduce_{reduce}"
    if impl == "ref":
        account("unfused", f"{op}:ref")
        return _srd.segment_reduce_ref(x, idx, num_segments, reduce)
    m_b = _segment_config(plan, int(idx.shape[0]), num_segments, config,
                          int(x.shape[-1])).m_b
    row_ptr = _row_ptr(plan, idx, num_segments)
    if impl == "blocked":
        account("unfused", f"{op}:blocked")
        return _srd.segment_reduce_blocked(x, idx, num_segments, reduce,
                                           row_ptr, m_b)
    account("fused", op)
    return _srd.segment_reduce_cuda(x.contiguous(), _index32(idx),
                                    num_segments, reduce, row_ptr, m_b)


def sddmm(a, b, row_idx, col_idx, impl: Optional[str] = None):
    """out[i] = <A[row_idx[i]], B[col_idx[i]]>, one launch; fp32 products,
    output in ``a.dtype``. On the card A and B are in one dtype; the plain
    version also takes a mix (its products are fp32 either way). An index
    out of range raises before the launch."""
    impl = resolve_impl(a, impl, ("cuda", "ref"))
    if impl == "ref":
        account("unfused", "sddmm:ref")
        return _sdd.sddmm_ref(a, b, row_idx, col_idx)
    if a.dtype != b.dtype:
        raise TypeError(f"sddmm: a and b must have one dtype, got {a.dtype} "
                        f"and {b.dtype}")
    account("fused", "sddmm")
    return _sdd.sddmm_cuda(a.contiguous(), b.contiguous(), _index32(row_idx),
                           _index32(col_idx))


def sddmm_rows(a, b, row_idx, col_idx, impl: Optional[str] = None):
    """:func:`sddmm` for pairs that are valid by construction (a backward's
    real edges): the launch reads them without the host check and its
    sync. B may be bf16 under an fp32 A (a backward's gathered rows in
    their own dtype): the wide path reads it as it is, and for the runs
    path, which reads one dtype, it is widened to A's first."""
    impl = resolve_impl(a, impl, ("cuda", "ref", "blocked"))
    if impl != "cuda":
        account("unfused", f"sddmm:{impl}")
        return _sdd.sddmm_ref(a, b, row_idx, col_idx)
    if _sdd.path(int(a.shape[1]), a.dtype) == "runs":
        b = b.to(a.dtype)
    account("fused", "sddmm")
    return _sdd.sddmm_cuda(a.contiguous(), b.contiguous(), _index32(row_idx),
                           _index32(col_idx), validate=False)


def segment_matmul(x, group_sizes, w, config: Optional[KernelConfig] = None,
                   plan=None, impl: Optional[str] = None,
                   w_transposed: bool = False):
    """Grouped GEMM over contiguous row groups, one launch for every
    relation: out[rows of g] = X[rows of g] @ W[g]; rows past
    ``sum(group_sizes)`` are 0. With ``w_transposed``, ``w`` is (G, N, K)
    and the product is X @ W[g]ᵀ, read in place (the backward's dX).

    ``impl="blocked"`` runs the wgmma path's work items in plain PyTorch
    (:func:`~repro_torch.kernels.segment_matmul.segment_matmul_blocked`).

    ``plan`` may be a :class:`~repro_torch.core.plan.RelationPlan`: its
    ``offsets`` / ``first_group`` / ``group_count`` feed the kernel (no
    per-call search) and its config wins; an explicit config must agree on
    (m_b, n_b). A :class:`~repro_torch.core.plan.SegmentPlan` contributes
    its config only. Without a RelationPlan the metadata is computed on
    the device from ``group_sizes``."""
    impl = resolve_impl(x, impl, ("cuda", "ref", "blocked"))
    if impl == "ref":
        account("unfused", "segment_matmul:ref")
        return _smm.segment_matmul_ref(x, group_sizes, w, w_transposed)
    if impl == "blocked":
        account("unfused", "segment_matmul:blocked")
        return _smm.segment_matmul_blocked(x, group_sizes, w, w_transposed)
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
        config = config or default_config(_smm._out_width(w, w_transposed))
        sizes = torch.as_tensor(group_sizes, device=x.device)
        if sizes.shape != (num_groups,):
            raise ValueError(f"group_sizes must be ({num_groups},), got "
                             f"{tuple(sizes.shape)}")
        if _smm.path_of(x, w, w_transposed) == "wgmma":
            # the offsets only: no row-block schedule to compute
            none = torch.empty(0, dtype=torch.int32, device=x.device)
            meta = (_smm.group_offsets(sizes), none, none)
        else:
            meta = _smm.group_metadata(sizes, num_rows, config.m_b)
    account("fused", "segment_matmul")
    return _smm.segment_matmul_cuda(x.contiguous(),
                                    w.to(x.dtype).contiguous(), *meta,
                                    config.m_b, w_transposed)

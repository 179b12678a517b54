"""GeoT core ops: tensor-centric segment reduction (paper §II-B, §IV).

All ops take plain dense tensors plus index vectors (format-agnostic,
§IV); ``seg_idx`` must be sorted non-decreasing.

``impl`` selects the backend (see :mod:`repro_torch.kernels.ops`):
``None`` picks the CUDA kernel for CUDA tensors and the plain version for
CPU tensors; ``"cuda"`` / ``"ref"`` force one (``"cuda"`` raises on the
CPU). ``config`` / ``plan`` follow plan > config > default where a kernel
tiles by them (segment_matmul); the segment kernels (the gather,
segment_reduce, the softmax, fused_transform_reduce) only check ``config``
against ``plan``.

Every op is a :class:`torch.autograd.Function` whose backward follows the
reference's custom VJP (``repro/core/ops.py``) and runs on the same
kernels as the forwards: a scatter of a gradient into gathered rows is the
gather kernel walking the edges in source order
(:func:`~repro_torch.kernels.ops.transposed_gather`, over the plan's
:class:`~repro_torch.core.plan.SourceOrder` or one sorted on the device),
an edge-weight gradient is the sddmm kernel, the softmax's per-segment sum
is segment_reduce, and the grouped matmul's dX is segment_matmul reading
Wᵀ in place. The reference's rules hold: rows with an out-of-range segment
id get no gradient, tied maxima split it, gradients accumulate in fp32 and
are cast back to the io dtype. Only the gradients ``ctx.needs_input_grad``
asks for are computed.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core.config_space import KernelConfig
from repro_torch.core.plan import SourceOrder, source_order
from repro_torch.kernels import ops as kops
from repro_torch.kernels._build import is_fake

__all__ = [
    "segment_reduce",
    "gather",
    "index_segment_reduce",
    "index_weight_segment_reduce",
    "fused_transform_reduce",
    "segment_softmax",
    "sddmm",
    "grouped_segment_matmul",
    "segment_matmul",
]


# ---------------------------------------------------------------------------
# backward helpers
# ---------------------------------------------------------------------------

def _in_forward_scopes(backward):
    """Run a backward in the fusion scopes its forward noted in
    ``ctx.scopes``, so that the kernels it launches are recorded where the
    forward's are (the autograd engine may run it on another thread)."""
    @functools.wraps(backward)
    def run(ctx, *grads):
        with kops.in_fusion_scopes(ctx.scopes):
            return backward(ctx, *grads)
    return run


def _take0(a, idx, n: int):
    """Rows of ``a`` (n, ...) by ``idx``, 0 where ``idx >= n`` (the
    reference's ``_take0``: dropped rows get no gradient)."""
    guard = torch.zeros((1,) + tuple(a.shape[1:]), dtype=a.dtype,
                        device=a.device)
    return torch.cat([a, guard]).index_select(0, idx.long().clamp_max(n))


def _counts(plan, seg_idx, num_segments: int):
    """Rows per segment in fp32, at least 1, from the plan's row offsets (or
    ones computed on the device)."""
    row_ptr = kops._row_ptr(plan, seg_idx, num_segments)
    return row_ptr.diff().float().clamp_min(1.0)


def _order(plan, gather_idx, seg_idx, num_segments: int,
           num_sources: int) -> SourceOrder:
    """The source order of a backward's scatter: the plan's, when it was
    built for this graph, else sorted on the device."""
    order = None if plan is None else plan.src_order
    if order is None:
        return source_order(gather_idx, seg_idx, num_segments, num_sources)
    if (order.num_sources != num_sources
            or order.perm.shape[0] != gather_idx.shape[0]):
        raise ValueError(
            f"the plan's source order was built for {order.num_sources} "
            f"sources and {order.perm.shape[0]} edges, the op gathers "
            f"{gather_idx.shape[0]} rows of {num_sources}; pass "
            "plan.without_source_order() when the gather index is not the "
            "graph's sources")
    return order


def _num_real(order: SourceOrder, plan, seg_idx, num_segments: int) -> int:
    """Edges whose segment is kept: a prefix of the sorted index. Known on
    the host for a graph plan; else one read of the row offsets. A fake
    trace (shapes, no data: the dry run) reads none and counts every edge
    as kept, the most there can be (and exact where no segment id is
    dropped, as in the MoE combine)."""
    if order.num_real is not None:
        return order.num_real
    row_ptr = kops._row_ptr(plan, seg_idx, num_segments)
    if is_fake(row_ptr):
        return int(seg_idx.shape[0])
    return int(row_ptr[-1])


def _max_edge_grad(msg, y, y_bar, seg_idx, num_segments: int, impl, plan):
    """(E, F) fp32 cotangent of the messages of a max: winners (a message
    equal to its segment's max, in the io dtype the forward rounded to)
    share the segment's cotangent equally (the reference's
    ``_split_ties``)."""
    winner = (msg == _take0(y, seg_idx, num_segments)).float()
    nwin = kops.segment_reduce(winner, seg_idx, num_segments, "sum",
                               plan=plan, impl=impl)
    split = y_bar.float() / nwin.clamp_min(1.0)
    return winner * _take0(split, seg_idx, num_segments)


def _scatter_dh(order: SourceOrder, g, weight, per_edge: bool, impl):
    """dH of an aggregation: G (S, F) per segment, or (E, F) per edge for a
    max, walked in source order with the fp32 edge weight."""
    wt = None if weight is None else weight.float().index_select(
        0, order.perm)
    rows = order.perm if per_edge else order.dst
    return kops.transposed_gather(g, rows, order.src, order.row_ptr,
                                  order.num_sources, wt, impl)


def _edge_dots(g, h, gather_idx, seg_rows, n: int, num_edges: int, impl):
    """dw[i] = <G[seg_rows[i]], H[gather_idx[i]]> for the first ``n`` (the
    kept) edges, 0 for the dropped ones: one sddmm launch in fp32."""
    dw = torch.zeros(num_edges, dtype=torch.float32, device=h.device)
    if n:
        dw[:n] = kops.sddmm_rows(g.float(), h.float(), seg_rows[:n],
                                 gather_idx[:n], impl)
    return dw


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

class _SegmentReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, num_segments, reduce, impl, config, plan):
        ctx.scopes = kops.fusion_scopes()
        y = kops.segment_reduce(x, idx, num_segments, reduce, config=config,
                                plan=plan, impl=impl)
        ctx.args = (num_segments, reduce, impl, plan)
        ctx.save_for_backward(idx, *((x, y) if reduce == "max" else ()))
        return y

    @staticmethod
    @_in_forward_scopes
    def backward(ctx, y_bar):
        if not ctx.needs_input_grad[0]:
            return (None,) * 7
        num_segments, reduce, impl, plan = ctx.args
        idx, *xy = ctx.saved_tensors
        if reduce == "sum":
            dx = _take0(y_bar, idx, num_segments)
        elif reduce == "mean":
            g = y_bar.float() / _counts(plan, idx, num_segments)[:, None]
            dx = _take0(g, idx, num_segments).to(y_bar.dtype)
        else:
            x, y = xy
            dx = _max_edge_grad(x, y, y_bar, idx, num_segments, impl,
                                plan).to(x.dtype)
        return (dx,) + (None,) * 6


def segment_reduce(x, idx, num_segments: int, reduce: str = "sum",
                   impl: Optional[str] = None,
                   config: Optional[KernelConfig] = None, plan=None):
    """Y[s, :] = reduce_{i: idx[i]==s} X[i, :]   (paper Fig. 2), reduce ∈
    {sum, mean, max}; an empty segment is 0, or -inf for max. ``plan``: a
    SegmentPlan over ``idx`` (its metadata on X's device)."""
    return _SegmentReduce.apply(x, idx, num_segments, reduce, impl, config,
                                plan)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, idx, impl):
        ctx.scopes = kops.fusion_scopes()
        if idx.dtype not in (torch.int32, torch.int64):
            idx = idx.long()
        ctx.num_rows = int(h.shape[0])
        ctx.impl = impl
        ctx.save_for_backward(idx)
        return h.index_select(0, idx)

    @staticmethod
    @_in_forward_scopes
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        (idx,) = ctx.saved_tensors
        order = source_order(idx, None, 0, ctx.num_rows)
        return _scatter_dh(order, g, None, True, ctx.impl), None, None


def gather(h, idx, impl: Optional[str] = None):
    """Row gather (the message step of Listing 2): ``h[idx]``. A plain
    ``index_select`` forward, as the reference leaves it to XLA; its
    backward is the reference's sort-then-segment-reduce, on the gather
    kernel for CUDA tensors (deterministic, unlike an atomic scatter;
    ``impl="ref"`` forces its plain version)."""
    return _Gather.apply(h, idx, impl)


class _IndexSegmentReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, gather_idx, seg_idx, num_segments, reduce, impl,
                config, plan):
        ctx.scopes = kops.fusion_scopes()
        y = kops.gather_segment_reduce(h, gather_idx, seg_idx, num_segments,
                                       reduce=reduce, config=config,
                                       plan=plan, impl=impl)
        ctx.args = (num_segments, reduce, impl, plan, tuple(h.shape),
                    h.dtype)
        # only max reads H and Y back
        ctx.save_for_backward(gather_idx, seg_idx,
                              *((h, y) if reduce == "max" else ()))
        return y

    @staticmethod
    @_in_forward_scopes
    def backward(ctx, y_bar):
        if not ctx.needs_input_grad[0]:
            return (None,) * 8
        num_segments, reduce, impl, plan, h_shape, h_dtype = ctx.args
        gather_idx, seg_idx, *hy = ctx.saved_tensors
        order = _order(plan, gather_idx, seg_idx, num_segments, h_shape[0])
        if reduce == "max":
            h, y = hy
            msg = h.index_select(0, gather_idx.long())
            g = _max_edge_grad(msg, y, y_bar, seg_idx, num_segments, impl,
                               plan)
        elif reduce == "mean":
            g = y_bar.float() / _counts(plan, seg_idx, num_segments)[:, None]
        else:
            g = y_bar
        dh = _scatter_dh(order, g, None, reduce == "max", impl)
        return (dh.to(h_dtype),) + (None,) * 7


def index_segment_reduce(h, gather_idx, seg_idx, num_segments: int,
                         reduce: str = "sum", impl: Optional[str] = None,
                         config: Optional[KernelConfig] = None, plan=None):
    """Fused message+aggregate (paper Listing 2, §IV):

        Y[s] = reduce_{i: seg_idx[i]==s} H[gather_idx[i]]

    The (|E|, N) message tensor never exists on the kernel path. A plan
    from :func:`~repro_torch.core.plan.make_graph_plan` carries the source
    order of its graph: ``gather_idx`` must then be that graph's sources."""
    return _IndexSegmentReduce.apply(h, gather_idx, seg_idx, num_segments,
                                     reduce, impl, config, plan)


class _IndexWeightSegmentReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, gather_idx, weight, seg_idx, num_segments, reduce,
                impl, config, plan):
        ctx.scopes = kops.fusion_scopes()
        y = kops.gather_segment_reduce(h, gather_idx, seg_idx, num_segments,
                                       weight=weight, reduce=reduce,
                                       config=config, plan=plan, impl=impl)
        ctx.args = (num_segments, reduce, impl, plan)
        # y only for max's winners: sum and mean pin no (S, F) residual
        ctx.save_for_backward(h, gather_idx, weight, seg_idx,
                              *((y,) if reduce == "max" else ()))
        return y

    @staticmethod
    @_in_forward_scopes
    def backward(ctx, y_bar):
        need_h, _, need_w = ctx.needs_input_grad[:3]
        if not (need_h or need_w):
            return (None,) * 9
        num_segments, reduce, impl, plan = ctx.args
        h, gather_idx, weight, seg_idx, *y = ctx.saved_tensors
        order = _order(plan, gather_idx, seg_idx, num_segments,
                       int(h.shape[0]))
        if reduce == "max":
            # the winners with the forward's own arithmetic: the weight
            # rounded to h's dtype, an fp32 product, the max rounded to h's
            # dtype (so each message is rounded the same way)
            msg = (h.index_select(0, gather_idx.long()).float()
                   * weight.to(h.dtype).float()[:, None]).to(h.dtype)
            g = _max_edge_grad(msg, y[0], y_bar, seg_idx, num_segments, impl,
                               plan)
        elif reduce == "mean":
            g = y_bar.float() / _counts(plan, seg_idx, num_segments)[:, None]
        else:
            g = y_bar.float()
        dh = dw = None
        if need_h:
            dh = _scatter_dh(order, g, weight, reduce == "max",
                             impl).to(h.dtype)
        if need_w:
            n = _num_real(order, plan, seg_idx, num_segments)
            rows = (torch.arange(n, dtype=torch.int32, device=h.device)
                    if reduce == "max" else seg_idx)
            dw = _edge_dots(g, h, gather_idx, rows, n, int(weight.shape[0]),
                            impl).to(weight.dtype)
        return (dh, None, dw) + (None,) * 6


def index_weight_segment_reduce(h, gather_idx, weight, seg_idx,
                                num_segments: int, reduce: str = "sum",
                                impl: Optional[str] = None,
                                config: Optional[KernelConfig] = None,
                                plan=None):
    """Weighted fused message+aggregate (paper §IV):

        Y[s] = reduce_{i: seg_idx[i]==s} w[i] * H[gather_idx[i]]

    With ``reduce="sum"`` this is the SpMM Y = A @ H of the sorted COO
    matrix (seg_idx, gather_idx, w). ``mean`` / ``max`` reduce over the
    weighted messages. The weight's gradient is an SDDMM (paper §VI)."""
    return _IndexWeightSegmentReduce.apply(h, gather_idx, weight, seg_idx,
                                           num_segments, reduce, impl,
                                           config, plan)


class _FusedTransformReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, gather_idx, weight, seg_idx, num_segments, reduce,
                impl, config, plan):
        ctx.scopes = kops.fusion_scopes()
        y = kops.fused_transform_reduce(h, w, gather_idx, seg_idx,
                                        num_segments, weight=weight,
                                        reduce=reduce, config=config,
                                        plan=plan, impl=impl)
        ctx.args = (num_segments, reduce, impl, config, plan)
        ctx.save_for_backward(h, w, gather_idx, weight, seg_idx)
        return y

    @staticmethod
    @_in_forward_scopes
    def backward(ctx, y_bar):
        need_h, need_w, _, need_wt = ctx.needs_input_grad[:4]
        num_segments, reduce, impl, config, plan = ctx.args
        h, w, gather_idx, weight, seg_idx = ctx.saved_tensors
        dh = dw = dwt = None
        if need_w:
            # dW = Agg(H)ᵀ Ȳ: the aggregate the forward never materialized,
            # recomputed by one launch of the gather kernel
            agg = kops.gather_segment_reduce(
                h, gather_idx, seg_idx, num_segments, weight=weight,
                reduce=reduce, config=config, plan=plan, impl=impl)
            dw = (agg.float().T @ y_bar.float()).to(w.dtype)
        if need_h or need_wt:
            g = y_bar.float() @ w.float().T                  # (S, d_in)
            if reduce == "mean":
                g = g / _counts(plan, seg_idx, num_segments)[:, None]
            order = _order(plan, gather_idx, seg_idx, num_segments,
                           int(h.shape[0]))
            if need_h:
                dh = _scatter_dh(order, g, weight, False, impl).to(h.dtype)
            if need_wt:
                n = _num_real(order, plan, seg_idx, num_segments)
                dwt = _edge_dots(g, h, gather_idx, seg_idx, n,
                                 int(weight.shape[0]), impl).to(weight.dtype)
        return (dh, dw, None, dwt) + (None,) * 6


def fused_transform_reduce(h, w, gather_idx, weight, seg_idx,
                           num_segments: int, reduce: str = "sum",
                           impl: Optional[str] = None,
                           config: Optional[KernelConfig] = None, plan=None):
    """Fully-fused transform-aggregate (SpMM+GEMM in one launch):

        Y[s] = ( reduce_{i: seg_idx[i]==s} w_e[i] · H[gather_idx[i]] ) @ W

    Linear reduces only (sum / mean); ``weight=None`` for the unweighted
    form. Gradients, fp32, cast to the io dtypes:

        dW = Agg(H)ᵀ Ȳ              (one recomputed aggregate)
        dH = transposed walk of w_e[i] · (Ȳ Wᵀ)[seg_idx[i]]
        dw_e[i] = <H[gather_idx[i]], (Ȳ Wᵀ)[seg_idx[i]]>   (SDDMM)"""
    return _FusedTransformReduce.apply(h, w, gather_idx, weight, seg_idx,
                                       num_segments, reduce, impl, config,
                                       plan)


class _SegmentSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, num_segments, impl, config, plan):
        ctx.scopes = kops.fusion_scopes()
        p = kops.segment_softmax(x, idx, num_segments, config=config,
                                 plan=plan, impl=impl)
        ctx.args = (num_segments, impl, plan)
        ctx.save_for_backward(p, idx)
        return p

    @staticmethod
    @_in_forward_scopes
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return (None,) * 6
        num_segments, impl, plan = ctx.args
        p, idx = ctx.saved_tensors
        p2 = (p[:, None] if p.dim() == 1 else p).float()
        g2 = (g[:, None] if g.dim() == 1 else g).float()
        # p ⊙ (g − Σ_segment p·g): the per-segment sum on segment_reduce
        t = kops.segment_reduce((p2 * g2).contiguous(), idx, num_segments,
                                "sum", plan=plan, impl=impl)
        dx = (p2 * (g2 - _take0(t, idx, num_segments))).to(p.dtype)
        return (dx.reshape(p.shape),) + (None,) * 5


def segment_softmax(x, idx, num_segments: int, impl: Optional[str] = None,
                    config: Optional[KernelConfig] = None, plan=None):
    """Softmax within segments (GAT-style attention over sorted edges);
    ``x`` is (M,) or (M, H) — heads share the segment structure."""
    return _SegmentSoftmax.apply(x, idx, num_segments, impl, config, plan)


class _Sddmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, row_idx, col_idx, impl):
        ctx.scopes = kops.fusion_scopes()
        ctx.impl = impl
        ctx.save_for_backward(a, b, row_idx, col_idx)
        return kops.sddmm(a, b, row_idx, col_idx, impl=impl)

    @staticmethod
    @_in_forward_scopes
    def backward(ctx, g):
        need_a, need_b = ctx.needs_input_grad[:2]
        a, b, row_idx, col_idx = ctx.saved_tensors
        da = db = None
        # d<a_r, b_c>/da_r = g·b_c: a walk over the pairs sorted by row,
        # gathering rows of B, and symmetrically for b
        for need, idx, other_idx, other, rows in (
                (need_a, row_idx, col_idx, b, a.shape[0]),
                (need_b, col_idx, row_idx, a, b.shape[0])):
            if not need:
                continue
            order = source_order(idx, None, 0, int(rows))
            grad = kops.transposed_gather(
                other.float(), other_idx.index_select(0, order.perm),
                order.src, order.row_ptr, int(rows),
                g.float().index_select(0, order.perm), ctx.impl)
            if idx is row_idx:
                da = grad.to(a.dtype)
            else:
                db = grad.to(b.dtype)
        return da, db, None, None, None


def sddmm(h_out, h_in, row_idx, col_idx, impl: Optional[str] = None,
          config: Optional[KernelConfig] = None, plan=None):
    """Sampled dense-dense matmul: per-pair dot products (paper §VI),
    out[i] = <h_out[row_idx[i]], h_in[col_idx[i]]>, fp32 products, output
    in ``h_out.dtype``. ``config`` / ``plan`` are accepted for symmetry with
    the reduction ops; the kernel is a pure gather and reads neither."""
    return _Sddmm.apply(h_out, h_in, row_idx, col_idx, impl)


def _group_offsets(group_sizes, plan) -> tuple:
    """Row offsets of the groups on the host: the RelationPlan's, else read
    from the sizes (one device-to-host copy for device sizes)."""
    offsets = getattr(plan, "host_offsets", ())
    if offsets:
        return offsets
    sizes = torch.as_tensor(group_sizes).tolist()
    out = [0]
    for n in sizes:
        out.append(out[-1] + int(n))
    return tuple(out)


def _grouped_dw(x, y_bar, group_sizes, plan, w_shape, w_dtype):
    """dW[g] = X[rows g]ᵀ Ȳ[rows g] (rows past the groups give none): a
    loop of fp32 ``torch.matmul`` over the groups on host row offsets (one
    device-to-host read of the sizes without a RelationPlan), into an fp32
    buffer of W's shape, cast to W's dtype. The reference computes dW
    outside any Pallas kernel too (a sorted segment_sum of outer
    products)."""
    off = _group_offsets(group_sizes, plan)
    dw = torch.zeros(w_shape, dtype=torch.float32, device=x.device)
    for grp in range(int(w_shape[0])):
        lo, hi = off[grp], off[grp + 1]
        if hi > lo:
            dw[grp] = x[lo:hi].float().T @ y_bar[lo:hi].float()
    return dw.to(w_dtype)


class _GroupedSegmentMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group_sizes, impl, config, plan):
        ctx.scopes = kops.fusion_scopes()
        ctx.args = (group_sizes, impl, plan)
        ctx.save_for_backward(x, w)
        return kops.segment_matmul(x, group_sizes, w, config=config,
                                   plan=plan, impl=impl)

    @staticmethod
    @_in_forward_scopes
    def backward(ctx, y_bar):
        need_x, need_w = ctx.needs_input_grad[:2]
        group_sizes, impl, plan = ctx.args
        x, w = ctx.saved_tensors
        y_bar = y_bar.to(x.dtype)
        dx = dw = None
        if need_x:
            # one grouped launch with W[g]ᵀ read in place, on the same
            # group schedule; rows past the groups come out 0
            dx = kops.segment_matmul(y_bar, group_sizes, w, plan=plan,
                                     impl=impl, w_transposed=True)
        if need_w:
            dw = _grouped_dw(x, y_bar, group_sizes, plan, w.shape, w.dtype)
        return dx, dw, None, None, None, None


def grouped_segment_matmul(x, group_sizes, w, impl: Optional[str] = None,
                           config: Optional[KernelConfig] = None, plan=None):
    """Grouped GEMM over contiguous row groups (the heterogeneous-GNN and
    MoE operator):

        out[rows of group e] = X[rows of group e] @ W[e]

    x: (M, K) with each group's rows contiguous; group_sizes: (E,) rows per
    group (sum ≤ M); w: (E, K, N). Rows past ``sum(group_sizes)`` are 0 and
    get no gradient. ``plan``: a :class:`~repro_torch.core.plan.RelationPlan`
    whose metadata feeds the kernel (and whose host offsets slice the
    backward's per-group dW)."""
    return _GroupedSegmentMatmul.apply(x, w, group_sizes, impl, config, plan)


def segment_matmul(x, group_sizes, w, impl: Optional[str] = None,
                   config: Optional[KernelConfig] = None, plan=None):
    """Alias of :func:`grouped_segment_matmul` (the reference's MoE name)."""
    return grouped_segment_matmul(x, group_sizes, w, impl, config, plan)

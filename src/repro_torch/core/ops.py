"""GeoT core ops: tensor-centric segment reduction (paper §II-B, §IV).

All ops take plain dense tensors plus index vectors (format-agnostic,
§IV); ``seg_idx`` must be sorted non-decreasing.

``impl`` selects the backend (see :mod:`repro_torch.kernels.ops`):
``None`` picks the CUDA kernel for CUDA tensors and the plain version for
CPU tensors; ``"cuda"`` / ``"ref"`` force one (``"cuda"`` raises on the
CPU). ``config`` / ``plan`` follow plan > config > default where a kernel
tiles by them (fused_transform_reduce, segment_matmul); the row-run kernels
only check ``config`` against ``plan``.

Forward only. Each op is a :class:`torch.autograd.Function` whose backward
raises: the gradient rules of the reference (the custom VJPs of
``repro/core/ops.py``) arrive with the training slice (ROADMAP Queue A
item 7).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.config_space import KernelConfig
from repro_torch.kernels import ops as kops

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


class _ForwardOnly(torch.autograd.Function):
    """The autograd seam of one op: forward runs ``fn``; backward raises
    until the training slice ports the reference's custom VJP."""

    @staticmethod
    def forward(ctx, name, fn, *args):
        ctx.name = name
        return fn(*args)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            f"repro_torch.core.ops.{ctx.name} has no backward yet: the "
            "gradient rules come with the training slice (ROADMAP Queue A "
            "item 7)")


def segment_reduce(x, idx, num_segments: int, reduce: str = "sum",
                   impl: Optional[str] = None,
                   config: Optional[KernelConfig] = None, plan=None):
    """Y[s, :] = reduce_{i: idx[i]==s} X[i, :]   (paper Fig. 2), reduce ∈
    {sum, mean, max}; an empty segment is 0, or -inf for max. ``plan``: a
    SegmentPlan over ``idx`` (its metadata on X's device)."""
    def fn(x, idx):
        return kops.segment_reduce(x, idx, num_segments, reduce,
                                   config=config, plan=plan, impl=impl)
    return _ForwardOnly.apply("segment_reduce", fn, x, idx)


def gather(h, idx):
    """Row gather (the message step of Listing 2): ``h[idx]``. A plain
    ``index_select`` on any device, as the reference leaves it to XLA."""
    def fn(h, idx):
        if idx.dtype not in (torch.int32, torch.int64):
            idx = idx.long()
        return h.index_select(0, idx)
    return _ForwardOnly.apply("gather", fn, h, idx)


def index_segment_reduce(h, gather_idx, seg_idx, num_segments: int,
                         reduce: str = "sum", impl: Optional[str] = None,
                         config: Optional[KernelConfig] = None, plan=None):
    """Fused message+aggregate (paper Listing 2, §IV):

        Y[s] = reduce_{i: seg_idx[i]==s} H[gather_idx[i]]

    The (|E|, N) message tensor never exists on the kernel path."""
    def fn(h, gather_idx, seg_idx):
        return kops.gather_segment_reduce(h, gather_idx, seg_idx,
                                          num_segments, reduce=reduce,
                                          config=config, plan=plan, impl=impl)
    return _ForwardOnly.apply("index_segment_reduce", fn, h, gather_idx,
                              seg_idx)


def index_weight_segment_reduce(h, gather_idx, weight, seg_idx,
                                num_segments: int, reduce: str = "sum",
                                impl: Optional[str] = None,
                                config: Optional[KernelConfig] = None,
                                plan=None):
    """Weighted fused message+aggregate (paper §IV):

        Y[s] = reduce_{i: seg_idx[i]==s} w[i] * H[gather_idx[i]]

    With ``reduce="sum"`` this is the SpMM Y = A @ H of the sorted COO
    matrix (seg_idx, gather_idx, w). ``mean`` / ``max`` reduce over the
    weighted messages."""
    def fn(h, gather_idx, weight, seg_idx):
        return kops.gather_segment_reduce(h, gather_idx, seg_idx,
                                          num_segments, weight=weight,
                                          reduce=reduce, config=config,
                                          plan=plan, impl=impl)
    return _ForwardOnly.apply("index_weight_segment_reduce", fn, h,
                              gather_idx, weight, seg_idx)


def fused_transform_reduce(h, w, gather_idx, weight, seg_idx,
                           num_segments: int, reduce: str = "sum",
                           impl: Optional[str] = None,
                           config: Optional[KernelConfig] = None, plan=None):
    """Fully-fused transform-aggregate (SpMM+GEMM in one launch):

        Y[s] = ( reduce_{i: seg_idx[i]==s} w_e[i] · H[gather_idx[i]] ) @ W

    Linear reduces only (sum / mean); ``weight=None`` for the unweighted
    form."""
    def fn(h, w, gather_idx, weight, seg_idx):
        return kops.fused_transform_reduce(h, w, gather_idx, seg_idx,
                                           num_segments, weight=weight,
                                           reduce=reduce, config=config,
                                           plan=plan, impl=impl)
    return _ForwardOnly.apply("fused_transform_reduce", fn, h, w, gather_idx,
                              weight, seg_idx)


def segment_softmax(x, idx, num_segments: int, impl: Optional[str] = None,
                    config: Optional[KernelConfig] = None, plan=None):
    """Softmax within segments (GAT-style attention over sorted edges);
    ``x`` is (M,) or (M, H) — heads share the segment structure."""
    def fn(x, idx):
        return kops.segment_softmax(x, idx, num_segments, config=config,
                                    plan=plan, impl=impl)
    return _ForwardOnly.apply("segment_softmax", fn, x, idx)


def sddmm(h_out, h_in, row_idx, col_idx, impl: Optional[str] = None,
          config: Optional[KernelConfig] = None, plan=None):
    """Sampled dense-dense matmul: per-pair dot products (paper §VI),
    out[i] = <h_out[row_idx[i]], h_in[col_idx[i]]>, fp32 products, output
    in ``h_out.dtype``. ``config`` / ``plan`` are accepted for symmetry with
    the reduction ops; the kernel is a pure gather and reads neither."""
    def fn(h_out, h_in, row_idx, col_idx):
        return kops.sddmm(h_out, h_in, row_idx, col_idx, impl=impl)
    return _ForwardOnly.apply("sddmm", fn, h_out, h_in, row_idx, col_idx)


def grouped_segment_matmul(x, group_sizes, w, impl: Optional[str] = None,
                           config: Optional[KernelConfig] = None, plan=None):
    """Grouped GEMM over contiguous row groups (the heterogeneous-GNN and
    MoE operator):

        out[rows of group e] = X[rows of group e] @ W[e]

    x: (M, K) with each group's rows contiguous; group_sizes: (E,) rows per
    group (sum ≤ M); w: (E, K, N). Rows past ``sum(group_sizes)`` are 0.
    ``plan``: a :class:`~repro_torch.core.plan.RelationPlan` whose metadata
    feeds the kernel."""
    def fn(x, w):
        return kops.segment_matmul(x, group_sizes, w, config=config,
                                   plan=plan, impl=impl)
    return _ForwardOnly.apply("grouped_segment_matmul", fn, x, w)


def segment_matmul(x, group_sizes, w, impl: Optional[str] = None,
                   config: Optional[KernelConfig] = None, plan=None):
    """Alias of :func:`grouped_segment_matmul` (the reference's MoE name)."""
    return grouped_segment_matmul(x, group_sizes, w, impl, config, plan)

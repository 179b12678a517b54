"""GeoT core ops: tensor-centric segment reduction (paper §II-B, §IV).

All ops take plain dense tensors plus index vectors (format-agnostic,
§IV); ``seg_idx`` must be sorted non-decreasing.

``impl`` selects the backend (see :mod:`repro_torch.kernels.ops`):
``None`` picks the CUDA kernel for CUDA tensors and the plain version for
CPU tensors; ``"cuda"`` / ``"ref"`` force one (``"cuda"`` raises on the
CPU). ``config`` / ``plan`` follow plan > config > default.

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
    "index_segment_reduce",
    "index_weight_segment_reduce",
    "fused_transform_reduce",
    "segment_softmax",
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

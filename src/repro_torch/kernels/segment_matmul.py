"""Grouped (segment) matmul — one launch for every relation:

    out[rows of group g, :] = X[rows of group g, :] @ W[g]

``X`` (M, K) is sorted so each group's rows are contiguous (typed-edge
messages in (type, dst) order); ``group_sizes`` (G,) counts them; ``W`` is
(G, K, N). Rows past ``sum(group_sizes)`` belong to no group and come out
0. Products accumulate in fp32; the output is in the io dtype of ``X``.

  * :func:`segment_matmul_cuda` — the hand-written Hopper kernel
    (``csrc/segment_matmul.cu``; its note says what bounds it and how the
    design answers). Replaces the TPU kernel
    ``repro/kernels/segment_matmul.py:segment_matmul_pallas``.
  * :func:`segment_matmul_ref` — the plain PyTorch version: one fp32 slice
    matmul per group.
  * :func:`group_metadata` — the per-row-block group schedule both the
    per-call path and :class:`~repro_torch.core.plan.RelationPlan` use.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels.gather_segment_reduce import DTYPE_CODE

launches = 0    # launches of the CUDA kernel in this process


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def group_metadata(group_sizes, num_rows: int, m_b: int):
    """Per-row-block group schedule: ``(offsets, first_group,
    group_count)`` int32 tensors on ``group_sizes``' device.

    * ``offsets`` (G+1,) — cumulative row offsets per group;
    * ``first_group`` (m_blocks,) — the group owning each M_b-row block's
      first row;
    * ``group_count`` (m_blocks,) — how many groups the block overlaps
      (0 for blocks made only of rows past ``num_rows``).

    The integers of the reference's formula, computed with
    ``torch.searchsorted`` where the sizes lie."""
    sizes = torch.as_tensor(group_sizes)
    dev = sizes.device
    e = int(sizes.shape[0])
    offsets = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                         torch.cumsum(sizes.to(torch.int32), 0,
                                      dtype=torch.int32)])
    m_blocks = _round_up(max(num_rows, 1), m_b) // m_b
    starts = torch.arange(m_blocks, dtype=torch.int32, device=dev) * m_b
    ends = torch.clamp_max(starts + (m_b - 1), num_rows - 1)
    fg = torch.clamp(torch.searchsorted(offsets, starts, right=True) - 1,
                     0, e - 1)
    lg = torch.clamp(torch.searchsorted(offsets, ends, right=True) - 1,
                     0, e - 1)
    gc = torch.where(starts >= num_rows, torch.zeros_like(fg), lg - fg + 1)
    return offsets, fg.to(torch.int32), gc.to(torch.int32)


def segment_matmul_ref(x, group_sizes, w):
    """The plain version: per group, an fp32 matmul of its row slice, cast
    to the io dtype; rows past ``sum(group_sizes)`` are 0."""
    out = torch.zeros((x.shape[0], w.shape[-1]), dtype=torch.float32,
                      device=x.device)
    start = 0
    for g, n in enumerate(torch.as_tensor(group_sizes).tolist()):
        if n > 0:
            out[start:start + n] = x[start:start + n].float() @ w[g].float()
        start += n
    return out.to(x.dtype)


def segment_matmul_cuda(x, w, offsets, first_group, group_count, m_b: int):
    """Launch the Hopper kernel on the current stream (asynchronous).
    ``offsets`` / ``first_group`` / ``group_count`` are
    :func:`group_metadata` for ``x``'s rows and ``m_b``, on x's device.
    The launch is the ``repro_torch::segment_matmul`` op."""
    if not x.is_cuda:
        raise ValueError(f"segment_matmul: impl='cuda' needs CUDA tensors, "
                         f"got x on {x.device}")
    if x.dtype not in DTYPE_CODE:
        raise TypeError(f"segment_matmul: io dtype must be float32 or "
                        f"bfloat16, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("segment_matmul: x must be a contiguous 2-D tensor")
    num_rows, k_dim = (int(d) for d in x.shape)
    if (w.device != x.device or w.dtype != x.dtype or w.dim() != 3
            or w.shape[1] != k_dim or not w.is_contiguous()):
        raise ValueError(f"segment_matmul: w must be a contiguous (G, "
                         f"{k_dim}, N) {x.dtype} tensor on {x.device}")
    num_groups, n_dim = int(w.shape[0]), int(w.shape[2])
    m_blocks = _round_up(max(num_rows, 1), m_b) // m_b
    for label, t, n in (("offsets", offsets, num_groups + 1),
                        ("first_group", first_group, m_blocks),
                        ("group_count", group_count, m_blocks)):
        if (t.device != x.device or t.dtype != torch.int32
                or t.shape != (n,) or not t.is_contiguous()):
            raise ValueError(f"segment_matmul: {label} must be a contiguous "
                             f"({n},) int32 tensor on {x.device}")
    return torch.ops.repro_torch.segment_matmul(x, w, offsets, first_group,
                                                group_count, m_b)


@torch.library.custom_op("repro_torch::segment_matmul", mutates_args=(),
                         device_types="cuda")
def _launch(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
            first_group: torch.Tensor, group_count: torch.Tensor,
            m_b: int) -> torch.Tensor:
    """The launch, for inputs :func:`segment_matmul_cuda` checked."""
    global launches
    num_rows, k_dim = (int(d) for d in x.shape)
    num_groups, n_dim = int(w.shape[0]), int(w.shape[2])
    if num_rows == 0 or k_dim == 0 or n_dim == 0 or num_groups == 0:
        return torch.zeros((num_rows, n_dim), dtype=x.dtype, device=x.device)
    out = torch.empty((num_rows, n_dim), dtype=x.dtype, device=x.device)
    lib = _build.load("segment_matmul")
    with torch.cuda.device(x.device):
        err = lib.smm_launch(
            DTYPE_CODE[x.dtype], _build.ptr(x), _build.ptr(w),
            _build.ptr(offsets), _build.ptr(first_group),
            _build.ptr(group_count), _build.ptr(out), num_rows, k_dim, n_dim,
            num_groups, m_b, _build.stream_of(x))
    _build.check(err, "segment_matmul")
    launches += 1
    return out


@_launch.register_fake
def _(x, w, offsets, first_group, group_count, m_b):
    return x.new_empty((x.shape[0], w.shape[2]))


@register_flop_formula(torch.ops.repro_torch.segment_matmul)
def _flops(x_shape, w_shape, *args, out_shape=None, **kwargs) -> int:
    """2·M·K·N: every row of X times its group's (K, N) weight, as the flop
    counter counts ``torch.matmul``."""
    return 2 * x_shape[0] * x_shape[1] * w_shape[2]

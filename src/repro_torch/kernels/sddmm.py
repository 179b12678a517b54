"""Sampled dense-dense matmul (paper §VI) — per-pair dot products:

    out[i] = < A[row_idx[i], :], B[col_idx[i], :] >      i ∈ [0, M)

No sortedness is required (a pure gather). Products are fp32; the output is
in ``A``'s dtype.

  * :func:`sddmm_cuda` — the hand-written Hopper kernel (``csrc/sddmm.cu``).
    Replaces the TPU kernel ``repro/kernels/sddmm.py:sddmm_pallas``.
  * :func:`sddmm_ref` — the plain PyTorch version.

An index outside ``[0, rows)`` raises on the host before the launch (the
TPU kernel pads a guard row; the CUDA kernel has none).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gather_segment_reduce import DTYPE_CODE

launches = 0    # launches of the CUDA kernel in this process


def sddmm_ref(a, b, row_idx, col_idx):
    """The plain version: fp32 row products summed, cast to ``a.dtype``."""
    prod = (a.index_select(0, row_idx.long()).float()
            * b.index_select(0, col_idx.long()).float())
    return prod.sum(-1).to(a.dtype)


def check_indices(row_idx, col_idx, rows_a: int, rows_b: int) -> None:
    """Raise unless every index lies in its operand's rows (one host sync).
    Fake tensors (a trace for shapes) hold no indices to check."""
    if row_idx.numel() == 0 or _build.is_fake(row_idx):
        return
    lo_r, hi_r, lo_c, hi_c = torch.stack(
        [row_idx.min(), row_idx.max(), col_idx.min(), col_idx.max()]).tolist()
    if lo_r < 0 or hi_r >= rows_a or lo_c < 0 or hi_c >= rows_b:
        raise ValueError(
            f"sddmm: row_idx spans [{lo_r}, {hi_r}] for {rows_a} rows of A, "
            f"col_idx [{lo_c}, {hi_c}] for {rows_b} rows of B")


def sddmm_cuda(a, b, row_idx, col_idx, validate: bool = True):
    """Check shapes and every index, then launch the Hopper kernel on the
    current stream (the launch itself is asynchronous). A caller whose
    pairs are valid by construction passes ``validate=False`` to skip
    the index check and its host sync."""
    if not a.is_cuda:
        raise ValueError(f"sddmm: impl='cuda' needs CUDA tensors, got a on "
                         f"{a.device}")
    if a.dtype not in DTYPE_CODE:
        raise TypeError(f"sddmm: io dtype must be float32 or bfloat16, got "
                        f"{a.dtype}")
    for label, t in (("a", a), ("b", b)):
        if (t.device != a.device or t.dtype != a.dtype or t.dim() != 2
                or t.shape[1] != a.shape[1] or not t.is_contiguous()):
            raise ValueError(f"sddmm: {label} must be a contiguous (rows, "
                             f"{a.shape[1]}) {a.dtype} tensor on {a.device}")
    m = int(row_idx.shape[0])
    for label, t in (("row_idx", row_idx), ("col_idx", col_idx)):
        if (t.device != a.device or t.dtype != torch.int32
                or t.shape != (m,) or not t.is_contiguous()):
            raise ValueError(f"sddmm: {label} must be a contiguous ({m},) "
                             f"int32 tensor on {a.device}")
    if validate:
        check_indices(row_idx, col_idx, int(a.shape[0]), int(b.shape[0]))
    return sddmm_launch(a, b, row_idx, col_idx)


def sddmm_launch(a, b, row_idx, col_idx):
    """The launch alone, for inputs :func:`sddmm_cuda` has checked (it
    reads the indices unchecked; timing uses it to keep the check's host
    sync out of the kernel's time): the ``repro_torch::sddmm`` op."""
    return torch.ops.repro_torch.sddmm(a, b, row_idx, col_idx)


@torch.library.custom_op("repro_torch::sddmm", mutates_args=(),
                         device_types="cuda")
def _launch(a: torch.Tensor, b: torch.Tensor, row_idx: torch.Tensor,
            col_idx: torch.Tensor) -> torch.Tensor:
    global launches
    m, n = int(row_idx.shape[0]), int(a.shape[1])
    if m == 0 or n == 0:
        return torch.zeros(m, dtype=a.dtype, device=a.device)
    out = torch.empty(m, dtype=a.dtype, device=a.device)
    lib = _build.load("sddmm")
    with torch.cuda.device(a.device):
        err = lib.sddmm_launch(DTYPE_CODE[a.dtype], _build.ptr(a),
                               _build.ptr(b), _build.ptr(row_idx),
                               _build.ptr(col_idx), _build.ptr(out), m, n,
                               _build.stream_of(a))
    _build.check(err, "sddmm")
    launches += 1
    return out


@_launch.register_fake
def _(a, b, row_idx, col_idx):
    return a.new_empty((row_idx.shape[0],))

"""Sampled dense-dense matmul (paper §VI) — per-pair dot products:

    out[i] = < A[row_idx[i], :], B[col_idx[i], :] >      i ∈ [0, M)

No sortedness is required (a pure gather). Products are fp32; the output is
in ``A``'s dtype.

  * :func:`sddmm_cuda` — the hand-written Hopper kernels (``csrc/sddmm.cu``)
    behind one op. Replace the TPU kernel
    ``repro/kernels/sddmm.py:sddmm_pallas``. Two paths, picked by
    :func:`path` from the row width and dtype alone:
      - ``"wide"``: rows of more than WIDE_MIN_BYTES (the MoE combine's
        router-weight gradient, F = 2048) — a warp a short run of pairs,
        every pair's B row in flight at once (``sddmm_wide_launch``); B may
        be bf16 under an fp32 A;
      - ``"runs"``: narrower rows (the GNN's F = 64) — a group of 8 lanes a
        run of 32 pairs (``sddmm_launch``), A and B in one dtype.
  * :func:`sddmm_ref` — the plain PyTorch version.

An index outside ``[0, rows)`` raises on the host before the launch (the
TPU kernel pads a guard row; the CUDA kernel has none).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gather_segment_reduce import DTYPE_CODE

launches = 0    # launches of the CUDA kernels in this process, one a call
# the same launches by path (:func:`path`)
path_launches = {"runs": 0, "wide": 0}

# rows of more bytes than this take the wide path. The runs kernel keeps a
# pair's rows in one stretch of 8 lanes up to 512 bytes (128 fp32, 256
# bf16) and walks wider rows stretch by stretch (csrc/sddmm.cu's note).
# Measured (python -m repro_torch.kernel_variants --kernels sddmm; NVIDIA
# H100 80GB HBM3, 700.00 W), runs / wide ms: on ogbn-arxiv's 1,166,243
# dst-sorted pairs fp32 F = 64 (256 bytes) 0.0692 / 0.1120, F = 128 (512)
# 0.1710 / 0.1487; bf16 F = 192 (384) 0.1284 / 0.1541, F = 256 (512)
# 0.1784 / 0.1660; on the MoE combine's 16,384 token-sorted pairs the
# wide path wins at every width (F = 64 fp32 0.0148 / 0.0066, F = 2048
# 0.3647 / 0.0548). With many pairs the paths cross between 384 and 512
# bytes a row in both dtypes; the rule, which sees the width alone, takes
# that crossing, and keeps the GNN's F = 64 on the runs kernel
WIDE_MIN_BYTES = 384


def path(n: int, dtype) -> str:
    """Which kernel a launch takes: ``"wide"`` where a row of ``n``
    elements of A's ``dtype`` holds more than :data:`WIDE_MIN_BYTES`,
    else ``"runs"``. A pure function of the shape: never a reaction to a
    build or launch error."""
    return "wide" if n * dtype.itemsize > WIDE_MIN_BYTES else "runs"


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
    """Check shapes and every index, then launch the Hopper kernel that
    :func:`path` picks on the current stream (the launch itself is
    asynchronous). B is in A's dtype or, on the wide path, bf16 under an
    fp32 A. A caller whose pairs are valid by construction passes
    ``validate=False`` to skip the index check and its host sync."""
    if not a.is_cuda:
        raise ValueError(f"sddmm: impl='cuda' needs CUDA tensors, got a on "
                         f"{a.device}")
    if a.dtype not in DTYPE_CODE:
        raise TypeError(f"sddmm: io dtype must be float32 or bfloat16, got "
                        f"{a.dtype}")
    b_dtypes = ((a.dtype, torch.bfloat16)
                if path(int(a.shape[1]), a.dtype) == "wide" else (a.dtype,))
    for label, t, dtypes in (("a", a, (a.dtype,)), ("b", b, b_dtypes)):
        if (t.device != a.device or t.dtype not in dtypes or t.dim() != 2
                or t.shape[1] != a.shape[1] or not t.is_contiguous()):
            raise ValueError(f"sddmm: {label} must be a contiguous (rows, "
                             f"{a.shape[1]}) "
                             + " or ".join(str(d)[6:] for d in dtypes)
                             + f" tensor on {a.device}")
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
    which = path(n, a.dtype)
    with torch.cuda.device(a.device):
        out = c_entry(which, a, b, row_idx, col_idx)
    launches += 1
    path_launches[which] += 1
    return out


def c_entry(which: str, a, b, row_idx, col_idx, lib=None):
    """One call of path ``which``'s C entry (``sddmm_wide_launch`` or
    ``sddmm_launch``) on the current stream, from ``lib`` (a loaded
    ``sddmm`` library; the built one by default): the output. It takes the
    inputs as given (int32 indices, contiguous rows, at least one pair)
    and counts no launch: the op's launch, and a timing of a path beside
    the other on the same inputs, both go through it."""
    m, n = int(row_idx.shape[0]), int(a.shape[1])
    out = torch.empty(m, dtype=a.dtype, device=a.device)
    lib = lib or _build.load("sddmm")
    ptrs = (_build.ptr(a), _build.ptr(b), _build.ptr(row_idx),
            _build.ptr(col_idx), _build.ptr(out), m, n, _build.stream_of(a))
    if which == "wide":
        err = lib.sddmm_wide_launch(DTYPE_CODE[a.dtype], DTYPE_CODE[b.dtype],
                                    *ptrs)
    else:
        err = lib.sddmm_launch(DTYPE_CODE[a.dtype], *ptrs)
    _build.check(err, f"sddmm ({which})")
    return out


@_launch.register_fake
def _(a, b, row_idx, col_idx):
    return a.new_empty((row_idx.shape[0],))

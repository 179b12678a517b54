"""Softmax within sorted segments (GAT attention, §VI):

    out[i, :] = exp(x[i] - m[seg[i]]) / max(z[seg[i]], 1e-20)
    m[s] = max_{seg[i]==s} x[i],   z[s] = Σ_{seg[i]==s} exp(x[i] - m[s])

for (E,) or (E, H) logits. Rows with ``seg >= num_segments`` come out
exactly 0: a later weighted sum multiplies by them, so garbage there could
poison real outputs.

A max that is not finite counts as 0, so a segment whose logits are all
``-inf`` comes out 0 (the JAX ``impl="ref"`` rule).

  * :func:`segment_softmax_cuda` — the hand-written Hopper kernel
    (``csrc/segment_softmax.cu``; its note says what bounds it and how the
    design answers). Replaces the TPU kernel
    ``repro/kernels/segment_softmax.py:_segment_softmax_impl``.
  * :func:`segment_softmax_ref` — the plain PyTorch version (fp32 max,
    exp, sum, normalize; cast at the end).
  * :func:`segment_softmax_blocked` — the kernel's schedule in plain
    PyTorch: runs of :data:`RUN_ROWS` rows that normalise the segments
    lying wholly inside them and keep a (max, sum-exp) partial of the cut
    ones, the partials folded in run order over the plan's row offsets,
    then the cut segments' rows normalised.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gather_segment_reduce import DTYPE_CODE, check_row_ptr

# rows of one run of the kernel's schedule: the constant RUN of
# csrc/segment_softmax.cu, which the launch checks against this copy
RUN_ROWS = 128

launches = 0    # wrapper launches in this process (each is three kernels)


def _finite_or_0(m):
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def segment_softmax_ref(x, idx, num_segments: int):
    """The plain version, (E,) or (E, H) logits."""
    squeeze = x.dim() == 1
    x2 = (x[:, None] if squeeze else x).float()
    heads = x2.shape[1]
    seg = idx.long().clamp_max(num_segments)        # guard row for drops
    m = torch.full((num_segments + 1, heads), float("-inf"),
                   dtype=torch.float32, device=x.device)
    m = m.scatter_reduce_(0, seg[:, None].expand(-1, heads), x2, "amax",
                          include_self=True)
    m = _finite_or_0(m)
    e = torch.exp(x2 - m.index_select(0, seg))
    z = torch.zeros((num_segments + 1, heads), dtype=torch.float32,
                    device=x.device).index_add_(0, seg, e)
    out = e / z.index_select(0, seg).clamp_min(1e-20)
    out = torch.where((idx < num_segments)[:, None], out,
                      torch.zeros_like(out)).to(x.dtype)
    return out[:, 0] if squeeze else out


def segment_softmax_blocked(x, idx, num_segments: int, row_ptr,
                            run_rows: int = RUN_ROWS):
    """The CUDA kernel's row-run schedule in plain PyTorch, (E,) or (E, H)
    logits. Pass 1: the rows are cut into runs of ``run_rows`` (the
    kernel's, unless a test asks for shorter runs to cut more segments at a
    small size); each run takes each of its segments' max m and sum-exp z
    over its rows, writes a segment that lies wholly inside it as
    ``exp(x - m) / max(z, 1e-20)`` and dropped rows as 0, and keeps (m, z)
    as a partial (slot 0: the segment of the run's first row, slot 1: that
    of its last row) if the run's ends cut it. Pass 2, per cut segment from
    ``row_ptr``: the partials fold in run order, m = max m_k and z = sum of
    z_k·exp(m_k − m). Pass 3 normalises the cut segments' rows with the
    folded pair. Elements no pass writes stay NaN, so a test sees them."""
    squeeze = x.dim() == 1
    x2 = (x[:, None] if squeeze else x).float()
    num_rows, heads = int(x2.shape[0]), int(x2.shape[1])
    out = torch.full_like(x2, float("nan"))
    rp = row_ptr.tolist()
    partial = {}
    for run in range((num_rows + run_rows - 1) // run_rows):
        r0, r1 = run * run_rows, min((run + 1) * run_rows, num_rows)
        seg = idx[r0:r1].long()
        keep = seg < num_segments        # sorted: a prefix of the run
        out[r0:r1][~keep] = 0.0
        if not bool(keep.any()):
            continue
        n = int(keep.sum())
        lo = int(seg[0])
        local = seg[:n] - lo
        xs = x2[r0:r0 + n]
        width = int(local[-1]) + 1
        m = torch.full((width, heads), float("-inf"),
                       device=x.device).scatter_reduce_(
            0, local[:, None].expand(-1, heads), xs, "amax", include_self=True)
        e = torch.exp(xs - _finite_or_0(m)[local])
        z = torch.zeros((width, heads), device=x.device).index_add_(0, local,
                                                                     e)
        for s in torch.unique_consecutive(seg[:n]).tolist():
            a, b = rp[s], rp[s + 1]
            if a < r0 or b > r1:
                partial[(run, 0 if s == lo else 1)] = (m[s - lo], z[s - lo])
            else:
                out[a:b] = e[a - r0:b - r0] / z[s - lo].clamp_min(1e-20)
    for s in range(num_segments):
        a, b = rp[s], rp[s + 1]
        if a == b or a // run_rows == (b - 1) // run_rows:
            continue
        ka, kb = a // run_rows, (b - 1) // run_rows
        parts = [partial[(ka, 0 if a == ka * run_rows else 1)]] + \
            [partial[(k, 0)] for k in range(ka + 1, kb + 1)]
        m = parts[0][0]
        for mk, _ in parts[1:]:
            m = torch.maximum(m, mk)
        mf = _finite_or_0(m)
        z = torch.zeros(heads, device=x.device)
        for mk, zk in parts:
            z = z + zk * torch.exp(mk - mf)
        out[a:b] = torch.exp(x2[a:b] - mf) / z.clamp_min(1e-20)
    out = out.to(x.dtype)
    return out[:, 0] if squeeze else out


def segment_softmax_cuda(x, idx, num_segments: int, row_ptr):
    """Launch the Hopper kernel on the current stream (asynchronous): three
    kernels (the runs, the fold of the cut segments, their rows), counted
    as one launch. ``row_ptr`` is the segments' int64 row offsets on x's
    device (the plan's). The launch is the ``repro_torch::segment_softmax``
    op."""
    if not x.is_cuda:
        raise ValueError(f"segment_softmax: impl='cuda' needs CUDA tensors, "
                         f"got x on {x.device}")
    if x.dtype not in DTYPE_CODE:
        raise TypeError(f"segment_softmax: io dtype must be float32 or "
                        f"bfloat16, got {x.dtype}")
    if x.dim() not in (1, 2) or not x.is_contiguous():
        raise ValueError("segment_softmax: x must be a contiguous (E,) or "
                         "(E, H) tensor")
    num_rows = int(x.shape[0])
    if (idx.device != x.device or idx.dtype != torch.int32
            or idx.shape != (num_rows,) or not idx.is_contiguous()):
        raise ValueError(f"segment_softmax: idx must be a contiguous "
                         f"({num_rows},) int32 tensor on {x.device}")
    check_row_ptr("segment_softmax", row_ptr, num_segments, x.device)
    return torch.ops.repro_torch.segment_softmax(x, idx, num_segments,
                                                 row_ptr)


@torch.library.custom_op("repro_torch::segment_softmax", mutates_args=(),
                         device_types="cuda")
def _launch(x: torch.Tensor, idx: torch.Tensor, num_segments: int,
            row_ptr: torch.Tensor) -> torch.Tensor:
    """The launch, for inputs :func:`segment_softmax_cuda` checked."""
    global launches
    num_rows = int(x.shape[0])
    heads = 1 if x.dim() == 1 else int(x.shape[1])
    # every element is written by the kernel, dropped rows as 0
    out = torch.empty_like(x)
    if num_rows == 0 or heads == 0:
        return out
    runs = (num_rows + RUN_ROWS - 1) // RUN_ROWS
    part = torch.empty((runs, 2, 2, heads), dtype=torch.float32,
                       device=x.device)
    lib = _build.load("segment_softmax")
    with torch.cuda.device(x.device):
        err = lib.ssm_launch(
            DTYPE_CODE[x.dtype], _build.ptr(x), _build.ptr(idx),
            _build.ptr(row_ptr), _build.ptr(part), _build.ptr(out), num_rows,
            heads, num_segments, RUN_ROWS, _build.stream_of(x))
    _build.check(err, "segment_softmax")
    launches += 1
    return out


@_launch.register_fake
def _(x, idx, num_segments, row_ptr):
    return torch.empty_like(x)

"""Softmax within sorted segments (GAT attention, §VI):

    out[i, :] = exp(x[i] - m[seg[i]]) / max(z[seg[i]], 1e-20)
    m[s] = max_{seg[i]==s} x[i],   z[s] = Σ_{seg[i]==s} exp(x[i] - m[s])

for (E,) or (E, H) logits. Rows with ``seg >= num_segments`` come out
exactly 0: a later weighted sum multiplies by them, so garbage there could
poison real outputs.

  * :func:`segment_softmax_cuda` — the hand-written Hopper kernel
    (``csrc/segment_softmax.cu``). Replaces the TPU kernel
    ``repro/kernels/segment_softmax.py:_segment_softmax_impl``.
  * :func:`segment_softmax_ref` — the plain PyTorch version (fp32 max,
    exp, sum, normalize; cast at the end).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gather_segment_reduce import DTYPE_CODE

launches = 0    # launches of the CUDA kernel in this process


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
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(x2 - m.index_select(0, seg))
    z = torch.zeros((num_segments + 1, heads), dtype=torch.float32,
                    device=x.device).index_add_(0, seg, e)
    out = e / z.index_select(0, seg).clamp_min(1e-20)
    out = torch.where((idx < num_segments)[:, None], out,
                      torch.zeros_like(out)).to(x.dtype)
    return out[:, 0] if squeeze else out


def segment_softmax_cuda(x, idx, num_segments: int, chunk_first, chunk_count,
                         s_b: int, m_b: int):
    """Launch the Hopper kernel on the current stream (asynchronous)."""
    global launches
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
    for label, t in (("idx", idx), ("chunk_first", chunk_first),
                     ("chunk_count", chunk_count)):
        if (t.device != x.device or t.dtype != torch.int32 or t.dim() != 1
                or not t.is_contiguous()):
            raise ValueError(f"segment_softmax: {label} must be a contiguous "
                             f"int32 1-D tensor on {x.device}")
    if idx.shape[0] != num_rows:
        raise ValueError("segment_softmax: idx and x disagree on E")
    out_blocks = (num_segments + s_b - 1) // s_b
    if chunk_first.shape[0] != out_blocks or chunk_count.shape[0] != out_blocks:
        raise ValueError(f"plan metadata has {chunk_first.shape[0]} blocks, "
                         f"expected {out_blocks}")
    heads = 1 if x.dim() == 1 else int(x.shape[1])
    # zero-filled: rows of dropped segments belong to no window
    out = torch.zeros_like(x)
    if num_segments == 0 or num_rows == 0 or heads == 0:
        return out
    lib = _build.load("segment_softmax")
    with torch.cuda.device(x.device):
        err = lib.ssm_launch(
            DTYPE_CODE[x.dtype], _build.ptr(x), _build.ptr(idx),
            _build.ptr(chunk_first), _build.ptr(chunk_count), _build.ptr(out),
            num_rows, heads, num_segments, s_b, m_b, out_blocks,
            _build.stream_of(x))
    _build.check(err, "segment_softmax")
    launches += 1
    return out

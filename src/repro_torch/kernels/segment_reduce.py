"""Chunk metadata shared by every segment kernel of the port.

Each output block ``b`` owns segment ids ``[b·S_b, (b+1)·S_b)``. Because
the segment index is sorted, the rows feeding block ``b`` form one
contiguous range; ``chunk_metadata`` maps ``b`` to the range of ``M_b``-row
chunks that covers it. Chunks shared with a neighbouring block are read by
both, and each block skips the rows outside its window, so no atomics are
needed.

The standalone segment-reduce kernel itself is not ported yet (see
ROADMAP Queue B); only the helpers every ported kernel consumes live here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.config_space import KernelConfig


def chunk_metadata(idx, num_segments: int, s_b: int, m_b: int, m_pad: int):
    """Per-output-block chunk range over the padded row space.

    ``idx`` is the padded sorted segment index (a tensor on any device, or a
    numpy array, read in place as a CPU tensor). Returns ``(chunk_first,
    chunk_count)`` int32 tensors of shape (out_blocks,) on ``idx``'s device:
    block b reads row chunks ``[chunk_first[b], chunk_first[b] +
    chunk_count[b])``.
    """
    idx = torch.as_tensor(idx)
    out_blocks = (num_segments + s_b - 1) // s_b
    bounds = torch.arange(out_blocks + 1, dtype=idx.dtype,
                          device=idx.device) * s_b
    row_bound = torch.searchsorted(idx, bounds, side="left").to(torch.int32)
    lo, hi = row_bound[:-1], row_bound[1:]
    chunk_first = lo // m_b
    last = torch.maximum(hi - 1, lo) // m_b
    chunk_count = torch.where(hi > lo, last - chunk_first + 1,
                              torch.zeros_like(lo))
    return chunk_first.to(torch.int32), chunk_count.to(torch.int32)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _resolve_plan(plan, num_rows: int, num_segments: int,
                  config: Optional[KernelConfig],
                  max_chunks: Optional[int]):
    """Merge an optional SegmentPlan into (config, max_chunks).

    The plan's config wins when none is given explicitly; an explicit config
    must agree on the tiling the metadata was built for (s_b, m_b)."""
    if plan is None:
        return config, max_chunks
    plan.validate(num_rows, num_segments)
    if config is None:
        config = plan.config
    elif (config.s_b, config.m_b) != (plan.config.s_b, plan.config.m_b):
        raise ValueError(
            f"explicit config (s_b={config.s_b}, m_b={config.m_b}) conflicts "
            f"with plan tiling (s_b={plan.config.s_b}, m_b={plan.config.m_b})")
    if max_chunks is None:
        max_chunks = plan.max_chunks
    return config, max_chunks

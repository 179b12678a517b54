"""Tunable hierarchical tiling space (paper §III-A/B, Table I) on Hopper.

The paper's GPU parameters, as the port's CUDA kernels read them:

    T_M  (segments per thread group)  →  S_b  segments owned by one CUDA block
    M_t  (rows per thread group)      →  M_b  rows per chunk of the plan
    N_t  (columns per thread group)   →  N_b  feature columns per block tile
    schedule (SR / PR)                →  the sequential walk; a PR request
                                         runs the same walk on Hopper

In the one window kernel left (fused transform-reduce) a block owns
segments ``[b·S_b, (b+1)·S_b)`` and reads its rows from the chunk range
the :class:`~repro_torch.core.plan.SegmentPlan` assigns it. The gather,
segment_reduce and softmax kernels read none of this tiling: they split
the rows into runs of a fixed length of their own (``csrc/row_runs.cuh``,
``csrc/segment_softmax.cu``) and fold the segments their runs cut in run
order from the plan's row offsets. Either way no atomics are needed and
the result is deterministic.

Hopper limits: 227 KB (232,448 B) of shared memory per block, warps of 32
threads. Measured config selection (PerfDB, decision-tree rules) is not
part of this package yet; :func:`default_config` is a fixed default.
"""
from __future__ import annotations

import dataclasses

SMEM_BYTES = 232_448        # dynamic shared memory one block may use
WARP = 32                   # threads per warp

# The kernels carry an *io dtype* (the dtype of x / weights / outputs in
# device memory) orthogonal to the accumulator dtype, which is always fp32.
IO_DTYPES = ("float32", "bfloat16")

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def _io_dtype_name(dtype) -> str:
    """'float32' for torch.float32, np.float32, np.dtype, 'float32', ..."""
    if isinstance(dtype, str):
        return dtype
    name = str(dtype)
    if name.startswith("torch."):
        return name[len("torch."):]
    import numpy as np
    return np.dtype(dtype).name


def io_dtype_bytes(dtype) -> int:
    """Bytes per element of an io dtype (name, torch dtype or np.dtype)."""
    name = _io_dtype_name(dtype)
    if name in _DTYPE_BYTES:
        return _DTYPE_BYTES[name]
    import numpy as np
    return int(np.dtype(name).itemsize)


def canonical_io_dtype(dtype) -> str:
    """Canonical string name for the io dtype axis ('float32', 'bfloat16')."""
    return _io_dtype_name(dtype)


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """A point in the tunable space ⟨schedule, S_b, N_b, M_b, K_c⟩."""
    schedule: str = "SR"    # "SR" (sequential walk) | "PR" (same walk here)
    s_b: int = 128          # segments owned by one block
    n_b: int = 128          # feature columns per block tile
    m_b: int = 256          # rows per chunk of the plan
    k_c: int = 8            # contraction sub-chunk (PR only; SR ⇒ 1)

    def __post_init__(self):
        if self.schedule == "SR":
            object.__setattr__(self, "k_c", 1)

    def astuple(self):
        return (self.schedule, self.s_b, self.n_b, self.m_b, self.k_c)


# Tunable op keys: every kernel a selection tier may be asked about (the
# same keys as the reference package, so measured databases line up).
OP_KEYS = (
    "segment_reduce",
    "gather_segment_reduce",
    "gather_segment_reduce_mean",
    "gather_segment_reduce_max",
    "segment_softmax",
    "segment_matmul",
    "grouped_segment_matmul",
    "sddmm",
    "fused_transform_reduce",
)


def default_config(feat_dim: int = 128) -> KernelConfig:
    """The fixed Hopper default: small ownership windows (S_b = 32) so a
    large graph gives thousands of blocks to fill 132 SMs, and short
    chunks (M_b = 64) so a block reads few rows of its neighbours'
    windows. N_b is the feature width rounded up to a warp, at most 256
    threads per block."""
    n_b = min(256, _round_up(max(int(feat_dim), 1), WARP))
    return KernelConfig("SR", 32, n_b, 64, 1)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m

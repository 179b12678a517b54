"""Tunable hierarchical tiling space (paper §III-A/B, Table I) on Hopper.

What a :class:`KernelConfig` means to the port's CUDA kernels:

    M_t  (rows per thread group)      →  M_b  rows per run of the row-run
                                         kernels: the gather and
                                         segment_reduce (``RUN`` of
                                         ``csrc/row_runs.cuh``)
    T_M  (segments per thread group)  →  S_b  segments per tile of the fused
                                         transform-reduce (``TILE`` of
                                         ``csrc/fused_transform_reduce.cu``)
    schedule (SR / PR)                →  ``"SR"`` only: a PR request ran the
                                         same walk on Hopper, so the lattice
                                         emits no PR point
    N_t  (columns per thread group)   →  N_b  the feature width rounded up
                                         to a warp, at most 256; read by no
                                         kernel (segment_matmul's metadata
                                         tiles rows by M_b)
    G_t  (synced threads)             →  K_c  = 1, read by no kernel

Each kernel is built once for every value of its axis (:data:`RUN_LENGTHS`,
:data:`TILE_SIZES`; the launch picks the instance at run time and refuses
any other value), so a selected config reaches the card without a rebuild.
The values are those a sweep of build-time variants found worth keeping
on the H100 (``python -m repro_torch.kernel_variants``, PERF.md): at most
three an axis. The softmax, sddmm and segment_matmul
read no axis of a config (their run lengths and tiles stay constants).

Hopper limits: 227 KB (232,448 B) of shared memory per block, warps of 32
threads. A lattice point whose fused block (W resident, the tile's
aggregate, slots and output stage at width F → F) does not fit is pruned
(:func:`enumerate_configs`, with the ``smem_bytes`` that ``fusable``
checks). :func:`default_config` is the shipped values, M_b = 64, S_b = 64
(the hand-crafted tier); the selection tiers are in
:mod:`repro_torch.core.heuristics`.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator, List

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
# same keys as the reference package, so measured databases line up), and
# the axis of a config each one's kernel reads (None: it reads none).
OP_AXIS = {
    "segment_reduce": "m_b",
    "gather_segment_reduce": "m_b",
    "gather_segment_reduce_mean": "m_b",
    "gather_segment_reduce_max": "m_b",
    "segment_softmax": None,
    "segment_matmul": None,
    "grouped_segment_matmul": None,
    "sddmm": None,
    "fused_transform_reduce": "s_b",
}
OP_KEYS = tuple(OP_AXIS)


# The built instances of each axis: the row-run kernels' run lengths
# (FOR_RUN_LENGTHS in csrc/row_runs.cuh) and the fused kernel's tiles
# (FOR_TILES in csrc/fused_transform_reduce.cu).
RUN_LENGTHS = (64, 128, 256)
TILE_SIZES = (32, 64, 128)
SCHEDULES = ("SR",)
DEFAULT_M_B, DEFAULT_S_B = 64, 64


def _n_b(feat_dim) -> int:
    return min(256, _round_up(max(int(feat_dim), 1), WARP))


def enumerate_configs(feat_dim: "int | None" = None,
                      dtype="float32") -> Iterator[KernelConfig]:
    """Every lattice point M_b ∈ :data:`RUN_LENGTHS` × S_b ∈
    :data:`TILE_SIZES` at width ``feat_dim`` (None: 128) whose fused block
    at ``feat_dim`` → ``feat_dim`` in ``dtype`` fits a Hopper block. At a
    width where no tile fits, the fused kernel never runs and S_b is the
    default alone."""
    from repro_torch.kernels.fused_transform_reduce import smem_bytes
    f = 128 if feat_dim is None else max(int(feat_dim), 1)
    tiles = [t for t in TILE_SIZES if smem_bytes(f, f, dtype, t) <= SMEM_BYTES]
    for m_b, s_b in itertools.product(RUN_LENGTHS, tiles or [DEFAULT_S_B]):
        yield KernelConfig("SR", s_b, _n_b(f), m_b, 1)


def all_configs(feat_dim: "int | None" = None) -> List[KernelConfig]:
    return list(enumerate_configs(feat_dim))


def default_config(feat_dim: int = 128) -> KernelConfig:
    """The shipped values (the hand-crafted tier): M_b = 64 rows a run,
    S_b = 64 segments a tile, N_b the feature width rounded up to a warp,
    at most 256."""
    return KernelConfig("SR", DEFAULT_S_B, _n_b(feat_dim), DEFAULT_M_B, 1)


def rule_config(s_b: int, m_b: int, log2_feat: float) -> KernelConfig:
    """A generated rule's leaf at width 2**log2_feat: its S_b, or the
    largest built tile below it whose fused block fits at F → F (the
    default where none does), and its M_b."""
    from repro_torch.kernels.fused_transform_reduce import smem_bytes
    f = max(int(round(2.0 ** log2_feat)), 1)
    fits = [t for t in TILE_SIZES
            if t <= s_b and smem_bytes(f, f, "float32", t) <= SMEM_BYTES]
    return KernelConfig("SR", max(fits) if fits else DEFAULT_S_B, _n_b(f),
                        m_b, 1)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m

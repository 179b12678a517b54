"""Grouped (segment) matmul — one launch for every relation:

    out[rows of group g, :] = X[rows of group g, :] @ W[g]

``X`` (M, K) is sorted so each group's rows are contiguous (typed-edge
messages in (type, dst) order); ``group_sizes`` (G,) counts them; ``W`` is
(G, K, N), or (G, N, K) read transposed (``w_transposed``: the backward's
dX multiplies by W[g]ᵀ without copying it). Rows past ``sum(group_sizes)``
belong to no group and come out 0. Products accumulate in fp32; the output
is in the io dtype of ``X``.

  * :func:`segment_matmul_cuda` — the hand-written Hopper kernels of
    ``csrc/segment_matmul.cu`` (its note says what bounds them and how
    the design answers), behind one op. Replace the TPU kernel
    ``repro/kernels/segment_matmul.py:segment_matmul_pallas``. Two paths,
    picked by :func:`path` from dtype, shape and alignment alone:
      - ``"wgmma"``: bf16 rows that TMA can describe, N of TC_MIN_N or
        more (the MoE experts) — group-aligned work items scheduled on the
        device from the offsets, operands by TMA into a ring of stages,
        products on ``wgmma`` (``smm_tc_launch``);
      - ``"mma_sync"``: everything else (fp32 with the 3xTF32 split, the
        narrow typed outputs, bf16 rows of an odd width) — row tiles
        spanning groups, on ``mma.sync`` (``smm_launch``).
  * :func:`segment_matmul_blocked` — the wgmma path's schedule in plain
    PyTorch: the same work items (:func:`work_items`), each in fp32.
  * :func:`segment_matmul_ref` — the plain PyTorch version: one fp32 slice
    matmul per group.
  * :func:`group_metadata` — the per-row-block group schedule the
    mma_sync path and :class:`~repro_torch.core.plan.RelationPlan` use.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels.gather_segment_reduce import DTYPE_CODE

launches = 0    # launches of the op's CUDA kernels in this process, one a call
# the same launches by path (:func:`path`)
path_launches = {"wgmma": 0, "mma_sync": 0}

# the wgmma path's tile, as csrc/segment_matmul.cu has it: rows and columns
# of a work item; at most TC_MAX_GROUPS groups (their offsets and item
# prefix live in shared memory); N below TC_MIN_N goes to mma_sync, which
# is faster at those narrow outputs (csrc/segment_matmul.cu's note)
TC_BM, TC_BN = 128, 128
TC_MAX_GROUPS = 1024
TC_MIN_N = 64


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


def group_offsets(group_sizes):
    """The (G + 1,) int32 row offsets of the groups, on the sizes' device:
    all the wgmma path reads (three small launches, where
    :func:`group_metadata` takes a dozen)."""
    sizes = torch.as_tensor(group_sizes)
    return torch.cat([torch.zeros(1, dtype=torch.int32, device=sizes.device),
                      torch.cumsum(sizes, 0, dtype=torch.int32)])


def _out_width(w, w_transposed: bool) -> int:
    return int(w.shape[1] if w_transposed else w.shape[2])


def _w_of(w, g: int, w_transposed: bool):
    """W[g] as the (K, N) factor of the product."""
    return w[g].T if w_transposed else w[g]


def segment_matmul_ref(x, group_sizes, w, w_transposed: bool = False):
    """The plain version: per group, an fp32 matmul of its row slice, cast
    to the io dtype; rows past ``sum(group_sizes)`` are 0."""
    out = torch.zeros((x.shape[0], _out_width(w, w_transposed)),
                      dtype=torch.float32, device=x.device)
    start = 0
    for g, n in enumerate(torch.as_tensor(group_sizes).tolist()):
        if n > 0:
            out[start:start + n] = (x[start:start + n].float()
                                    @ _w_of(w, g, w_transposed).float())
        start += n
    return out.to(x.dtype)


def path(dtype, num_rows: int, k_dim: int, n_dim: int, num_groups: int,
         aligned: bool = True) -> str:
    """Which kernel a launch takes: ``"wgmma"`` for bf16 rows that TMA can
    describe (K and N multiples of 8, 16-byte-aligned bases), N at least
    TC_MIN_N, at most TC_MAX_GROUPS groups and an item list that int32
    counts; else ``"mma_sync"``. A pure function of dtype, shape and
    alignment: never a reaction to a build or launch error."""
    if (dtype != torch.bfloat16 or not aligned or k_dim % 8 or n_dim % 8
            or n_dim < TC_MIN_N or not 0 < num_groups <= TC_MAX_GROUPS
            or item_bound(num_rows, n_dim, num_groups) >= 2 ** 31):
        return "mma_sync"
    return "wgmma"


def item_bound(num_rows: int, n_dim: int, num_groups: int,
               bm: int = TC_BM, bn: int = TC_BN) -> int:
    """The static bound on the wgmma path's work items that sizes its grid:
    (ceil(M / bm) + G) x ceil(N / bn) — each of the G groups and the rows
    past them adds at most one partial row tile."""
    return (-(-num_rows // bm) + num_groups) * -(-n_dim // bn)


def work_items(offsets, num_rows: int, n_dim: int, bm: int = TC_BM,
               bn: int = TC_BN) -> list:
    """The wgmma path's work items, in the kernel's order: ``(seg, row0,
    rows, n0)`` for segment ``seg`` (a group, or ``G``: the rows past
    ``offsets[G]``), rows ``[row0, row0 + rows)`` (row tiles start at the
    segment's first row, so none straddles a group), columns ``[n0, n0 +
    bn)``. Segments in order; within one, column tile then row tile, the
    row tile fastest. ``offsets``: the G + 1 row offsets (host values; the
    kernel reads them on the device)."""
    off = [min(max(int(o), 0), num_rows)
           for o in torch.as_tensor(offsets).tolist()] + [num_rows]
    items = []
    for seg in range(len(off) - 1):
        rows = off[seg + 1] - off[seg]
        tiles = -(-max(rows, 0) // bm)
        for n0 in range(0, n_dim, bn):
            for rt in range(tiles):
                items.append((seg, off[seg] + rt * bm,
                              min(bm, rows - rt * bm), n0))
    return items


def segment_matmul_blocked(x, group_sizes, w, w_transposed: bool = False,
                           bm: int = TC_BM, bn: int = TC_BN):
    """The wgmma path's schedule in plain PyTorch: each work item of
    :func:`work_items` in fp32 (the rows past the groups written as 0 by
    items that read no W), cast to the io dtype."""
    sizes = torch.as_tensor(group_sizes).to(torch.int64)
    num_rows, num_groups = int(x.shape[0]), int(w.shape[0])
    n_dim = _out_width(w, w_transposed)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64),
                         torch.cumsum(sizes.cpu(), 0)])
    out = torch.empty((num_rows, n_dim), dtype=torch.float32,
                      device=x.device)
    for seg, row0, rows, n0 in work_items(offsets, num_rows, n_dim, bm, bn):
        cols = slice(n0, min(n0 + bn, n_dim))
        if seg == num_groups:
            out[row0:row0 + rows, cols] = 0.0
        else:
            out[row0:row0 + rows, cols] = (
                x[row0:row0 + rows].float()
                @ _w_of(w, seg, w_transposed)[:, cols].float())
    return out.to(x.dtype)


def segment_matmul_cuda(x, w, offsets, first_group, group_count, m_b: int,
                        w_transposed: bool = False):
    """Launch the Hopper kernel that :func:`path` picks, on the current
    stream (asynchronous). ``offsets`` / ``first_group`` / ``group_count``
    are :func:`group_metadata` for ``x``'s rows and ``m_b``, on x's device;
    the wgmma path reads ``offsets`` only, and takes any (say, empty)
    ``first_group`` and ``group_count``. ``w``: (G, K, N), or (G, N, K)
    with ``w_transposed`` (out = X @ W[g]ᵀ). The launch is the
    ``repro_torch::segment_matmul`` op."""
    if not x.is_cuda:
        raise ValueError(f"segment_matmul: impl='cuda' needs CUDA tensors, "
                         f"got x on {x.device}")
    if x.dtype not in DTYPE_CODE:
        raise TypeError(f"segment_matmul: io dtype must be float32 or "
                        f"bfloat16, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("segment_matmul: x must be a contiguous 2-D tensor")
    num_rows, k_dim = (int(d) for d in x.shape)
    k_at = 2 if w_transposed else 1
    if (w.device != x.device or w.dtype != x.dtype or w.dim() != 3
            or w.shape[k_at] != k_dim or not w.is_contiguous()):
        want = f"(G, N, {k_dim})" if w_transposed else f"(G, {k_dim}, N)"
        raise ValueError(f"segment_matmul: w must be a contiguous {want} "
                         f"{x.dtype} tensor on {x.device}")
    num_groups = int(w.shape[0])
    m_blocks = _round_up(max(num_rows, 1), m_b) // m_b
    checks = [("offsets", offsets, num_groups + 1)]
    if path_of(x, w, w_transposed) == "mma_sync":   # the row-block schedule
        checks += [("first_group", first_group, m_blocks),
                   ("group_count", group_count, m_blocks)]
    for label, t, n in checks:
        if (t.device != x.device or t.dtype != torch.int32
                or t.shape != (n,) or not t.is_contiguous()):
            raise ValueError(f"segment_matmul: {label} must be a contiguous "
                             f"({n},) int32 tensor on {x.device}")
    return torch.ops.repro_torch.segment_matmul(x, w, offsets, first_group,
                                                group_count, m_b,
                                                bool(w_transposed))


def path_of(x, w, w_transposed: bool = False) -> str:
    """:func:`path` for tensors ``x`` and ``w`` (fake ones, which have no
    address, count as aligned, as the allocator's are)."""
    aligned = _build.is_fake(x) or (x.data_ptr() % 16 == 0
                                    and w.data_ptr() % 16 == 0)
    return path(x.dtype, int(x.shape[0]), int(x.shape[1]),
                _out_width(w, w_transposed), int(w.shape[0]), aligned)


@torch.library.custom_op("repro_torch::segment_matmul", mutates_args=(),
                         device_types="cuda")
def _launch(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
            first_group: torch.Tensor, group_count: torch.Tensor,
            m_b: int, w_transposed: bool = False) -> torch.Tensor:
    """The launch, for inputs :func:`segment_matmul_cuda` checked."""
    global launches
    num_rows, k_dim = (int(d) for d in x.shape)
    num_groups, n_dim = int(w.shape[0]), _out_width(w, w_transposed)
    if num_rows == 0 or k_dim == 0 or n_dim == 0 or num_groups == 0:
        return torch.zeros((num_rows, n_dim), dtype=x.dtype, device=x.device)
    out = torch.empty((num_rows, n_dim), dtype=x.dtype, device=x.device)
    lib = _build.load("segment_matmul")
    which = path_of(x, w, w_transposed)
    with torch.cuda.device(x.device):
        if which == "wgmma":
            err = lib.smm_tc_launch(
                _build.ptr(x), _build.ptr(w), _build.ptr(offsets),
                _build.ptr(out), num_rows, k_dim, n_dim, num_groups,
                0 if w_transposed else 1, _build.stream_of(x))
        else:
            # mma_sync reads W as (G, K, N) only
            wk = w.transpose(1, 2).contiguous() if w_transposed else w
            err = lib.smm_launch(
                DTYPE_CODE[x.dtype], _build.ptr(x), _build.ptr(wk),
                _build.ptr(offsets), _build.ptr(first_group),
                _build.ptr(group_count), _build.ptr(out), num_rows, k_dim,
                n_dim, num_groups, m_b, _build.stream_of(x))
    _build.check(err, f"segment_matmul ({which})")
    launches += 1
    path_launches[which] += 1
    return out


@_launch.register_fake
def _(x, w, offsets, first_group, group_count, m_b, w_transposed=False):
    return x.new_empty((x.shape[0], _out_width(w, w_transposed)))


@register_flop_formula(torch.ops.repro_torch.segment_matmul)
def _flops(x_shape, w_shape, offsets_shape=None, first_group_shape=None,
           group_count_shape=None, m_b=None, w_transposed=False,
           out_shape=None, **kwargs) -> int:
    """2·M·K·N: every row of X times its group's (K, N) weight, as the flop
    counter counts ``torch.matmul``; N is ``w_shape[1]`` when W is read
    transposed."""
    return 2 * x_shape[0] * x_shape[1] * w_shape[1 if w_transposed else 2]

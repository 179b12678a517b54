"""Hand-scheduled collectives on ``torch.distributed``, the port of
``repro/distributed/collectives.py``.

Every rank of a process group calls the same function with its own
tensor (SPMD, one process a shard), where the reference runs inside
``shard_map`` over named mesh axes; a ``group`` (``None``: the default
group) takes the place of an axis name.

  ring_allreduce     chunked ring reduce-scatter then all-gather by
                     point-to-point hops to the next rank, the reference's
                     schedule and order of sums (so the result is bitwise
                     the reference's ring on the same inputs).
  ring_psum_matmul   local partial matmul, then ring_allreduce.
  hierarchical_psum  reduce-scatter in the data group (the fast link),
                     all-reduce across pods (the thin link), all-gather
                     back: the cross-pod hop moves 1/|data| of the bytes.
  compressed_psum    hierarchical_psum with int8 error-feedback
                     compression on the pod hop (the arithmetic of
                     :mod:`repro_torch.optim.compression`, with a scale
                     shared across pods by one scalar max all-reduce).

:func:`pod_data_groups` builds the 2-D (pod × data) layout of ranks
(rank = pod · |data| + data) from ``dist.new_group``. The gloo backend
sends no CUDA tensor point to point, so the ring's hops go through host
copies there; NCCL sends them from the card.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["ring_allreduce", "ring_psum_matmul", "make_ring_matmul",
           "hierarchical_psum", "compressed_psum", "pod_data_groups",
           "route_all_gather"]

_ROUTED: dict = {}       # dispatch key -> the torch.library that routes it


def route_all_gather(dispatch_key: str = "CUDA") -> None:
    """Run the functional all-gather (``_c10d_functional.
    all_gather_into_tensor`` and its coalesced form: DTensor's Shard →
    Replicate, the FSDP gathers) on ``dispatch_key`` tensors as c10d's
    synchronous ``all_gather_into_tensor`` on the same group.

    On the card the sharded LM steps run four gloo ranks on one H100
    (NCCL refuses two ranks on one device). gloo moves CUDA tensors for
    c10d's all-gather, all-reduce and reduce-scatter (through host memory,
    inside gloo), but its functional all-gather on CUDA tensors ends the
    process (SIGSEGV on torch 2.11); the functional all-reduce and
    reduce-scatter work. Installed once a process; the result is the same
    tensor either way."""
    if dispatch_key in _ROUTED:
        return
    from torch.distributed import distributed_c10d as c10d

    def gather(inp, group_size, group_name):
        pg = c10d._resolve_process_group(group_name)
        inp = inp.contiguous()
        out = inp.new_empty((group_size * inp.shape[0],) + inp.shape[1:])
        dist.all_gather_into_tensor(out, inp, group=pg)
        return out

    def gather_coalesced(inputs, group_size, group_name):
        return [gather(t, group_size, group_name) for t in inputs]

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", gather, dispatch_key)
    lib.impl("all_gather_into_tensor_coalesced", gather_coalesced,
             dispatch_key)
    _ROUTED[dispatch_key] = lib


def _global_rank(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def _shift_up(x, group):
    """Send ``x`` to the next rank of the group and return what the
    previous one sent (one hop of the ring)."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    host = x.is_cuda and dist.get_backend(group) == "gloo"
    send = (x.cpu() if host else x).contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, _global_rank(group, (rank + 1) % n),
                      group),
           dist.P2POp(dist.irecv, recv, _global_rank(group, (rank - 1) % n),
                      group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(x.device) if host else recv


def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    out = x.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def ring_allreduce(y, group=None):
    """Chunked ring all-reduce of ``y`` (the sum over the group's ranks).
    Falls back to ``all_reduce`` when the leading dim does not split
    evenly."""
    n = dist.get_world_size(group)
    if n == 1:
        return y
    m = y.shape[0]
    if m % n != 0:
        return _all_reduce(y, group)
    rank = dist.get_rank(group)
    bufs = list(y.reshape(n, m // n, *y.shape[1:]).unbind(0))
    for step in range(n - 1):
        # rank r adds the chunk it receives into its own copy
        recv = _shift_up(bufs[(rank - step) % n], group)
        idx = (rank - step - 1) % n
        bufs[idx] = recv + bufs[idx]
    # rank r now holds the reduced chunk (r + 1) mod n
    for step in range(n - 1):
        recv = _shift_up(bufs[(rank + 1 - step) % n], group)
        bufs[(rank - step) % n] = recv
    return torch.stack(bufs).reshape(y.shape)


def ring_psum_matmul(x_local, w_local, group=None):
    """sum over ranks of ``x_p @ w_p``, the sum ring-scheduled.

    x_local: (m, k_local); w_local: (k_local, n)."""
    return ring_allreduce(x_local @ w_local, group)


def make_ring_matmul(group=None):
    """The ring matmul over the group's ranks for replicated ``x`` (m, K)
    and ``w`` (K, n): each rank takes its 1/|group| slice of K (the
    reference's k-sharded ``in_specs``); the result is replicated."""
    def fn(x, w):
        n, rank = dist.get_world_size(group), dist.get_rank(group)
        k = x.shape[1]
        if k % n or w.shape[0] != k:
            raise ValueError(f"K={k} must split over {n} ranks and match "
                             f"w's {w.shape[0]} rows")
        lo, hi = rank * (k // n), (rank + 1) * (k // n)
        return ring_psum_matmul(x[:, lo:hi], w[lo:hi], group)
    return fn


def _reduce_scatter(x, group):
    """The rank's 1/|group| row slice of the sum of ``x`` over the group."""
    chunks = [c.contiguous() for c in x.chunk(dist.get_world_size(group))]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    return out


def _all_gather_rows(x, group):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def hierarchical_psum(x, pod_group, data_group):
    """Reduce-scatter in the data group, all-reduce across pods, all-gather
    in the data group: the sum over (pod, data), with the cross-pod hop
    moving 1/|data| of the bytes."""
    if x.shape[0] % dist.get_world_size(data_group) == 0:
        scat = _all_reduce(_reduce_scatter(x, data_group), pod_group)
        return _all_gather_rows(scat, data_group)
    return _all_reduce(_all_reduce(x, data_group), pod_group)


def compressed_psum(x, ef, pod_group, data_group):
    """:func:`hierarchical_psum` with int8 error-feedback compression on
    the cross-pod hop. ``ef`` lives at the reduce-scattered shape (x's
    rows / |data|). Returns (reduced, new_error_feedback)."""
    if x.shape[0] % dist.get_world_size(data_group) != 0:
        return _all_reduce(_all_reduce(x, data_group), pod_group), ef
    # one scalar max across pods: every pod quantizes with the same scale,
    # so the int8 payloads sum exactly
    v = _reduce_scatter(x, data_group).float() + ef
    absmax = _all_reduce(v.abs().max(), pod_group, dist.ReduceOp.MAX)
    scale = absmax.clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)
    new_ef = v - q.float() * scale
    qsum = _all_reduce(q.to(torch.int32), pod_group)
    return _all_gather_rows(qsum.float() * scale, data_group), new_ef


def pod_data_groups(num_pods: int, num_data: int):
    """(pod group, data group) of this rank in a ``num_pods × num_data``
    layout of the default group's ranks (rank = pod · num_data + data).
    Every rank must call it, in the same order as its other
    ``new_group`` calls."""
    world = dist.get_world_size()
    if world != num_pods * num_data:
        raise ValueError(f"a {num_pods}x{num_data} layout needs "
                         f"{num_pods * num_data} ranks, the group has {world}")
    rank = dist.get_rank()
    data_groups = [dist.new_group([p * num_data + d for d in range(num_data)])
                   for p in range(num_pods)]
    pod_groups = [dist.new_group([p * num_data + d for p in range(num_pods)])
                  for d in range(num_data)]
    return pod_groups[rank % num_data], data_groups[rank // num_data]

"""Pipeline parallelism (GPipe-style) over a mesh "pipe" dim, the port of
``repro/distributed/pipeline.py`` onto ``torch.distributed``.

Each rank of the "pipe" dim holds one stage; microbatches go round the
ring over ``num_micro + num_stages - 1`` ticks: at tick t stage 0 takes
microbatch t, every stage runs, and each stage's output goes to the next
by one point-to-point hop (``batch_isend_irecv``; through host copies for
CUDA tensors under gloo, as :mod:`repro_torch.distributed.collectives`'
ring does). The last stage emits microbatch t - num_stages + 1; at the end
a masked all-reduce gives every stage the last stage's outputs. The
bubble fraction is (S-1)/(M+S-1).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.collectives import _shift_up
from repro_torch.distributed.sharding import is_dtensor

__all__ = ["pipeline_forward"]


def _stage(leaf, rank: int):
    """This stage's slice of a stage-stacked leaf (a DTensor sharded on the
    "pipe" dim holds it locally)."""
    if is_dtensor(leaf):
        return leaf.to_local()[0]
    return leaf[rank]


def pipeline_forward(stage_fn, stage_params, x_micro, *, mesh,
                     axis: str = "pipe"):
    """Run microbatches through a ring of pipeline stages.

    ``stage_fn(params, x) -> x``: one stage's computation;
    ``stage_params``: a tensor or a dict of them whose leading dim is the
    number of stages (whole on every rank, or DTensors sharded on it);
    ``x_micro``: (num_micro, micro_batch, ...) input microbatches (the same
    on every rank). Returns the (num_micro, micro_batch, ...) outputs of
    the last stage, on every rank."""
    group = mesh.get_group(axis)
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    rank = mesh.get_local_rank(axis)
    n_micro = x_micro.shape[0]
    if isinstance(stage_params, dict):
        params = {k: _stage(v, rank) for k, v in stage_params.items()}
    else:
        params = _stage(stage_params, rank)
    buf = torch.zeros_like(x_micro[0])
    outs = torch.zeros_like(x_micro)
    for t in range(n_micro + n_stages - 1):
        x_in = x_micro[min(t, n_micro - 1)] if rank == 0 else buf
        y = stage_fn(params, x_in)
        buf = _shift_up(y, group)
        out_idx = t - (n_stages - 1)
        if rank == n_stages - 1 and out_idx >= 0:
            outs[out_idx] = y
    # the last stage's outputs to every stage
    if rank != n_stages - 1:
        outs.zero_()
    dist.all_reduce(outs, group=group)
    return outs

"""Logical-axis → mesh-axis sharding rules (DP/FSDP/TP/EP/SP), the port of
``repro/distributed/sharding.py`` onto ``torch.distributed``'s
``DeviceMesh`` and DTensor.

Parameters carry logical axes (:class:`repro_torch.models.params.P`);
these rules translate them to partition specs on the mesh:

  mesh dims: ("data", "model")              — one pod
             ("pod", "data", "model")       — several pods
             (…, "pipe")                    — pipeline stages

  TP   : "mlp"/"heads"/"kv"/"vocab"/"expert" → "model"
  FSDP : "embed" (param hidden dim)          → ("pod","data")  [ZeRO-3]
  DP   : activation "batch"                  → ("pod","data")
  SP   : activation "seq" (long-context)     → "model" or "data" per plan
  EP   : "expert"                            → "model"

A spec is the reference's ``PartitionSpec`` as a plain tuple: one entry a
tensor dim, None (replicated), a mesh-dim name or a tuple of them. The
spec logic is plain Python over the mesh's dim names and sizes, so it
holds spec for spec against the reference's; :func:`placements` turns a
spec into DTensor placements, one a mesh dim (``Shard(d)`` where the spec
puts that mesh dim on tensor dim ``d``, else ``Replicate()``).

Any rule whose dimension is not divisible by its mesh dims falls back to
replication (guarded in :func:`spec_for_axes`), e.g. whisper-tiny's 6
q-heads on a 4-way model dim. :func:`ashard` pins an activation (a
``DTensor``) to its logical axes inside an :class:`activation_sharding`
context and is the identity outside one or on a plain tensor, so that
single-device results stay bitwise as they were. Inside a context a plain
tensor that meets a DTensor is read as replicated (DTensor's implicit
replication).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

__all__ = ["ParallelPlan", "mesh_sizes", "spec_for_axes", "placements",
           "effective_axes", "param_specs", "param_shardings", "distribute",
           "distribute_dict", "place_tensor",
           "is_dtensor", "activation_sharding", "ashard", "sharding_active",
           "current_context", "batch_spec"]


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    fsdp: bool = True                      # shard "embed" over data (ZeRO-3)
    seq_shard_axis: Optional[str] = None   # SP: shard activation "seq"
    batch_axes: Tuple[str, ...] = ("data",)
    model_axes: Tuple[str, ...] = ("model",)

    @staticmethod
    def for_mesh(mesh, fsdp: bool = True,
                 seq_shard_axis: Optional[str] = None) -> "ParallelPlan":
        names = mesh_sizes(mesh)
        batch = tuple(a for a in ("pod", "data") if a in names)
        return ParallelPlan(fsdp=fsdp, seq_shard_axis=seq_shard_axis,
                            batch_axes=batch, model_axes=("model",))


def mesh_sizes(mesh) -> dict:
    """``{mesh dim name: size}`` of a ``DeviceMesh``, or of any object with
    the reference mesh's ``axis_names`` and ``devices.shape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _rules(plan: ParallelPlan):
    data = plan.batch_axes
    return {
        # parameter logical axes
        "embed": data if plan.fsdp else None,
        "mlp": plan.model_axes,
        "heads": plan.model_axes,
        "kv": plan.model_axes,
        "vocab": plan.model_axes,
        "expert": plan.model_axes,
        "layers": None,
        "embed2": None,
        # activation logical axes
        "batch": data,
        "seq": (plan.seq_shard_axis,) if plan.seq_shard_axis else None,
        "capacity": data,
        "act_vocab": plan.model_axes,
        "act_heads": plan.model_axes,
        None: None,
    }


def spec_for_axes(axes, shape, plan: ParallelPlan, mesh) -> tuple:
    """The spec of one tensor.

    Guards: (a) divisibility — dims not divisible by their mesh-dim product
    fall back to replication; (b) uniqueness — a mesh dim maps to at most
    one tensor dim, the first in the logical order wins (e.g. MoE expert
    weights (expert, embed, mlp): the expert dim takes "model", so mlp
    stays unsharded)."""
    rules = _rules(plan)
    sizes = mesh_sizes(mesh)
    used: set = set()
    entries = []
    for dim, name in zip(shape, axes):
        assign = rules.get(name)
        if assign is None:
            entries.append(None)
            continue
        assign = tuple(a for a in (assign if isinstance(assign, tuple)
                                   else (assign,))
                       if a is not None and a not in used)
        total = math.prod(sizes[a] for a in assign) if assign else 1
        if assign and dim % total == 0:
            entries.append(assign if len(assign) > 1 else assign[0])
            used.update(assign)
        else:
            entries.append(None)
    return tuple(entries)


def placements(spec, mesh) -> list:
    """DTensor placements of a spec on ``mesh``: ``Shard(d)`` for each mesh
    dim the spec puts on tensor dim ``d`` (several mesh dims on one tensor
    dim split it major to minor, as the reference's tuple entries do),
    ``Replicate()`` for the rest."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(mesh.mesh_dim_names)
    for d, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None:
                out[mesh.mesh_dim_names.index(name)] = Shard(d)
    return out


def effective_axes(axes, ndim: int):
    """Axes aligned to a tensor of ``ndim`` dims: a leading "layers" axis
    (the reference's stacked periods) is dropped when the value has lost
    that dim. The port keeps one module a layer, so its own axes never
    hold it."""
    axes = tuple(axes)
    if len(axes) == ndim + 1 and axes[0] == "layers":
        return axes[1:]
    return axes


def param_specs(module, plan: ParallelPlan, mesh) -> dict:
    """``{name: spec}`` of every parameter of ``module`` (an LM's
    :class:`~repro_torch.models.params.Params` tree), by its axes."""
    from repro_torch.models.params import param_axes
    axes = param_axes(module)
    return {k: spec_for_axes(axes[k], p.shape, plan, mesh)
            for k, p in module.named_parameters()}


def param_shardings(module, plan: ParallelPlan, mesh) -> dict:
    """``{name: placements}`` of every parameter of ``module`` on
    ``mesh``."""
    return {k: placements(s, mesh)
            for k, s in param_specs(module, plan, mesh).items()}


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def place_tensor(t, mesh, pls):
    """``t`` on ``mesh`` with placements ``pls``: a DTensor redistributed;
    a plain tensor every rank holds whole sliced to this rank's shard (no
    collective), copied so that the whole tensor can go."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if is_dtensor(t):
        return t.detach().redistribute(mesh, pls)
    d = distribute_tensor(t.detach(), mesh, pls, src_data_rank=None)
    return DTensor.from_local(d.to_local().clone(), mesh, pls,
                              run_check=False, shape=d.shape,
                              stride=d.stride())


def distribute(module, plan: ParallelPlan, mesh):
    """Shard a module (an LM's :class:`~repro_torch.models.params.Params`
    tree) in place by its parameters' logical axes: each ``nn.Parameter``
    is replaced by one holding a DTensor. Every rank must hold the whole
    tensors; each keeps its own shard. Returns the module."""
    shardings = param_shardings(module, plan, mesh)
    for name, p in list(module.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        setattr(module.get_submodule(owner), leaf, torch.nn.Parameter(
            place_tensor(p, mesh, shardings[name]),
            requires_grad=p.requires_grad))
    return module


def distribute_dict(tensors: dict, shardings: dict, mesh) -> dict:
    """``{name: DTensor}`` of ``tensors`` placed by ``{name: placements}``
    (:func:`place_tensor`); each keeps its ``requires_grad``."""
    return {k: place_tensor(t, mesh, shardings[k])
            .requires_grad_(t.requires_grad) for k, t in tensors.items()}


# ---------------------------------------------------------------------------
# activation constraints — a process-global context so model code can
# annotate without threading mesh and plan through every call
# ---------------------------------------------------------------------------

_CTX: list = []


class activation_sharding:
    """``with activation_sharding(mesh, plan): ...`` enables :func:`ashard`
    and the sharded branches of the model code."""

    def __init__(self, mesh, plan: ParallelPlan):
        self.mesh, self.plan = mesh, plan
        self._implicit = None

    def __enter__(self):
        # a plain tensor the model code makes (positions, masks, a zero
        # aux loss) meets DTensors as a replicated one
        from torch.distributed.tensor.experimental import implicit_replication
        self._implicit = implicit_replication()
        self._implicit.__enter__()
        _CTX.append((self.mesh, self.plan))
        return self

    def __exit__(self, *exc):
        _CTX.pop()
        self._implicit.__exit__(*exc)


def ashard(x, *axes):
    """Pin activation ``x`` to its logical axes: a redistribution of a
    DTensor inside a context, the identity outside one or on a plain
    tensor."""
    if not _CTX or not is_dtensor(x):
        return x
    mesh, plan = _CTX[-1]
    want = placements(spec_for_axes(axes, x.shape, plan, mesh), mesh)
    if list(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def sharding_active() -> bool:
    return bool(_CTX)


def current_context():
    """(mesh, plan) of the innermost activation_sharding context, or None."""
    return _CTX[-1] if _CTX else None


def batch_spec(plan: ParallelPlan, mesh, *, seq_sharded: bool = False):
    """Spec of a (B, S) token batch."""
    b = plan.batch_axes if len(plan.batch_axes) > 1 else plan.batch_axes[0]
    s = plan.seq_shard_axis if seq_sharded else None
    return (b, s)

"""The ``Task`` leg of the training protocol: what the model is and what
its loss means, apart from where batches come from (providers) and how the
loop runs (the trainer). As the reference's (``repro/train/task.py``), a
task has three methods:

  * ``init(rng) -> params``: a dict of parameter tensors;
  * ``prepare(batch, *, plan=None, config=None, tune=None, mesh=None)
    -> (arrays, static)``: the batch's tensors on the task's device with
    its plans, and a hashable shape bucket;
  * ``loss(params, arrays, static, rng) -> (loss, metrics)``.

:class:`NodeClassification` trains a :mod:`repro_torch.models.gnn` family
on full graphs: the parameters are a dict named as the model's
``named_parameters()``, and the loss runs the model with them through
``torch.func.functional_call``. It also trains on sampled mini-batches
(:class:`~repro_torch.data.pipeline.SampledBatch`, from a
:class:`~repro_torch.train.providers.SampledNodeProvider`): they arrive on
the device with their plan stamped, and the loss reads only their seed
rows. With ``mesh=`` (a :class:`~repro_torch.core.dist_mp.ShardMesh`, one
process a shard) every aggregation runs sharded: each graph is
partitioned once and its partition and
:class:`~repro_torch.core.plan.PartitionedPlan` cached, and every rank
computes the same loss and the same gradients.

:class:`LMTask` trains an LM of :mod:`repro_torch.configs` on token
batches (:class:`~repro_torch.train.providers.TokenProvider`): next-token
cross entropy plus the MoE aux loss (:func:`repro_torch.models.lm.loss_fn`)
on a flat ``{name: tensor}`` dict of the LM's parameters, run through
``torch.func.functional_call`` on a meta-device skeleton. With ``mesh=``
(a ``DeviceMesh`` with "data" and "model" dims,
:func:`repro_torch.launch.mesh.make_host_mesh`) it trains sharded: the
batch is placed on ``batch_spec`` and :meth:`LMTask.build_step` returns the
sharded step of :func:`repro_torch.distributed.step.build_train_step`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Protocol, runtime_checkable

import torch

from repro_torch.core.device import resolve_device
from repro_torch.data.graphs import Graph, TypedGraph
from repro_torch.data.pipeline import SampledBatch
from repro_torch.models import gnn

__all__ = ["Task", "GraphStatic", "NodeClassification", "LMStatic",
           "LMTask"]


@runtime_checkable
class Task(Protocol):
    """Structural protocol: any object with these three methods trains."""

    def init(self, rng) -> Any:                        # pragma: no cover
        ...

    def prepare(self, batch, *, plan=None, config=None, tune=None,
                mesh=None) -> tuple:                   # pragma: no cover
        ...

    def loss(self, params, arrays, static, rng) -> tuple:  # pragma: no cover
        ...


class GraphStatic(NamedTuple):
    """Hashable shape bucket of a batch. ``sampled`` marks mini-batches
    from the out-of-core pipeline: their arrays carry a ``label_mask`` the
    loss must honour, so they are another bucket than a full graph of the
    same shape. ``shards`` is 0 on one device, else the mesh's size."""
    model: str
    num_nodes: int
    num_edges: int
    typed: bool
    sampled: bool = False
    shards: int = 0


@dataclasses.dataclass
class NodeClassification:
    """Full-graph node classification (paper §V-F): cross entropy over the
    nodes' logits, accuracy as the metric, for every family: ``gcn`` /
    ``gin`` / ``sage`` / ``gat`` on :class:`~repro_torch.data.graphs.Graph`
    batches, ``rgcn`` / ``rgat`` on
    :class:`~repro_torch.data.graphs.TypedGraph` ones (with their
    permutation triple and a :class:`~repro_torch.core.plan.RelationPlan`).

    ``device``: where batches and parameters live (``None``: the card,
    raising without one; ``"cpu"`` for the plain versions). ``impl``: the
    ops' backend (``None``: the kernels on the card, the plain versions
    on the CPU; ``"ref"`` forces the plain versions, as an oracle)."""
    model: str = "gcn"
    d_in: int = 32
    hidden: int = 64
    num_classes: int = 16
    num_layers: int = 3
    heads: int = 1
    num_relations: int = 4
    impl: Optional[str] = None
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device, "NodeClassification")
        self._dev: dict = {}       # id(g) -> (g, device arrays)
        self._parts: dict = {}     # (id(g), shards, config, tune) -> (g,
        #                            partition, PartitionedPlan)
        self._module = None        # the model's structure (no weights)

    @classmethod
    def from_provider(cls, provider, model: str = "gcn", **kw):
        """Size the task off a provider's metadata (feat / classes /
        relations)."""
        kw.setdefault("num_relations", max(provider.num_relations, 1))
        return cls(model=model, d_in=provider.feat,
                   num_classes=provider.num_classes, **kw)

    @property
    def plan_feat(self) -> int:
        """The widest layer width: the feature width plans are built for."""
        return max(self.d_in, self.hidden, self.num_classes)

    def _skeleton(self) -> gnn.GNN:
        """The model's structure on the meta device: ``loss`` calls it
        with the parameters it is given."""
        if self._module is None:
            dims = ([self.d_in] + [self.hidden] * (self.num_layers - 1)
                    + [self.num_classes])
            self._module = gnn.GNN(self.model, dims, heads=self.heads,
                                   num_relations=self.num_relations
                                   ).to("meta")
        return self._module

    # -- protocol ------------------------------------------------------------

    def init(self, rng: torch.Generator) -> dict:
        """Seeded random parameters on the task's device."""
        seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=rng))
        model = gnn.init(self.model, self.d_in, self.hidden,
                         self.num_classes, self.num_layers, heads=self.heads,
                         num_relations=self.num_relations, seed=seed,
                         device=self.device)
        return {k: p.detach().requires_grad_()
                for k, p in model.named_parameters()}

    def prepare(self, batch, *, plan=None, config=None, tune=None,
                mesh=None):
        if mesh is not None:
            from repro_torch.core.dist_mp import check_mesh
            check_mesh(mesh)
        if isinstance(batch, SampledBatch):
            if mesh is not None:
                raise NotImplementedError(
                    "sampled mini-batches are single-device for now")
            return self._prepare_sampled(batch, plan=plan)
        if not isinstance(batch, Graph):
            raise TypeError(f"batches of type {type(batch).__name__}: a "
                            "task trains on a Graph or a SampledBatch")
        g = batch
        typed = isinstance(g, TypedGraph)
        if typed != (self.model in gnn.TYPED_MODELS):
            raise ValueError(
                f"model {self.model!r} and batch graph type disagree: "
                f"typed={typed} (use a GraphEpochProvider(typed=...) that "
                "matches the model family)")
        shards = 0 if mesh is None else mesh.size
        if typed and shards:
            raise NotImplementedError("typed layers are single-shard for now")
        static = GraphStatic(self.model, g.num_nodes, g.num_edges, typed,
                             shards=shards)
        arrays = dict(self._device_arrays(g))
        if shards:
            if mesh.device != self.device:
                raise ValueError(f"the mesh is on {mesh.device}, the task "
                                 f"on {self.device}")
            part, pplan = self._partitioned(g, shards, config, tune)
            arrays.update(mesh=mesh, partition=part,
                          plan=plan if plan is not None else pplan)
            return arrays, static
        # plans are memoized on the graph: each graph of a bucket is planned
        # once, at its first step
        arrays["plan"] = (plan if plan is not None else
                          g.make_plan(self.plan_feat, config=config,
                                      device=self.device, tune=tune))
        if typed:
            arrays["rplan"] = g.make_relation_plan(
                self.plan_feat, config=config, device=self.device, tune=tune)
        return arrays, static

    def loss(self, params, arrays, static, rng=None):
        logits = torch.func.functional_call(
            self._skeleton(), params,
            (arrays["x"], arrays["edge_index"], static.num_nodes,
             arrays["deg_inv_sqrt"]),
            dict(impl=self.impl, plan=arrays["plan"],
                 mesh=arrays.get("mesh"), partition=arrays.get("partition"),
                 edge_type=arrays.get("edge_type"),
                 type_perm=arrays.get("type_perm"),
                 inv_type_perm=arrays.get("inv_type_perm"),
                 type_counts=arrays.get("type_counts"),
                 rplan=arrays.get("rplan")))
        labels, mask = arrays["labels"], arrays.get("label_mask")
        correct = (logits.argmax(-1) == labels).float()
        if mask is None:
            accuracy = correct.mean()
        else:
            # a sampled mini-batch: only the seed rows carry whole (exact or
            # fanout-complete) neighbourhoods, so only they are supervised
            accuracy = (mask * correct).sum() / mask.sum().clamp_min(1.0)
        return gnn.cross_entropy(logits, labels, mask), {
            "accuracy": accuracy.detach()}

    def _prepare_sampled(self, batch, *, plan=None):
        """A sampled mini-batch arrives on the device with its plan
        stamped under its bucket's cache entry (the producer did the
        per-shape work once, in the shared
        :class:`~repro_torch.serve.plan_cache.PlanCache`). Nothing is
        memoized: every batch is a fresh object."""
        if self.model in gnn.TYPED_MODELS:
            raise ValueError(
                f"model {self.model!r} is relational; the neighbour sampler "
                "emits homogeneous subgraphs")
        if batch.arrays["x"].device != self.device:
            raise ValueError(f"the batch lies on {batch.arrays['x'].device}, "
                             f"the task on {self.device}")
        batch.ready()
        static = GraphStatic(self.model, batch.bucket.num_nodes,
                             batch.bucket.num_edges, False, sampled=True)
        arrays = dict(batch.arrays)
        arrays["plan"] = plan if plan is not None else batch.plan
        return arrays, static

    # -- memoized per-graph state -------------------------------------------

    def _partitioned(self, g, shards: int, config, tune):
        """The graph's partition and PartitionedPlan, built at its first
        step on this mesh size and kept (the reference's ``_partitioned``)."""
        key = (id(g), shards, config, tune)
        hit = self._parts.get(key)
        if hit is not None and hit[0] is g:
            return hit[1], hit[2]
        part = g.partition(shards, device=self.device)
        pplan = part.make_plan(feat=self.plan_feat, config=config, tune=tune)
        # pin g in the memo: id() is only unique among live objects
        self._parts[key] = (g, part, pplan)
        return part, pplan

    def _device_arrays(self, g) -> dict:
        hit = self._dev.get(id(g))
        if hit is not None and hit[0] is g:
            return hit[1]

        def dev(a):
            return torch.from_numpy(a).to(self.device)
        arrays = {"x": dev(g.x), "edge_index": dev(g.edge_index),
                  "labels": dev(g.labels).long(),
                  "deg_inv_sqrt": dev(g.deg_inv_sqrt)}
        if isinstance(g, TypedGraph):
            arrays.update(edge_type=dev(g.edge_type),
                          type_perm=dev(g.type_perm),
                          inv_type_perm=dev(g.inv_type_perm),
                          type_counts=dev(g.type_counts))
        # pin g in the memo: id() is only unique among live objects
        self._dev[id(g)] = (g, arrays)
        return arrays


# ---------------------------------------------------------------------------
# the LM task
# ---------------------------------------------------------------------------

def _device_mesh(mesh):
    """``mesh`` if it is a ``DeviceMesh``; anything else raises."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise NotImplementedError(
            "LMTask trains across a torch DeviceMesh (LM-sharding: "
            "repro_torch.launch.mesh.make_host_mesh), got "
            f"{type(mesh).__name__}")
    return mesh


class LMStatic(NamedTuple):
    """Shape bucket of a token batch."""
    batch: int
    seq: int


@dataclasses.dataclass
class LMTask:
    """Next-token LM training (:func:`repro_torch.models.lm.loss_fn`) as a
    Task, the reference's ``LMTask``.

    ``cfg``: a :class:`~repro_torch.models.config.ModelConfig`;
    ``remat_policy`` ∈ {"none", "dots", "full"} checkpoints each block;
    ``moe_impl`` ∈ {"capacity", "ragged", "cuda"}: ``"cuda"`` is the
    dropless path on the kernels (the expert products and their dX on
    segment_matmul, the combine and its backward on the gather and sddmm
    kernels), the counterpart of the reference's ``"pallas"``;
    ``aux_weight`` scales the MoE aux loss. ``device``: where batches and
    parameters live (``None``: the card, raising without one; ``"cpu"``
    for the plain versions). The ``(plan=, config=, tune=)`` trio is
    accepted for the protocol and has no effect: token batches carry no
    segment plans.

    Across a ``DeviceMesh`` (``fit(mesh=)``): :meth:`shard` places the
    initial parameters by their logical axes (the trainer's moments then
    shard alike), :meth:`prepare` places each batch on the data dims and
    :meth:`build_step` runs the sharded step (its warmup-cosine schedule
    over ``TrainerConfig.steps``, as the reference's pjit step); every
    ``moe_impl`` shards (``"ragged"`` and ``"cuda"`` on
    :func:`~repro_torch.models.moe.moe_ragged_shard_map`). int8 AdamW
    moments are scaled a period slot at a time (:meth:`moment_groups`)."""
    cfg: Any
    remat_policy: str = "none"
    moe_impl: str = "capacity"
    aux_weight: float = 0.01
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device, "LMTask")

    def init(self, rng: torch.Generator) -> dict:
        """Seeded random weights on the task's device (the reference's
        distributions), as detached leaves that require grad."""
        from repro_torch.models import lm
        seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=rng))
        model = lm.LM(self.cfg, device=self.device, seed=seed)
        return {k: p.detach().requires_grad_()
                for k, p in model.named_parameters()}

    def shard(self, params: dict, mesh) -> dict:
        """Whole parameters (every rank holding them) as this rank's
        shards on ``mesh``, leaves that require grad."""
        from repro_torch.distributed import sharding as shd
        from repro_torch.models import lm
        mesh = _device_mesh(mesh)
        plan = shd.ParallelPlan.for_mesh(mesh)
        psh = shd.param_shardings(lm.LM(self.cfg, device="meta", seed=None),
                                  plan, mesh)
        return shd.distribute_dict(params, psh, mesh)

    def prepare(self, batch, *, plan=None, config=None, tune=None,
                mesh=None):
        if mesh is not None:
            mesh = _device_mesh(mesh)
        arrays = {k: torch.as_tensor(v).to(self.device)
                  for k, v in batch.items()}
        b, s = arrays["tokens"].shape
        if mesh is not None:
            from repro_torch.distributed import sharding as shd
            splan = shd.ParallelPlan.for_mesh(mesh)
            arrays = {k: shd.place_tensor(v, mesh, shd.placements(
                shd.spec_for_axes(("batch", "seq") + (None,) * (v.dim() - 2),
                                  v.shape, splan, mesh), mesh))
                for k, v in arrays.items()}
        return arrays, LMStatic(int(b), int(s))

    def moment_groups(self, names) -> tuple:
        """The parameters whose int8 AdamW moments share one scale: a
        period slot's layers, stacked into one tensor in the reference
        (:func:`repro_torch.models.lm.moment_groups`)."""
        from repro_torch.models import lm
        return lm.moment_groups(self.cfg, names)

    def loss(self, params, arrays, static, rng=None):
        from repro_torch.models import lm
        loss, metrics = lm.loss_fn(params, self.cfg, arrays,
                                   remat_policy=self.remat_policy,
                                   moe_impl=self.moe_impl,
                                   aux_weight=self.aux_weight)
        return loss, {k: v.detach() for k, v in metrics.items()}

    def build_step(self, trainer_cfg, mesh, static: LMStatic):
        """None (the trainer's generic step) on one device, as the
        reference's. With a mesh: the sharded step of
        :func:`~repro_torch.distributed.step.build_train_step` behind the
        trainer's ``(state, arrays) -> (state, metrics)`` surface, its
        shardings resolved on the first call (a whole state is placed on
        the mesh then; a sharded one stays as it is)."""
        if mesh is None:
            return None
        from repro_torch.distributed import sharding as shd
        from repro_torch.distributed import step as steplib
        from repro_torch.train.trainer import TrainState
        mesh = _device_mesh(mesh)
        plan = shd.ParallelPlan.for_mesh(mesh)
        ts = steplib.TrainStepConfig(
            opt=trainer_cfg.opt, warmup_steps=trainer_cfg.warmup_steps,
            total_steps=trainer_cfg.steps, remat_policy=self.remat_policy,
            moe_impl=self.moe_impl, aux_weight=self.aux_weight)
        fn, shardings_for = steplib.build_train_step(self.cfg, mesh, plan, ts)
        box: dict = {}

        def step(state: TrainState, arrays):
            if not box:
                shapes = {k: tuple(v.shape) for k, v in arrays.items()}
                box["sh"] = shardings_for(state.params, state.opt_state,
                                          shapes)
            psh, osh, _, _ = box["sh"]
            params, opt = state.params, state.opt_state
            if not all(shd.is_dtensor(p) for p in params.values()):
                params, opt = steplib.shard_state(params, opt, psh, osh, mesh)
            params, opt, metrics = fn(params, opt, arrays, state.step)
            return (TrainState(params, opt, state.step + 1, state.rng),
                    metrics)

        return step

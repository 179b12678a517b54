"""The ``Trainer`` leg of the training protocol: AdamW with a schedule
(:mod:`repro_torch.optim`), an eager step on the task's device, periodic
checkpoints with resume, and the fault-tolerant loop
(:class:`~repro_torch.distributed.fault_tolerance.ResilientLoop`), as the
reference's (``repro/train/trainer.py``).

A step is eager: the task's loss (forward), ``torch.autograd.grad``
(backward through the ops' kernels), ``adamw.update_``, which writes the
update into the state's own parameters and moments (a step holds no
second copy of either; the state passed to :meth:`Trainer.step` is
consumed, as a donated buffer is in JAX). The trainer counts
steps and the distinct shape buckets it has seen in the
:mod:`repro_torch.obs` registry (``train.steps``, ``train.buckets``;
vital), and each step opens the span tree ``train.step`` ⊃
``train.sample``, ``train.prepare``, ``train.execute`` (host time: the
step's device work may finish after its spans close). The first step on
a new ``GraphStatic`` is the bucket's build: its ``train.execute`` span
carries ``new_bucket=True`` and :func:`repro_torch.obs.record_build`
attributes it (capturing a step as a CUDA graph comes later).

:class:`TrainState` (params + optimizer state + step + the state of a
``torch.Generator``) is the unit of checkpointing. ``fit(resume=True)``
restores the newest complete checkpoint in ``ckpt_dir`` and continues
from its step; providers are deterministic in the step index, the
generator state is part of the state and every kernel sums in a fixed
order, so the resumed trajectory is bitwise the uninterrupted one. A
state given to ``fit(state=)`` is left as it was: the loop trains a copy.
After a failure before the first checkpoint the loop rebuilds the state it
started from (``init_state`` again, the resumed checkpoint, or a copy of
the given state) rather than keeping a second copy beside the one it
trains.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, NamedTuple, Optional

import torch

from repro_torch import obs
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.distributed.fault_tolerance import (ResilientLoop,
                                                     ResilientLoopConfig)
from repro_torch.obs import span
from repro_torch.optim import adamw, schedule

__all__ = ["TrainState", "TrainerConfig", "FitResult", "Trainer", "fit"]


class TrainState(NamedTuple):
    """Everything a resumed run needs: one checkpointable tree."""
    params: Dict[str, torch.Tensor]
    opt_state: adamw.AdamWState
    step: int                     # the next step to run
    rng: torch.Tensor             # torch.Generator state (uint8, CPU)


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """Loop + optimizer + fault-tolerance knobs (one frozen config)."""
    steps: int = 100
    opt: adamw.AdamWConfig = adamw.AdamWConfig()
    warmup_steps: int = 10
    lr_schedule: str = "warmup_cosine"    # see repro_torch.optim.schedule
    seed: int = 0
    # checkpointing (None: no checkpoints, no resume)
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep: int = 3
    # fault tolerance (threaded into ResilientLoopConfig)
    max_restarts: int = 3
    step_timeout_s: Optional[float] = None
    straggler_factor: float = 3.0
    log_every: int = 0


class FitResult(NamedTuple):
    state: TrainState
    losses: list                  # per-step losses, in step order
    start_step: int               # first step this fit ran
    steps: int                    # steps this trainer has run in all
    buckets: tuple                # shape buckets seen
    events: tuple                 # ResilientLoop event log


def _copy(state: TrainState) -> TrainState:
    """A state whose tensors are copies (leaves keep ``requires_grad``)."""
    def leaf(_, t):
        if not isinstance(t, torch.Tensor):
            return t
        return t.detach().clone().requires_grad_(t.requires_grad)
    return ckpt._map(leaf, state)


def _seed(gen: torch.Generator) -> int:
    return int(torch.randint(0, 2 ** 62, (), generator=gen))


def _step_generator(rng_state: torch.Tensor, step: int) -> torch.Generator:
    """The generator of one step: the state's, with the step folded in."""
    gen = torch.Generator()
    gen.set_state(rng_state)
    return torch.Generator().manual_seed((_seed(gen) + step) % 2 ** 62)


class Trainer:
    """``Trainer(task, data, cfg).fit()``: see the module docstring.

    ``task`` follows :class:`~repro_torch.train.task.Task`; ``data`` any
    provider with ``batch(step)``. ``(plan=, config=, tune=)`` follow the
    library-wide precedence: an explicit ``plan=`` is used for every batch
    (single-shape data), else ``config=`` pins the kernel config each
    graph's plan is built with, else ``tune=True`` selects it from a sweep
    measured on the card, else the generated rules decide.

    ``mesh`` trains sharded, SPMD: every rank of the mesh runs this
    trainer on the same data. A :class:`~repro_torch.core.dist_mp.
    ShardMesh` (the GNNs): the task partitions each graph, and the merges
    give every rank the same gradients, so the replicated parameters stay
    bitwise equal with no gradient all-reduce. A ``DeviceMesh`` (the LMs,
    :class:`~repro_torch.train.task.LMTask`): the task's ``shard`` places
    the initial parameters on it (the moments shard alike) and its
    ``build_step`` gives the sharded step the trainer runs instead of its
    own. With a checkpoint directory each rank of a mesh of several keeps
    its own, ``<ckpt_dir>/rank<r>``."""

    def __init__(self, task, data, cfg: Optional[TrainerConfig] = None, *,
                 plan=None, config=None, tune=None, mesh=None):
        self.task = task
        self.data = data
        self.cfg = cfg if cfg is not None else TrainerConfig()
        rank, size = _mesh_rank(mesh)
        if _is_device_mesh(mesh) and not hasattr(task, "shard"):
            raise NotImplementedError(
                f"{type(task).__name__} does not shard over a DeviceMesh "
                "(the LMs' mesh); the GNN tasks take a ShardMesh")
        if size > 1 and self.cfg.ckpt_dir:
            self.cfg = dataclasses.replace(self.cfg, ckpt_dir=os.path.join(
                self.cfg.ckpt_dir, f"rank{rank}"))
        self.mesh = mesh
        self.plan = plan
        self.config = config
        self.tune = tune
        self._buckets: dict = {}        # shape buckets seen, in order
        self._steps: dict = {}          # bucket -> the task's own step
        self._lr_scale = schedule.get(self.cfg.lr_schedule)
        reg = obs.get_registry()
        self._labels = {"trainer": obs.next_id("trainer")}
        self._m_steps = reg.counter("train.steps", ("trainer",), vital=True)
        self._m_buckets = reg.counter("train.buckets", ("trainer",),
                                      vital=True)
        self._m_steps.touch(**self._labels)
        self._m_buckets.touch(**self._labels)

    @property
    def steps(self) -> int:
        """Steps run by this trainer."""
        return int(self._m_steps.value(**self._labels))

    @property
    def buckets(self) -> tuple:
        return tuple(self._buckets)

    def init_state(self) -> TrainState:
        root = torch.Generator().manual_seed(self.cfg.seed)
        s_init, s_state = _seed(root), _seed(root)
        params = self.task.init(torch.Generator().manual_seed(s_init))
        if _is_device_mesh(self.mesh):
            params = self.task.shard(params, self.mesh)
        return TrainState(params, adamw.init(params, self.cfg.opt), 0,
                          torch.Generator().manual_seed(s_state).get_state())

    def step(self, state: TrainState, step: int):
        """One training step on ``data.batch(step)``: returns the new state
        and the step's metrics (loss and accuracy as 0-d tensors, the
        gradient norm, the learning rate)."""
        cfg = self.cfg
        with span("train.step", trainer=self._labels["trainer"],
                  step=int(step)) as root:
            with span("train.sample", step=int(step)):
                batch = self.data.batch(step)
            with span("train.prepare"):
                arrays, static = self.task.prepare(batch, plan=self.plan,
                                                   config=self.config,
                                                   tune=self.tune,
                                                   mesh=self.mesh)
            root.set(static=repr(static))
            new = static not in self._buckets
            if new:
                self._buckets[static] = None
                self._m_buckets.inc(**self._labels)
                obs.record_build("train.step", "new_bucket",
                                 trainer=self._labels["trainer"],
                                 static=repr(static))
                build = getattr(self.task, "build_step", None)
                self._steps[static] = build(cfg, self.mesh, static) \
                    if build is not None else None
            custom = self._steps[static]
            with span("train.execute", static=repr(static), new_bucket=new):
                if custom is not None:
                    new_state, metrics = custom(state, arrays)
                else:
                    new_state, metrics = self._generic_step(state, arrays,
                                                            static)
            self._m_steps.inc(**self._labels)
        return new_state, metrics

    def _moment_groups(self, params):
        """The task's groups of parameters whose int8 moments share a
        scale (``task.moment_groups(names)``), or None."""
        groups = getattr(self.task, "moment_groups", None)
        return None if groups is None else groups(list(params))

    def _generic_step(self, state: TrainState, arrays, static):
        """Loss, ``torch.autograd.grad`` and ``adamw.update_`` on the
        task's device."""
        cfg = self.cfg
        params = state.params
        loss, metrics = self.task.loss(params, arrays, static,
                                       _step_generator(state.rng, state.step))
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        lr_scale = self._lr_scale(state.step, cfg.warmup_steps, cfg.steps)
        new_p, new_o, om = adamw.update_(grads, state.opt_state, params,
                                         cfg.opt, lr_scale,
                                         self._moment_groups(params))
        return (TrainState(new_p, new_o, state.step + 1, state.rng),
                dict(metrics, loss=loss.detach(), **om))

    def fit(self, *, resume: bool = False, state: Optional[TrainState] = None,
            metrics_cb: Optional[Callable] = None) -> FitResult:
        """Run the loop to ``cfg.steps`` steps in all. ``resume=True``
        restores the newest complete checkpoint in ``cfg.ckpt_dir`` (a
        cold start when there is none) and continues from its step;
        ``state=`` replaces the initial state (not with ``resume``)."""
        cfg = self.cfg
        if resume and state is not None:
            raise ValueError("pass either resume=True or state=, not both")
        if resume and not cfg.ckpt_dir:
            raise ValueError("resume=True needs TrainerConfig.ckpt_dir")
        # the state the loop enters with, rebuilt on demand (the loop
        # trains its tensors in place)
        if state is None:
            state, entry = self.init_state(), self.init_state
        else:
            given, state = state, _copy(state)

            def entry():
                return _copy(given)
        start = 0
        if resume:
            latest = ckpt.latest_step(cfg.ckpt_dir)
            if latest is not None:
                state = ckpt.restore(state, cfg.ckpt_dir, step=latest)
                start = latest

                def entry():
                    return ckpt.restore(self.init_state(), cfg.ckpt_dir,
                                        step=latest)

        history: dict = {}            # step -> loss (replay overwrites)

        def step_fn(st, step):
            st, metrics = self.step(st, step)
            loss = history[step] = float(metrics["loss"])
            if cfg.log_every and step % cfg.log_every == 0:
                print(f"step {step:5d} loss {loss:.4f}", flush=True)
            return st, metrics

        loop = ResilientLoop(
            ResilientLoopConfig(
                cfg.ckpt_dir or "", ckpt_every=cfg.ckpt_every, keep=cfg.keep,
                max_restarts=cfg.max_restarts,
                step_timeout_s=cfg.step_timeout_s,
                straggler_factor=cfg.straggler_factor),
            step_fn, state, entry=entry)
        final = loop.run(cfg.steps, start_step=start, metrics_cb=metrics_cb)
        losses = [history[s] for s in sorted(history)]
        return FitResult(state=final, losses=losses, start_step=start,
                         steps=self.steps, buckets=self.buckets,
                         events=tuple(loop.events))


def _is_device_mesh(mesh) -> bool:
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(mesh, DeviceMesh)


def _mesh_rank(mesh):
    """(this rank, the mesh's size) of a ``DeviceMesh`` or a checked
    :class:`~repro_torch.core.dist_mp.ShardMesh`; (0, 1) for none."""
    if mesh is None:
        return 0, 1
    if _is_device_mesh(mesh):
        import torch.distributed as dist
        return dist.get_rank(), mesh.size()
    from repro_torch.core.dist_mp import check_mesh
    mesh = check_mesh(mesh)
    return mesh.rank, mesh.size


def fit(task, data, trainer: Optional[TrainerConfig] = None, *, plan=None,
        config=None, tune=None, mesh=None, resume: bool = False,
        state: Optional[TrainState] = None,
        metrics_cb: Optional[Callable] = None) -> FitResult:
    """One-call training: ``repro_torch.fit(task, data, trainer_cfg)``
    builds a :class:`Trainer` and runs :meth:`Trainer.fit`;
    ``(plan=, config=, tune=)`` carry the precedence plan > config > tune >
    rules into every batch's planning; ``mesh=`` trains sharded (every
    rank of the mesh calls ``fit`` alike)."""
    return Trainer(task, data, trainer, plan=plan, config=config,
                   tune=tune, mesh=mesh).fit(resume=resume, state=state,
                                             metrics_cb=metrics_cb)

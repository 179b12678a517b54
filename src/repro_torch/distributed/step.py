"""The sharded train, decode and prefill steps of the LM stack, the port of
``repro/distributed/step.py`` onto DTensor.

The reference returns a function and the shardings to ``jax.jit`` it
with; here a step runs eagerly on DTensors inside an
:func:`~repro_torch.distributed.sharding.activation_sharding` context, and
``shardings_for`` gives the placements to put its arguments on the mesh
with (:func:`shard_state`, :func:`shard_decode_state`,
:func:`~repro_torch.distributed.sharding.distribute`).

  build_train_step   loss, gradients (each redistributed to its
                     parameter's placements), ``warmup_cosine`` and
                     ``adamw.update_`` on the sharded parameters and
                     moments, in place;
  build_serve_step   one decode step against a sharded decode state (the
                     KV cache heads-sharded on "model", or sequence-sharded
                     where the KV heads do not divide it);
  build_prefill_step the full-sequence forward, logits only.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.models import lm
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw, schedule
from repro_torch.optim.adamw import QTensor

__all__ = ["TrainStepConfig", "opt_shardings", "shard_state",
           "build_train_step", "decode_state_specs", "shard_decode_state",
           "build_serve_step", "build_prefill_step"]


class TrainStepConfig(NamedTuple):
    opt: adamw.AdamWConfig = adamw.AdamWConfig()
    warmup_steps: int = 100
    total_steps: int = 10_000
    remat_policy: str = "full"
    moe_impl: str = "capacity"
    aux_weight: float = 0.01


def _replicated(mesh) -> list:
    from torch.distributed.tensor import Replicate
    return [Replicate()] * mesh.ndim


# ---------------------------------------------------------------------------
# shardings for the optimizer state (mirrors the params; int8 scale
# replicated)
# ---------------------------------------------------------------------------

def opt_shardings(psh: dict, mesh, opt_state: adamw.AdamWState):
    """Moment placements mirror the parameters' (``psh``: ``{name:
    placements}``). An int8 (QTensor) moment shards its payload like its
    parameter and replicates its scalar scale."""
    rep = _replicated(mesh)

    def moment(k, m):
        return QTensor(psh[k], rep) if isinstance(m, QTensor) else psh[k]
    return adamw.AdamWState(
        None, {k: moment(k, m) for k, m in opt_state.mu.items()},
        {k: moment(k, m) for k, m in opt_state.nu.items()})


def shard_state(params: dict, opt_state: adamw.AdamWState, psh: dict, osh,
                mesh):
    """The parameters and moments on the mesh by their placements
    (:func:`~repro_torch.distributed.sharding.place_tensor`: a leaf
    already a DTensor is redistributed; every rank must hold the whole
    tensors of a plain state). An int8 moment keeps its payload and scale
    (quantized against the whole tensor or period slot)."""
    def moments(tree, shardings):
        out = {}
        for k, m in tree.items():
            if isinstance(m, QTensor):
                out[k] = QTensor(
                    shd.place_tensor(m.q, mesh, shardings[k].q),
                    shd.place_tensor(m.scale, mesh, shardings[k].scale))
            else:
                out[k] = shd.place_tensor(m, mesh, shardings[k])
        return out
    return (shd.distribute_dict(params, psh, mesh),
            adamw.AdamWState(opt_state.step, moments(opt_state.mu, osh.mu),
                             moments(opt_state.nu, osh.nu)))


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

def _whole(x):
    """A DTensor as the plain tensor every rank holds (autograd-aware)."""
    if not shd.is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, _replicated(x.device_mesh)) \
        .to_local()


def build_train_step(cfg: ModelConfig, mesh, plan: shd.ParallelPlan,
                     ts: TrainStepConfig = TrainStepConfig()):
    """Returns ``(train_step, shardings_for)``.

    ``train_step(params, opt_state, batch, step)``: ``params`` a ``{name:
    DTensor}`` dict named as the LM's ``named_parameters()`` (leaves that
    require grad), ``opt_state`` its sharded AdamW state, ``batch`` the
    DTensor fields, ``step`` the step index (the schedule's). Updates the
    parameters and moments in place and returns ``(params, opt_state,
    metrics)``, the metrics (loss, ce, moe_aux, grad_norm, lr) as plain
    tensors and floats every rank holds.

    ``shardings_for(params, opt_state, batch_shapes)`` gives ``(param
    placements, moment placements, {field: placements}, replicated)``.

    int8 moments are scaled a period slot at a time
    (:func:`repro_torch.models.lm.moment_groups`), as the reference's
    stacked ones; under a mesh the slot's max is over every shard."""

    def train_step(params, opt_state, batch, step):
        with shd.activation_sharding(mesh, plan):
            loss, metrics = lm.loss_fn(params, cfg, batch,
                                       remat_policy=ts.remat_policy,
                                       moe_impl=ts.moe_impl,
                                       aux_weight=ts.aux_weight)
            names = list(params)
            grads = torch.autograd.grad(_whole(loss),
                                        [params[k] for k in names],
                                        allow_unused=True)
            grads = {k: torch.zeros_like(params[k]) if g is None else
                     g.redistribute(mesh, params[k].placements)
                     for k, g in zip(names, grads)}
            lr_scale = schedule.warmup_cosine(step, ts.warmup_steps,
                                              ts.total_steps)
            new_p, new_o, om = adamw.update_(
                grads, opt_state, params, ts.opt, lr_scale=lr_scale,
                groups=lm.moment_groups(cfg, names))
            metrics = dict(metrics, loss=loss, **om)
            metrics = {k: _whole(v).detach() if torch.is_tensor(v) else v
                       for k, v in metrics.items()}
        return new_p, new_o, metrics

    def shardings_for(params, opt_state, batch_shapes: dict):
        """``batch_shapes``: field → whole shape (divisibility-aware)."""
        skeleton = lm.LM(cfg, device="meta", seed=None)
        psh = shd.param_shardings(skeleton, plan, mesh)
        missing = set(params) - set(psh)
        if missing:
            raise ValueError(f"parameters {sorted(missing)} are not the "
                             f"LM's of {cfg.name}")
        osh = opt_shardings(psh, mesh, opt_state)
        bsh = {}
        for f, shape in batch_shapes.items():
            axes = ("batch", "seq") + (None,) * (len(shape) - 2)
            bsh[f] = shd.placements(shd.spec_for_axes(axes, shape, plan,
                                                      mesh), mesh)
        return psh, osh, bsh, _replicated(mesh)

    return train_step, shardings_for


# ---------------------------------------------------------------------------
# serve (decode) step
# ---------------------------------------------------------------------------

def decode_state_specs(cfg: ModelConfig, mesh, plan: shd.ParallelPlan,
                       batch: int, max_len: int) -> lm.DecodeState:
    """Specs mirroring :func:`repro_torch.models.lm.init_decode_state`'s
    structure (``length`` is a host int: ``()``)."""
    sizes = shd.mesh_sizes(mesh)
    model = plan.model_axes[0]
    msize = sizes[model]
    dsize = 1
    for a in plan.batch_axes:
        dsize *= sizes[a]
    baxes = plan.batch_axes if len(plan.batch_axes) > 1 \
        else plan.batch_axes[0]
    b_ok = batch % dsize == 0
    bspec = baxes if b_ok else None

    def kv_spec():
        kh = cfg.num_kv_heads
        kh_s = model if kh % msize == 0 else None
        seq_s = None
        if kh_s is None and max_len % msize == 0:
            # GQA with few KV heads: the cache sharded over the sequence on
            # the model dim (flash-decode style); the scores' max and sum
            # of exponentials merge across the shards
            seq_s = model
        elif not b_ok and max_len % dsize == 0:
            seq_s = baxes          # long context: the sequence sharded (SP)
        p = (None, bspec, seq_s, kh_s, None)
        return (p, p)

    def ssm_spec():
        di = cfg.expand * cfg.d_model
        di_s = model if di % msize == 0 else None
        return ssm_lib.SSMState((None, bspec, None, di_s),
                                (None, bspec, di_s, None))

    def rwkv_spec():
        h_s = model if cfg.num_heads % msize == 0 else None
        d_s = model if cfg.d_model % msize == 0 else None
        return rwkv_lib.RWKVState((None, bspec, h_s, None, None),
                                  (None, bspec, d_s), (None, bspec, d_s))

    def mk(kind):
        return {"attn": kv_spec, "mamba": ssm_spec,
                "rwkv": rwkv_spec}[kind[0]]()

    def drop_lead(tree):
        vals = [s[1:] for s in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else tuple(vals)

    lead_kinds, period_kinds, _ = lm.stack_plan(cfg)
    lead = tuple(drop_lead(mk(k)) for k in lead_kinds)
    period = tuple(mk(k) for k in period_kinds)
    return lm.DecodeState(lead, period, ())


def shard_decode_state(state: lm.DecodeState, specs: lm.DecodeState,
                       mesh) -> lm.DecodeState:
    """A whole decode state (every rank holding it) placed on the mesh by
    :func:`decode_state_specs`: each rank keeps its own shard of every
    cache, which a sharded decode step then writes in place."""
    def place(tree, spec):
        vals = [shd.place_tensor(t, mesh, shd.placements(s, mesh))
                for t, s in zip(tree, spec)]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else tuple(vals)
    return lm.DecodeState(
        tuple(place(t, s) for t, s in zip(state.lead, specs.lead)),
        tuple(place(t, s) for t, s in zip(state.period, specs.period)),
        state.length)


def build_serve_step(cfg: ModelConfig, mesh, plan: shd.ParallelPlan,
                     batch: int, max_len: int, moe_impl: str = "capacity"):
    """A one-token decode step. Returns ``(serve_step, shardings_for)``:
    ``serve_step(model, tokens, state)`` runs
    :func:`repro_torch.models.lm.decode_step` on a sharded model (see
    :func:`~repro_torch.distributed.sharding.distribute`), (B, 1) tokens
    and a sharded state (:func:`shard_decode_state`), writing the caches
    in place; ``shardings_for(model)`` gives ``(param placements, token
    placements, state specs)``."""

    def serve_step(model, tokens, state):
        with shd.activation_sharding(mesh, plan):
            if not shd.is_dtensor(tokens):
                tokens = shd.place_tensor(
                    tokens, mesh, shardings_for(None)[1])
            logits, new_state = lm.decode_step(model, tokens, state,
                                               moe_impl=moe_impl)
        return logits, new_state

    def shardings_for(model):
        psh = None if model is None else \
            shd.param_shardings(model, plan, mesh)
        tok = shd.placements(shd.spec_for_axes(
            ("batch", None), (batch, 1), plan, mesh), mesh)
        return psh, tok, decode_state_specs(cfg, mesh, plan, batch, max_len)

    return serve_step, shardings_for


def build_prefill_step(cfg: ModelConfig, mesh, plan: shd.ParallelPlan,
                       moe_impl: str = "capacity",
                       remat_policy: str = "none"):
    """The full-sequence forward of a prefill, logits only:
    ``prefill(model, batch)`` with ``batch["tokens"]`` (B, S) (a plain
    tensor is placed on :func:`~repro_torch.distributed.sharding.
    batch_spec`) and optionally ``prefix_embeds`` / ``enc_embeds``."""

    @torch.no_grad()
    def prefill(model, batch):
        with shd.activation_sharding(mesh, plan):
            tokens = batch["tokens"]
            if not shd.is_dtensor(tokens):
                spec = shd.spec_for_axes(("batch", "seq"), tokens.shape,
                                         plan, mesh)
                tokens = shd.place_tensor(
                    tokens, mesh, shd.placements(spec, mesh))
            logits, _ = model(tokens,
                              prefix_embeds=batch.get("prefix_embeds"),
                              enc_embeds=batch.get("enc_embeds"),
                              remat_policy=remat_policy, moe_impl=moe_impl)
        return logits

    return prefill

"""Faults planted under the timed path, for the tests that see ``correct``
come out false, and the controls: each a context manager that patches the
program for as long as it is open.

GNN inference (``sage-reddit2.infer``): ``answer_altered`` (one node's
logits moved by the logits' largest magnitude where the model produces
them), ``half_neighbours`` (each aggregation over every other edge, the
mean taken over those), ``tf32`` (the program's own TF32 path switched on:
the control). LM training (``qwen3-moe-30b-a3b-4l.train``, parked in
``bench/parked.json``; its runs need :func:`norm_eps`):
``state_unchanged`` (AdamW's update skipped, the step count advanced),
``half_batch`` (the loss over the first half of the batch's sequences),
``loss_altered`` (the step's loss, and so its gradients, scaled by 1.01
where the task produces it).
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def patched(obj, name, make):
    saved = getattr(obj, name)
    setattr(obj, name, make(saved))
    try:
        yield
    finally:
        setattr(obj, name, saved)


@contextlib.contextmanager
def answer_altered():
    from repro_torch.models import gnn

    def make(forward):
        def run(self, *args, **kwargs):
            out = forward(self, *args, **kwargs).clone()
            out[0] += out.abs().max()
            return out
        return run
    with patched(gnn.GNN, "forward", make):
        yield


@contextlib.contextmanager
def half_neighbours():
    from repro_torch.models import gnn

    def make(mp_transform):
        def run(x, w, edge_index, num_nodes, **kwargs):
            kwargs["plan"] = None
            return mp_transform(x, w, edge_index[:, ::2].contiguous(),
                                num_nodes, **kwargs)
        return run
    with patched(gnn, "_mp_transform", make):
        yield


@contextlib.contextmanager
def tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@contextlib.contextmanager
def state_unchanged():
    from repro_torch.optim import adamw
    from repro_torch.train import trainer

    def make(update_):
        def run(grads, state, params, cfg, lr_scale=1.0, groups=None):
            return params, adamw.AdamWState(state.step + 1, state.mu,
                                            state.nu), {
                "grad_norm": adamw.global_norm(grads), "lr": cfg.lr}
        return run
    with patched(trainer.adamw, "update_", make):
        yield


@contextlib.contextmanager
def half_batch():
    from repro_torch.train import LMTask

    def make(loss):
        def run(self, params, arrays, static, rng=None):
            half = {k: v[: v.shape[0] // 2] for k, v in arrays.items()}
            return loss(self, params, half, static, rng)
        return run
    with patched(LMTask, "loss", make):
        yield


@contextlib.contextmanager
def loss_altered():
    from repro_torch.train import LMTask

    def make(loss):
        def run(self, *args, **kwargs):
            value, metrics = loss(self, *args, **kwargs)
            return value * 1.01, metrics
        return run
    with patched(LMTask, "loss", make):
        yield


@contextlib.contextmanager
def norm_eps(eps: float):
    """The program's block and final RMSNorms at ``eps``, the eps the
    configuration states: ``models/layers.py`` ``apply_norm`` takes 1e-5
    and no field of the program's ModelConfig sets it. Not a fault: the
    program put to run as the configuration states."""
    from repro_torch.models import layers

    def make(apply_norm):
        def run(prm, x, cfg, eps=eps):
            return apply_norm(prm, x, cfg, eps)
        return run
    with patched(layers, "apply_norm", make):
        yield


GNN_FAULTS = {"answer_altered": answer_altered,
              "half_neighbours": half_neighbours}
LM_FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
             "loss_altered": loss_altered}

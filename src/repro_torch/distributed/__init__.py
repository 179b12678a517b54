"""Host-side machinery around the training loop (fault tolerance), the
hand-scheduled collectives on ``torch.distributed``
(:mod:`repro_torch.distributed.collectives`), the LM's sharding rules on a
``DeviceMesh`` (:mod:`~repro_torch.distributed.sharding`), the sharded
train, decode and prefill steps (:mod:`~repro_torch.distributed.step`) and
the pipeline (:mod:`~repro_torch.distributed.pipeline`).

The names below are read from their modules on first use (the model code
imports :mod:`~repro_torch.distributed.sharding`, and the steps import the
models)."""
import importlib

_EXPORTS = {
    **{n: "sharding" for n in (
        "ParallelPlan", "spec_for_axes", "placements", "effective_axes",
        "param_specs", "param_shardings", "distribute", "distribute_dict",
        "place_tensor", "activation_sharding", "ashard", "sharding_active",
        "current_context", "batch_spec")},
    **{n: "step" for n in (
        "TrainStepConfig", "opt_shardings", "shard_state",
        "build_train_step", "decode_state_specs", "shard_decode_state",
        "build_serve_step", "build_prefill_step")},
    "pipeline_forward": "pipeline",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"),
                   name)

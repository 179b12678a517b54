"""Multi-pod dry run on fake ranks: trace one step of every (arch × shape ×
mesh) cell, the port of ``repro.launch.dryrun``.

The reference lowers and compiles each sharded step for 256 or 512 TPU
chips with no device (``jax.jit(...).lower().compile()`` on host
devices) and reads XLA's memory and cost analyses. Here each cell runs
**one step eagerly on fake ranks**: a fake process group of the mesh's
size (``torch.testing._internal.distributed.fake_pg``, this process as
rank 0), the production ``DeviceMesh`` over it, and every tensor a
``FakeTensor`` (shapes and dtypes, no storage: the LM is built and
placed under ``FakeTensorMode`` as :func:`~repro_torch.distributed.step.
shard_state` and :func:`~repro_torch.distributed.sharding.distribute`
place a real one). The port's kernels are ``torch.library`` ops whose
fakes give their output shapes, so the step goes through them without a
launch. A :class:`~repro_torch.launch.tally.StepTally` counts, per
device:

  * ``num_params``; ``param_bytes_per_device``, ``opt_bytes_per_device``
    (train) and ``cache_bytes_per_device`` (decode), from the rank's
    local shards, checked against the same arithmetic on the specs
    (:func:`state_bytes`, the reference's ``sharded_bytes``);
  * ``flops`` (also as ``cost_analysis.flops``), the flop counter's
    formulas on the local tensors;
  * ``collectives``: ``{"bytes": {kind: B}, "counts": {kind: n},
    "total_bytes": B}`` under the reference's five kinds, each collective
    counted once by its output bytes, as ``collective_bytes`` sums the
    HLO's;
  * ``kernels``: the calls of the port's kernel ops;
  * ``memory``: the peak bytes a device (the rank's storages only, never
    DTensor's global-shape propagation), what was live at the peak (params
    / optimizer / grads / cache / activations), and whether it fits the
    card: ``torch.cuda.get_device_properties(0).total_memory`` on the
    card, the H100's 80 GB when traced on the CPU;
  * ``trace_s``: the seconds of the trace.

Differences from the reference, by design:

  * An eager trace has no while-loop whose cost an analysis under-reports,
    so ``--diff`` (the cell at ``first_dense + k·period`` layers, k = 1,
    2, differenced) is kept for parity with the reference's roofline
    differencing; its per-period figures equal a period's share of the
    full cell. It records FLOPs and collective bytes, not XLA's bytes
    accessed.
  * ``--device cpu`` traces on a CPU mesh, whose tensors take the plain
    versions of the kernels (no ``repro_torch::*`` op is called), and on
    which DTensor runs an all-to-all as an all-gather and a chunk (torch
    logs "CPU process group does not support alltoall yet"): such records
    may count an all-gather where the card's count an all-to-all. The
    default traces CUDA-typed fake tensors on a ``"cuda"`` mesh and
    raises without a card, as every entry point of the port does.
  * The AdamW step counter and the decode length are host ints in the
    port, where the reference keeps a 4-byte device scalar of each
    (:func:`state_bytes`).

The plan is the reference's (``dryrun.py:167-200``): a decode cell whose
global batch does not divide 16 shards its sequence on "data"; serving
keeps resident (non-FSDP) weights iff the TP-only shard of the full
registry config is at most 12e9 bytes; training uses
``remat_policy="full"``, ``moe_impl="capacity"`` and the optimizer-state
dtypes of :data:`STATE_DTYPE`.

Usage::

  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all          # every runnable cell, both meshes
  python -m repro_torch.launch.dryrun --list
  python -m repro_torch.launch.dryrun --arch rwkv6-3b --shape long_500k --diff
  python -m repro_torch.launch.dryrun --all --device cpu   # on the CPU

Records go to ``results/torch_dryrun/<arch>__<shape>__<mesh>.json``
(``results/torch_roofline_diff/`` with ``--diff``), or to ``--out`` (a
file, or a directory that exists).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import pathlib
import sys
import time
import traceback

from repro_torch import configs as cfglib
from repro_torch.configs import shapes as shapelib

ROOT = pathlib.Path(__file__).resolve().parents[3]
RESULTS_DIR = ROOT / "results" / "torch_dryrun"
DIFF_DIR = ROOT / "results" / "torch_roofline_diff"

# optimizer-state precision per arch (the reference's memory plan)
STATE_DTYPE = {"kimi-k2-1t-a32b": "int8", "command-r-plus-104b": "bfloat16"}
_STATE_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}

# The reference's serving rule: resident weights iff the TP-only shard
# (the bf16 weights over the 16-way "model" dim) is at most this many
# bytes. It was chosen for a TPU chip's memory and is kept as it is, so
# that every record compares cell for cell with the reference's; the
# record says whether the peak fits the card.
RESIDENT_MAX_BYTES = 12e9
H100_BYTES = 80e9          # an H100 SXM's 80 GB, for traces on the CPU
SEED = 0

__all__ = ["RESULTS_DIR", "DIFF_DIR", "STATE_DTYPE", "state_bytes",
           "cell_plan", "fake_world", "trace_step", "run_cell", "diff_cell",
           "main"]


# ---------------------------------------------------------------------------
# the plan and the reference's arithmetic
# ---------------------------------------------------------------------------

def _num_params(cfg) -> int:
    from repro_torch.models import lm
    return sum(p.numel() for p in
               lm.LM(cfg, device="meta", seed=None).parameters())


def cell_plan(arch: str, shape: str, mesh):
    """The reference's plan for a cell: a decode cell whose global batch
    does not divide 16 shards its sequence on "data"; serving keeps
    resident (non-FSDP) weights iff the TP-only shard of the *full*
    registry config (``diff_cell`` traces cut variants and must use the
    full cell's plan) is at most :data:`RESIDENT_MAX_BYTES`."""
    from repro_torch.distributed import sharding as shd
    cell = shapelib.SHAPES[shape]
    seq_axis = "data" if (cell.kind == "decode"
                          and cell.global_batch % 16 != 0) else None
    fsdp = True
    if cell.kind == "decode":
        n_par = _num_params(cfglib.get_config(arch))
        fsdp = n_par * 2 / 16 > RESIDENT_MAX_BYTES
    return shd.ParallelPlan.for_mesh(mesh, fsdp=fsdp, seq_shard_axis=seq_axis)


def _spec_parts(spec, sizes) -> int:
    parts = 1
    for entry in spec:
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None:
                parts *= sizes[ax]
    return parts


def state_bytes(arch: str, shape: str, mesh, cfg=None, plan=None) -> dict:
    """``num_params`` and the per-device parameter, optimizer (train) and
    cache (decode) bytes of a cell from its specs: each tensor's bytes
    floor-divided by the mesh dims its spec shards it on, the reference's
    ``sharded_bytes``. ``mesh``: a ``DeviceMesh``, or any object with the
    reference mesh's ``axis_names`` and ``devices.shape``.

    The port's state differs from the reference's in layout only: its
    layers are unstacked (the same bytes, as every sharded dim divides;
    the int8 moments of a period slot's layers are scaled as one, as the
    reference's stacked moment is, and its one fp32 scale is counted
    once), and its AdamW step and decode length are host ints (the
    reference adds a 4-byte device scalar of each)."""
    import torch

    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import step as steplib
    from repro_torch.models import lm
    cfg = cfg if cfg is not None else cfglib.get_config(arch)
    plan = plan if plan is not None else cell_plan(arch, shape, mesh)
    cell = shapelib.SHAPES[shape]
    sizes = shd.mesh_sizes(mesh)
    skeleton = lm.LM(cfg, device="meta", seed=None)
    specs = shd.param_specs(skeleton, plan, mesh)
    params = dict(skeleton.named_parameters())
    out = {"num_params": sum(p.numel() for p in params.values())}
    out["param_bytes_per_device"] = sum(
        p.numel() * p.element_size() // _spec_parts(specs[k], sizes)
        for k, p in params.items())
    if cell.kind == "train":
        sd = STATE_DTYPE.get(arch, "float32")
        moment = sum(p.numel() * _STATE_BYTES[sd]
                     // _spec_parts(specs[k], sizes)
                     for k, p in params.items())
        groups = lm.moment_groups(cfg, params)
        scales = 4 * (len(params) - sum(len(g) - 1 for g in groups)) \
            if sd == "int8" else 0
        out["opt_bytes_per_device"] = 2 * (moment + scales)
    elif cell.kind == "decode":
        st_specs = steplib.decode_state_specs(cfg, mesh, plan,
                                              cell.global_batch,
                                              cell.seq_len)
        state = lm.init_decode_state(cfg, cell.global_batch, cell.seq_len,
                                     getattr(torch, cfg.dtype), device="meta")
        total = 0
        for trees, spec_trees in ((state.lead, st_specs.lead),
                                  (state.period, st_specs.period)):
            for tree, spec_tree in zip(trees, spec_trees):
                for t, spec in zip(tree, spec_tree):
                    total += (t.numel() * t.element_size()
                              // _spec_parts(spec, sizes))
        out["cache_bytes_per_device"] = total
    return out


# ---------------------------------------------------------------------------
# the fake world and the trace
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(world: int):
    """A fake process group of ``world`` ranks with this process as rank 0
    (no communication: each collective gives a tensor of its output's
    shape), destroyed on exit so that the next cell can start one."""
    import torch.distributed as dist
    import torch.distributed._tools.fake_collectives  # noqa: F401 (fakes)
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process of its own: "
                           "torch.distributed is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _strided_index_math_on_host():
    """DTensor works out a strided shard's rows
    (``_StridedShard.local_shard_size_and_offset``) from an index tensor
    it builds from sizes alone and reads on the host; under a fake mode
    that tensor is fake and holds no values. Inside, that arithmetic runs
    outside the fake mode, on real host tensors."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types as pt
    cls = getattr(pt, "_StridedShard", None)
    orig = getattr(cls, "local_shard_size_and_offset", None)
    if orig is None:
        yield
        return

    @functools.lru_cache(maxsize=None)
    def cached(*args):
        with unset_fake_temporarily():
            return orig(*args)

    def on_host(self, size, num_chunks, rank, *mode, **kw):
        # sizes only (ints) when DTensor costs its strategies: the same
        # few shapes, asked again for every layer
        if kw or not all(isinstance(v, int) for v in (size, num_chunks,
                                                       rank)):
            with unset_fake_temporarily():
                return orig(self, size, num_chunks, rank, *mode, **kw)
        return cached(self, size, num_chunks, rank, *mode)
    cls.local_shard_size_and_offset = on_host
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = orig


def _local_bytes(tree) -> int:
    from repro_torch.launch.tally import _local, _tensors
    return sum(_local(t).numel() * _local(t).element_size()
               for t in _tensors(tree))


def _device_memory(device) -> tuple:
    import torch
    if device.type == "cuda":
        return (torch.cuda.get_device_properties(device).total_memory,
                f"torch.cuda.get_device_properties: "
                f"{torch.cuda.get_device_name(device)}")
    return H100_BYTES, "H100 SXM 80 GB (traced on the CPU)"


def _place_batch(specs: dict, mesh, plan, device) -> dict:
    """Zero stand-ins of the cell's inputs placed on the mesh as the
    reference's ``shardings_for`` places them (("batch", "seq") leading
    dims)."""
    import torch

    from repro_torch.distributed import sharding as shd
    out = {}
    for k, v in specs.items():
        t = torch.zeros(v.shape, dtype=v.dtype, device=device)
        axes = ("batch", "seq") + (None,) * (t.dim() - 2)
        out[k] = shd.place_tensor(t, mesh, shd.placements(
            shd.spec_for_axes(axes, t.shape, plan, mesh), mesh))
    return out


def trace_step(kind: str, cfg, mesh, plan, specs: dict, device, *,
               train_config=None, batch: int = None, max_len: int = None):
    """One step of ``kind`` ("train", "prefill" or "decode") on fake
    tensors: build the LM (seeded, on ``device``), place it, run the step
    of :mod:`repro_torch.distributed.step` on ``specs``-shaped zero inputs
    under a :class:`~repro_torch.launch.tally.StepTally`. Returns
    ``(tally, local state bytes)``. Runs inside :func:`fake_world`."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import step as steplib
    from repro_torch.launch.tally import StepTally
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    local = {}
    with _strided_index_math_on_host(), \
            FakeTensorMode(allow_non_fake_inputs=True):
        tally = StepTally(memory=True)
        model = lm.LM(cfg, device=device, seed=SEED)
        if kind == "train":
            ts = train_config or steplib.TrainStepConfig()
            params = {k: p.detach().requires_grad_()
                      for k, p in model.named_parameters()}
            del model
            opt = adamw.init(params, ts.opt)
            fn, shardings_for = steplib.build_train_step(cfg, mesh, plan, ts)
            psh, osh, _, _ = shardings_for(
                params, opt, {k: tuple(v.shape) for k, v in specs.items()})
            params, opt = steplib.shard_state(params, opt, psh, osh, mesh)
            data = _place_batch(specs, mesh, plan, device)
            local["param"] = _local_bytes(params)
            # an int8 period slot's layers each hold the slot's scale,
            # which the reference's stacked moment holds once: counted once
            dup = sum(len(g) - 1 for g in lm.moment_groups(cfg, params)) \
                if ts.opt.state_dtype == "int8" else 0
            local["opt"] = _local_bytes((opt.mu, opt.nu)) - 2 * 4 * dup
            tally.resident(params, "params")
            tally.resident((opt.mu, opt.nu), "optimizer")
            tally.resident(data, "activations")
            hooks = tally.grads_of(params)
            with tally:
                fn(params, opt, data, 0)
            for h in hooks:
                h.remove()
        elif kind == "prefill":
            shd.distribute(model, plan, mesh)
            model.requires_grad_(False)
            prefill = steplib.build_prefill_step(cfg, mesh, plan,
                                                 remat_policy="none")
            data = _place_batch({k: v for k, v in specs.items()
                                 if k != "labels"}, mesh, plan, device)
            local["param"] = _local_bytes(dict(model.named_parameters()))
            tally.resident(dict(model.named_parameters()), "params")
            tally.resident(data, "activations")
            with tally:
                prefill(model, data)
        else:
            shd.distribute(model, plan, mesh)
            model.requires_grad_(False)
            serve, shardings_for = steplib.build_serve_step(
                cfg, mesh, plan, batch, max_len)
            state = steplib.shard_decode_state(
                lm.init_decode_state(cfg, batch, max_len,
                                     getattr(torch, cfg.dtype),
                                     device=device),
                shardings_for(None)[2], mesh)
            tokens = torch.zeros(specs["tokens"].shape,
                                 dtype=specs["tokens"].dtype, device=device)
            local["param"] = _local_bytes(dict(model.named_parameters()))
            local["cache"] = _local_bytes((state.lead, state.period))
            tally.resident(dict(model.named_parameters()), "params")
            tally.resident((state.lead, state.period), "cache")
            with tally:
                serve(model, tokens, state)
    return tally, local


def _resolve(device):
    import torch

    from repro_torch.core.device import resolve_device
    return resolve_device(None if device is None else torch.device(device),
                          "the dry run")


def run_cell(arch: str, shape: str, multi_pod: bool = False,
             verbose: bool = True, cfg=None, device=None, mesh_shape=None):
    """Trace one cell and return its record. ``cfg`` overrides the
    registry config (a cut depth; the plan stays the full cell's);
    ``device``: "cuda" (None) or "cpu"; ``mesh_shape``: a (data, model)
    mesh instead of the production one."""
    from repro_torch.distributed import step as steplib
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.optim import adamw
    cfg = cfg if cfg is not None else cfglib.get_config(arch)
    skip = shapelib.cell_applicable(cfg, shape)
    mesh_name = ("x".join(map(str, mesh_shape)) if mesh_shape
                 else "multi" if multi_pod else "single")
    result = {"arch": arch, "shape": shape, "mesh": mesh_name}
    if skip:
        result["status"] = "skipped"
        result["reason"] = skip
        return result
    dev = _resolve(device)
    cell = shapelib.SHAPES[shape]
    world = math.prod(mesh_shape) if mesh_shape else (512 if multi_pod
                                                      else 256)
    result.update(device=str(dev.type), world=world,
                  layers=cfg.num_layers)
    with fake_world(world):
        mesh = (make_host_mesh(*mesh_shape, device_type=dev.type)
                if mesh_shape else
                make_production_mesh(multi_pod=multi_pod,
                                     device_type=dev.type))
        plan = cell_plan(arch, shape, mesh)
        result["plan"] = {"fsdp": plan.fsdp,
                          "seq_shard_axis": plan.seq_shard_axis}
        want = state_bytes(arch, shape, mesh, cfg=cfg, plan=plan)
        ts = steplib.TrainStepConfig(
            opt=adamw.AdamWConfig(state_dtype=STATE_DTYPE.get(arch,
                                                              "float32")),
            remat_policy="full", moe_impl="capacity")
        t0 = time.time()
        tally, local = trace_step(
            cell.kind, cfg, mesh, plan, shapelib.input_specs(cfg, shape),
            dev, train_config=ts, batch=cell.global_batch,
            max_len=cell.seq_len)
        result["trace_s"] = round(time.time() - t0, 2)
    got = {"param_bytes_per_device": local["param"]}
    if "opt" in local:
        got["opt_bytes_per_device"] = local["opt"]
    if "cache" in local:
        got["cache_bytes_per_device"] = local["cache"]
    for k, v in got.items():
        if v != want[k]:
            raise AssertionError(f"{arch} × {shape}: the local shards hold "
                                 f"{v} B of {k}, the specs say {want[k]}")
    result.update(want)
    result["flops"] = tally.flops
    result["cost_analysis"] = {"flops": float(tally.flops)}
    result["collectives"] = tally.collectives()
    result["kernels"] = dict(tally.kernels)
    mem = tally.memory()
    cap, source = _device_memory(dev)
    mem.update(device_bytes=cap, device=source,
               fits=mem["peak_bytes"] <= cap)
    result["memory"] = mem
    result["status"] = "ok"
    if verbose:
        print(f"[{arch} × {shape} × {mesh_name}] OK "
              f"trace={result['trace_s']}s flops={tally.flops:.3e} "
              f"coll={result['collectives']['total_bytes']:.3e}B "
              f"peak={mem['peak_bytes']:.3e}B fits={mem['fits']}",
              flush=True)
    return result


def diff_cell(arch: str, shape: str, multi_pod: bool = False,
              verbose: bool = True, device=None, mesh_shape=None):
    """The reference's roofline differencing: the cell with 1 and 2 scan
    periods (after the dense lead), and the per-period FLOPs and
    collective bytes. An eager trace under-reports no loop, so this is
    kept for parity (a period's share of the full cell)."""
    from repro_torch.models import lm
    cfg = cfglib.get_config(arch)
    if shapelib.cell_applicable(cfg, shape):
        return {"arch": arch, "shape": shape, "status": "skipped"}
    _, period_kinds, n_periods = lm.stack_plan(cfg)
    p = max(len(period_kinds), 1)
    lead = cfg.first_dense
    out = {"arch": arch, "shape": shape,
           "mesh": "multi" if multi_pod else "single",
           "n_periods_full": n_periods, "period_len": p}
    for k in (1, 2):
        sub = dataclasses.replace(cfg, num_layers=lead + k * p,
                                  unroll_layers=True)
        res = run_cell(arch, shape, multi_pod, verbose=False, cfg=sub,
                       device=device, mesh_shape=mesh_shape)
        out[f"flops_{k}p"] = float(res["flops"])
        out[f"coll_{k}p"] = float(res["collectives"]["total_bytes"])
    out["status"] = "ok"
    if verbose:
        print(f"[diff {arch} × {shape}] per-period "
              f"flops={out['flops_2p'] - out['flops_1p']:.3e} "
              f"coll={out['coll_2p'] - out['coll_1p']:.3e}B", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=cfglib.ARCH_NAMES)
    ap.add_argument("--shape", choices=shapelib.SHAPE_NAMES)
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--diff", action="store_true",
                    help="roofline differencing mode (1 and 2 periods)")
    ap.add_argument("--out", default=None,
                    help="the record's file, or a directory for them")
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card) or cpu")
    args = ap.parse_args(argv)

    if args.list:
        for a in cfglib.ARCH_NAMES:
            cfg = cfglib.get_config(a)
            for s in shapelib.SHAPE_NAMES:
                skip = shapelib.cell_applicable(cfg, s)
                print(f"{a:24s} {s:12s} "
                      f"{'SKIP: ' + skip if skip else 'run'}")
        return

    cells = []
    if args.all:
        for a in cfglib.ARCH_NAMES:
            for s in shapelib.SHAPE_NAMES:
                for m in (False, True):
                    cells.append((a, s, m))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all, --list)")
        cells.append((args.arch, args.shape, args.mesh == "multi"))

    failures = 0
    for a, s, m in cells:
        tag = f"{a}__{s}__{'multi' if m else 'single'}"
        base = DIFF_DIR if args.diff else RESULTS_DIR
        if args.out:
            out_path = pathlib.Path(args.out)
            if out_path.is_dir():
                out_path = out_path / f"{tag}.json"
        else:
            base.mkdir(parents=True, exist_ok=True)
            out_path = base / f"{tag}.json"
        try:
            res = (diff_cell(a, s, m, device=args.device) if args.diff
                   else run_cell(a, s, m, device=args.device))
        except Exception as e:  # noqa: BLE001 — recorded per cell
            res = {"arch": a, "shape": s,
                   "mesh": "multi" if m else "single",
                   "status": "error", "error": repr(e),
                   "traceback": traceback.format_exc()}
            failures += 1
            print(f"[{tag}] FAILED: {e!r}", flush=True)
        out_path.write_text(json.dumps(res, indent=2))
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()

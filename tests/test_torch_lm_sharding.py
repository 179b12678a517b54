"""The port's LM sharding on the CPU, against the reference.

Specs, exactly: ``spec_for_axes``, ``param_specs``, ``decode_state_specs``
and ``batch_spec`` against the reference's for the ten ``reduced()`` archs
on (2, 2), (2, 4), (1, 4) and the pod layout (2, 2, 2), FSDP on and off,
``seq_shard_axis`` None and "model" (the reference's functions read only a
mesh's ``axis_names`` and ``devices.shape``, so both take a duck-typed
mesh); every parameter's logical axes against the reference's
``effective_axes``.

A module-scoped fixture runs this file as a script, once: 4 gloo ranks
(one thread each, a ``FileStore``, a process-group timeout) build 2 × 2,
1 × 4, 4 × 1 and (1, 1, 4) pipe meshes over the same world and write
their results to npz files; beside them a JAX subprocess (this file with
``--jax``) forces 4 host devices and runs the reference's
``moe_shard_map``, ``tp_out_project`` (2 × 2) and ``pipeline_forward`` (4
stages). Weights come from the reference's ``init`` through
``from_jax_lm_params``; inputs from numpy seeds. The ranks route their
functional all-gathers through c10d's (``route_all_gather("CPU")``), the
path the card takes under gloo. The cases hold:

  * ``moe_shard_map`` (capacity_factor 8: nothing drops) against the
    reference's and against ``moe_capacity``: output within 1e-4,
    gradients of the parameters and x within 2e-3; E not dividing the
    mesh takes the global path;
  * ``moe(impl="ragged")`` on the mesh (``moe_ragged_shard_map``, and
    the replicated ``moe_ragged`` where E = 3 does not divide "model")
    against the reference's ``moe(impl="ragged")`` under its host mesh
    (GSPMD): output and aux within 1e-4, the five gradients within 2e-3;
  * ``tp_out_project`` against ``x @ w`` and the reference's, 1e-4;
  * the sharded train step on 2 × 2, 2 steps (the warmup's lr is 0 at
    step 0), against the reference's single-device ``loss_fn`` +
    ``adamw.update`` under ``warmup_cosine``: the loss within 1e-4
    relative, gathered gradients and parameters within 2e-3, a dense and a
    MoE config, the MoE one also with ``moe_impl="ragged"``; int8 moments:
    the payload sharded as its parameter, the scale replicated and taken
    over the whole period slot;
  * the sharded prefill and 4 decode steps against the reference's
    single-device ``forward`` / ``decode_step``, 2e-3, a 1 × 4 case whose
    KV heads do not divide "model" (the sequence-sharded cache), and the
    MoE config's with ``moe_impl="ragged"``;
  * ``fit(LMTask, mesh=)`` 3 steps against ``repro.fit``, 2e-3, a dense
    config and the MoE one with ``moe_impl="ragged"`` on both sides;
    ``launch.train.main(["--mesh", "host", ...])`` 3 steps, and 2 steps
    of ``--moe-impl ragged`` on the reduced MoE arch against the same
    command on one device, 2e-3;
  * ``pipeline_forward`` against the reference's and the stages in
    sequence, 1e-5; the elastic restore 2 × 2 → 4 × 1, bitwise; every
    parameter held as its share.

    python tests/test_torch_lm_sharding.py OUTDIR          # the gloo ranks
    python tests/test_torch_lm_sharding.py --jax OUTDIR    # the reference
"""
import dataclasses
import datetime
import os
import pathlib
import subprocess
import sys
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as cfglib  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT_S = 240
SPEC_MESHES = {"2x2": ((2, 2), ("data", "model")),
               "2x4": ((2, 4), ("data", "model")),
               "1x4": ((1, 4), ("data", "model")),
               "pod": ((2, 2, 2), ("pod", "data", "model"))}
TRAIN_CFG = dict(lr=1e-3, warmup=1, total=10)
SERVE_CASES = (("dense", (2, 2)), ("moe", (2, 2)), ("dense", (1, 4)),
               ("jamba", (2, 2)), ("rwkv", (2, 2)))
LM_NAMES = ("dense", "moe", "jamba", "rwkv")
BATCH, SEQ, DECODE, MAX_LEN = 4, 8, 4, 16
FIT_STEPS = 3
FIT_CASES = (("dense", "capacity"), ("moe", "ragged"))
RAGGED_SERVE = ("moe", (2, 2))
RAGGED_LAUNCH = ["--arch", "qwen3-moe-30b-a3b", "--reduced", "--device",
                 "cpu", "--moe-impl", "ragged", "--steps", "2", "--batch",
                 "4", "--seq", "8", "--log-every", "0"]


def _cfgs(lib):
    """The reduced configs of the cases, from ``lib`` (either package's
    ``configs``)."""
    moe = lib.get_config("qwen3-moe-30b-a3b").reduced(capacity_factor=8.0)
    return {"dense": lib.get_config("qwen3-8b").reduced(), "moe": moe,
            "moe3": dataclasses.replace(moe, num_experts=3),
            "jamba": lib.get_config("jamba-v0.1-52b").reduced(),
            "rwkv": lib.get_config("rwkv6-3b").reduced()}


def _inputs():
    rng = np.random.default_rng(11)
    f32 = np.float32
    return {"moe_x": rng.standard_normal((4, 16, 64)).astype(f32),
            "tp_x": rng.standard_normal((8, 16, 32)).astype(f32),
            "tp_w": rng.standard_normal((32, 24)).astype(f32),
            "pp_w": (rng.standard_normal((4, 16, 16)) * 0.3).astype(f32),
            "pp_x": rng.standard_normal((8, 4, 16)).astype(f32),
            "tokens": rng.integers(0, 256, (BATCH, SEQ + DECODE),
                                   dtype=np.int32)}


def _flat(tree, prefix="", out=None):
    """A nested dict / list of arrays as ``{"a/#0/b": array}``."""
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flat(v, f"{prefix}#{i}/", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflat(flat):
    root: dict = {}
    for key, arr in flat.items():
        node, parts = root, key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            return [lists(node[f"#{i}"]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(root)


def _load_tree(out, name):
    tree = _unflat(dict(np.load(out / f"params_{name}.npz")))
    for key in ("lead", "period"):           # empty lists hold no arrays
        tree.setdefault(key, [])
    return tree


# ---------------------------------------------------------------------------
# the ranks (script mode)
# ---------------------------------------------------------------------------

def _raises(exc, fn) -> int:
    try:
        fn()
    except exc:
        return 1
    return 0


def _full(t):
    return t.full_tensor().detach().numpy() if hasattr(t, "full_tensor") \
        else t.detach().numpy()


def _rank_moe(res, inp, out, mesh, plan):
    from repro_torch import configs
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.params import P, Params
    cfgs = _cfgs(configs)
    for name in ("moe", "moe3"):
        cfg = cfgs[name]
        tree = dict(np.load(out / f"moe_{name}.npz"))
        prm = shd.distribute(Params(**{
            k: P(torch.from_numpy(tree[k]), ax)
            for k, ax in (("router", ("embed", "expert")),
                          ("w_up", ("expert", "embed", "mlp")),
                          ("w_gate", ("expert", "embed", "mlp")),
                          ("w_down", ("expert", "mlp", "embed")))}),
            plan, mesh)
        leaves = dict(prm.named_parameters())
        for leaf in leaves.values():
            leaf.requires_grad_()
        x = shd.place_tensor(torch.from_numpy(inp["moe_x"]), mesh,
                             shd.placements(("data", None, None), mesh))
        x.requires_grad_()
        for impl, key in (("capacity", name), ("ragged", f"{name}_ragged")):
            with shd.activation_sharding(mesh, plan):
                y, aux = moe_lib.moe(prm, x, cfg, impl=impl)
                grads = torch.autograd.grad((y ** 2).sum(),
                                            [x] + list(leaves.values()))
            res[f"{key}_y"] = _full(y)
            res[f"{key}_aux"] = _full(aux)
            for k, g in zip(["x"] + list(leaves), grads):
                res[f"{key}_g_{k}"] = _full(g)
        with shd.activation_sharding(mesh, plan):
            # the kernels or nothing: no plain version for CPU tensors
            res[f"{name}_cuda_refuses_cpu"] = _raises(
                ValueError, lambda: moe_lib.moe(prm, x, cfg, impl="cuda"))


def _rank_tp(res, inp, mesh, plan):
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import layers
    axes = ("heads", "embed")
    x, w = torch.from_numpy(inp["tp_x"]), torch.from_numpy(inp["tp_w"])
    res["tp_plain_ctx_free"] = layers.tp_out_project(x, w, axes).numpy()
    wd = shd.place_tensor(w, mesh, shd.placements(
        shd.spec_for_axes(axes, w.shape, plan, mesh), mesh))
    xd = shd.place_tensor(x, mesh, shd.placements(("data", None, "model"),
                                                  mesh))
    with shd.activation_sharding(mesh, plan):
        res["tp"] = _full(layers.tp_out_project(xd, wd, axes))
        res["tp_from_plain_x"] = layers.tp_out_project(x, wd, axes).numpy()


def _rank_train(res, out, mesh, plan, rank):
    from repro_torch import configs
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import step as steplib
    from repro_torch.models import lm
    from repro_torch.models.params import from_jax_lm_params
    from repro_torch.optim import adamw
    cfgs = _cfgs(configs)
    batch = dict(np.load(out / "train_batch.npz"))
    sizes = shd.mesh_sizes(mesh)
    for name, sd, impl in (("dense", "float32", "capacity"),
                           ("moe", "float32", "capacity"),
                           ("moe", "float32", "ragged"),
                           ("dense", "int8", "capacity")):
        cfg = cfgs[name]
        key = name if sd == "float32" else f"{name}_int8"
        key += "_ragged" if impl == "ragged" else ""
        model = from_jax_lm_params(cfg, _load_tree(out, name), device="cpu")
        params = {k: p.detach().clone().requires_grad_()
                  for k, p in model.named_parameters()}
        ts = steplib.TrainStepConfig(
            opt=adamw.AdamWConfig(lr=TRAIN_CFG["lr"], state_dtype=sd),
            warmup_steps=TRAIN_CFG["warmup"],
            total_steps=TRAIN_CFG["total"], remat_policy="none",
            moe_impl=impl)
        opt = adamw.init(params, ts.opt)
        fn, shardings_for = steplib.build_train_step(cfg, mesh, plan, ts)
        psh, osh, bsh, _ = shardings_for(params, opt, {
            k: v.shape for k, v in batch.items()})
        sp, so = steplib.shard_state(params, opt, psh, osh, mesh)
        sb = {k: shd.place_tensor(torch.from_numpy(v), mesh, bsh[k])
              for k, v in batch.items()}
        if sd == "float32":
            # step 0's gradients, gathered, through the step's own path
            with shd.activation_sharding(mesh, plan):
                loss, _ = lm.loss_fn(sp, cfg, sb, remat_policy="none",
                                     moe_impl=impl)
                grads = torch.autograd.grad(steplib._whole(loss),
                                            list(sp.values()))
            for k, g in zip(sp, grads):
                res[f"train_{key}_g0_{k}"] = _full(g)
        steps = 2 if sd == "float32" else 1
        losses = []
        for step in range(steps):
            sp, so, metrics = fn(sp, so, sb, step)
            losses.append(float(metrics["loss"]))
        res[f"train_{key}_losses"] = np.asarray(losses)
        for k, p in sp.items():
            res[f"train_{key}_p_{k}"] = _full(p)
        if sd == "int8":
            specs = shd.param_specs(model, plan, mesh)
            layout = scale_rep = 1
            for k, m in list(so.mu.items()) + list(so.nu.items()):
                layout &= list(m.q.placements) == list(sp[k].placements)
                parts = int(np.prod([sizes[a] for e in specs[k]
                                     for a in ((e,) if isinstance(e, str)
                                               else (e or ()))]))
                layout &= m.q.to_local().numel() * parts == m.q.numel()
                scale_rep &= all(p.is_replicate() for p in m.scale.placements)
            res["int8_layout"] = layout
            res["int8_scale_replicated"] = scale_rep
            names = sorted(so.mu)
            res["int8_scales"] = np.asarray(
                [float(so.mu[k].scale.to_local()) for k in names]
                + [float(so.nu[k].scale.to_local()) for k in names])
            res["int8_max_q"] = np.asarray(
                [int(so.mu[k].q.full_tensor().abs().max()) for k in names])
            res["int8_mu"] = np.concatenate(
                [(so.mu[k].q.full_tensor().float()
                  * so.mu[k].scale.full_tensor()).reshape(-1).numpy()
                 for k in names])


def _rank_serve(res, out, rank):
    from repro_torch import configs
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import step as steplib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.models.params import from_jax_lm_params
    cfgs = _cfgs(configs)
    tokens = torch.from_numpy(_inputs()["tokens"]).long()
    for name, shape, impl in [c + ("capacity",) for c in SERVE_CASES] + [
            RAGGED_SERVE + ("ragged",)]:
        key = f"{name}_{shape[0]}x{shape[1]}"
        key = key if impl == "capacity" else f"{key}_{impl}"
        mesh = make_host_mesh(*shape, device_type="cpu")
        plan = shd.ParallelPlan.for_mesh(mesh)
        cfg = cfgs[name]
        model = shd.distribute(from_jax_lm_params(
            cfg, _load_tree(out, name), device="cpu"), plan, mesh)
        prefill = steplib.build_prefill_step(cfg, mesh, plan, moe_impl=impl)
        res[f"prefill_{key}"] = _full(prefill(model,
                                              {"tokens": tokens[:, :SEQ]}))
        serve, shardings_for = steplib.build_serve_step(
            cfg, mesh, plan, BATCH, MAX_LEN, moe_impl=impl)
        specs = shardings_for(model)[2]
        res[f"kv_spec_{key}"] = np.asarray(repr((specs.lead
                                                 or specs.period)[0][0]))
        state = steplib.shard_decode_state(
            lm.init_decode_state(cfg, BATCH, MAX_LEN, torch.float32,
                                 device="cpu"), specs, mesh)
        for i in range(DECODE):
            logits, state = serve(model, tokens[:, i:i + 1], state)
            res[f"decode_{key}_{i}"] = _full(logits)


def _rank_fit_and_launch(res, out, mesh, rank):
    from repro_torch import configs, train
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.data.tokens import TokenDatasetConfig
    from repro_torch.launch import train as launch_train
    from repro_torch.models.params import from_jax_lm_params
    from repro_torch.optim import adamw
    for name, impl in FIT_CASES:
        cfg = _cfgs(configs)[name]
        key = "" if name == "dense" else f"_{name}_{impl}"
        model = from_jax_lm_params(cfg, _load_tree(out, f"fit{key}"),
                                   device="cpu")
        params = {k: p.detach().clone().requires_grad_()
                  for k, p in model.named_parameters()}
        opt = adamw.AdamWConfig(lr=1e-3, weight_decay=0.01)
        state = train.TrainState(params, adamw.init(params, opt), 0,
                                 torch.Generator().manual_seed(0).get_state())
        data = train.TokenProvider(TokenDatasetConfig(
            vocab_size=cfg.vocab_size, seq_len=8, global_batch=4, seed=1))
        ckpt_dir = out / f"fit_ckpt{key}"
        run = train.fit(train.LMTask(cfg, moe_impl=impl, device="cpu"), data,
                        train.TrainerConfig(steps=FIT_STEPS, opt=opt,
                                            warmup_steps=2, seed=0,
                                            ckpt_dir=str(ckpt_dir),
                                            ckpt_every=2),
                        mesh=mesh, state=state)
        res[f"fit_losses{key}"] = np.asarray(run.losses)
        res[f"fit_ckpt{key}"] = np.asarray([
            ckpt.latest_step(str(ckpt_dir / f"rank{rank}")) or -1,
            ckpt.latest_step(str(ckpt_dir)) or -1])
    losses = launch_train.main([
        "--arch", "qwen3-8b", "--reduced", "--device", "cpu", "--mesh",
        "host", "--steps", "3", "--batch", "4", "--seq", "8", "--ckpt-dir",
        str(out / "launch_ckpt"), "--log-every", "0"])
    res["launch_losses"] = np.asarray(losses)
    res["launch_ragged_losses"] = np.asarray(launch_train.main(
        RAGGED_LAUNCH + ["--mesh", "host", "--ckpt-dir",
                         str(out / "launch_ragged_ckpt")]))


def _rank_elastic_and_shares(res, out, mesh, plan, rank):
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.models.params import from_jax_lm_params
    cfg = _cfgs(configs)["moe"]
    model = shd.distribute(from_jax_lm_params(cfg, _load_tree(out, "moe"),
                                              device="cpu"), plan, mesh)
    sizes = shd.mesh_sizes(mesh)
    specs = shd.param_specs(model, plan, mesh)
    share = 1
    for k, p in model.named_parameters():
        parts = int(np.prod([sizes[a] for e in specs[k]
                             for a in ((e,) if isinstance(e, str)
                                       else (e or ()))]))
        share &= p.to_local().numel() * parts == p.numel()
    res["shares"] = share
    res["sharded_param_count"] = sum(
        1 for s in specs.values() if any(e is not None for e in s))
    params = dict(model.named_parameters())
    ckpt.save(params, out / "elastic" / f"rank{rank}", 7)
    dist.barrier()
    mesh_b = make_host_mesh(4, 1, device_type="cpu")
    plan_b = shd.ParallelPlan.for_mesh(mesh_b)
    psh_b = shd.param_shardings(lm.LM(cfg, device="meta", seed=None),
                                plan_b, mesh_b)
    target = {k: torch.empty(p.shape) for k, p in params.items()}
    got = ckpt.restore(target, out / "elastic" / "rank0", shardings={
        k: ckpt.Sharding(mesh_b, tuple(psh_b[k])) for k in target})
    res["elastic_bitwise"] = int(all(
        torch.equal(got[k].full_tensor(), params[k].full_tensor())
        and list(got[k].placements) == psh_b[k] for k in params))
    same = ckpt.restore(params, out / "elastic" / f"rank{rank}", 7)
    res["restore_same_mesh"] = int(all(
        torch.equal(same[k].to_local(), params[k].to_local())
        and same[k].placements == params[k].placements for k in params))


def _rank_pipeline(res, inp):
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(1, 1, pipe=4, device_type="cpu")
    res["pipeline"] = pipeline_forward(
        lambda w, x: torch.tanh(x @ w), torch.from_numpy(inp["pp_w"]),
        torch.from_numpy(inp["pp_x"]), mesh=mesh).numpy()


def _rank_main(rank: int, outdir: str):
    import torch.distributed as dist
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.collectives import route_all_gather
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    out = pathlib.Path(outdir)
    res = {"refuse_uninit": _raises(
        RuntimeError, lambda: make_host_mesh(2, 2, device_type="cpu"))}
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(out / "store"), WORLD),
        rank=rank, world_size=WORLD, timeout=datetime.timedelta(seconds=90))
    try:
        route_all_gather("CPU")
        res["refuse_size"] = _raises(
            ValueError, lambda: make_host_mesh(2, 4, device_type="cpu"))
        inp = _inputs()
        mesh = make_host_mesh(2, 2, device_type="cpu")
        plan = shd.ParallelPlan.for_mesh(mesh)
        t0 = time.perf_counter()
        for part, fn in (
                ("moe", lambda: _rank_moe(res, inp, out, mesh, plan)),
                ("tp", lambda: _rank_tp(res, inp, mesh, plan)),
                ("train", lambda: _rank_train(res, out, mesh, plan, rank)),
                ("serve", lambda: _rank_serve(res, out, rank)),
                ("fit", lambda: _rank_fit_and_launch(res, out, mesh, rank)),
                ("elastic", lambda: _rank_elastic_and_shares(
                    res, out, mesh, plan, rank)),
                ("pipeline", lambda: _rank_pipeline(res, inp))):
            fn()
            if rank == 0:
                print(f"{part}: {time.perf_counter() - t0:.1f} s", flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(out / f"r{rank}.npz", **res)


def _run_ranks(outdir: str) -> int:
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, outdir))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT_S - 20
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    codes = [p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    print("rank exit codes:", codes, flush=True)
    return 0 if all(c == 0 for c in codes) else 1


def _run_jax(outdir: str) -> None:
    """The reference's shard_map regions on 4 host devices."""
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=4")
    import jax
    import jax.numpy as jnp

    from repro import configs as jcfglib
    from repro.distributed import pipeline
    from repro.distributed import sharding as jshd
    from repro.launch.mesh import make_host_mesh
    from repro.models import layers as jlayers
    from repro.models import moe as jmoe
    from repro.models.params import P
    out = pathlib.Path(outdir)
    inp = _inputs()
    res = {}
    cfg = _cfgs(jcfglib)["moe"]
    tree = dict(np.load(out / "moe_moe.npz"))
    tmpl = jmoe.moe_init(jax.random.PRNGKey(0), cfg, jnp.float32)
    prm = {k: P(jnp.asarray(tree[k]), p.axes) for k, p in tmpl.items()}
    x = jnp.asarray(inp["moe_x"])
    mesh = make_host_mesh(2, 2)
    plan = jshd.ParallelPlan.for_mesh(mesh)

    def loss(p, x):
        with jshd.activation_sharding(mesh, plan):
            y, _ = jmoe.moe_shard_map(p, x, cfg)
        return jnp.sum(y ** 2), y

    with mesh:
        (_, y), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                               has_aux=True))(prm, x)
    res["moe_y"] = np.asarray(y)
    res["moe_g_x"] = np.asarray(g[1])
    for k in prm:
        res[f"moe_g_{k}"] = np.asarray(g[0][k].value)
    for name in ("moe", "moe3"):
        # the dropless layer under the mesh: GSPMD partitions moe_ragged
        rcfg = _cfgs(jcfglib)[name]
        tree = dict(np.load(out / f"moe_{name}.npz"))
        rprm = {k: P(jnp.asarray(tree[k]), p.axes) for k, p in
                jmoe.moe_init(jax.random.PRNGKey(0), rcfg,
                              jnp.float32).items()}

        def ragged(p, x, rcfg=rcfg):
            with jshd.activation_sharding(mesh, plan):
                y, aux = jmoe.moe(p, x, rcfg, impl="ragged")
            return jnp.sum(y ** 2), (y, aux)

        with mesh:
            (_, (y, aux)), g = jax.jit(jax.value_and_grad(
                ragged, argnums=(0, 1), has_aux=True))(rprm, x)
        key = f"{name}_ragged"
        res[f"{key}_y"], res[f"{key}_aux"] = np.asarray(y), np.asarray(aux)
        res[f"{key}_g_x"] = np.asarray(g[1])
        for k in rprm:
            res[f"{key}_g_{k}"] = np.asarray(g[0][k].value)
    w = P(jnp.asarray(inp["tp_w"]), ("heads", "embed"))
    with mesh, jshd.activation_sharding(mesh, plan):
        res["tp"] = np.asarray(jax.jit(
            lambda x, wv: jlayers.tp_out_project(x, P(wv, w.axes)))(
                jnp.asarray(inp["tp_x"]), w.value))
    pipe = jax.make_mesh((4,), ("pipe",))
    res["pipeline"] = np.asarray(pipeline.pipeline_forward(
        lambda w, x: jnp.tanh(x @ w), jnp.asarray(inp["pp_w"]),
        jnp.asarray(inp["pp_x"]), mesh=pipe, axis="pipe"))
    np.savez(out / "jax.npz", **res)


# ---------------------------------------------------------------------------
# the fixture: the reference's weights in, both subprocesses, the references
# ---------------------------------------------------------------------------

def _jtree_np(tree):
    import jax
    from repro.models.params import P
    return jax.tree_util.tree_map(lambda p: np.asarray(p.value), tree,
                                  is_leaf=lambda x: isinstance(x, P))


def _fit_pair(name, impl):
    from repro import configs as jcfglib
    from repro import train as jtrain
    from repro.data import tokens as jtokens
    from repro.optim import adamw as jadamw
    cfg = _cfgs(jcfglib)[name]
    return jtrain.Trainer(
        jtrain.LMTask(cfg, moe_impl=impl),
        jtrain.TokenProvider(jtokens.TokenDatasetConfig(
            vocab_size=cfg.vocab_size, seq_len=8, global_batch=4, seed=1)),
        jtrain.TrainerConfig(steps=FIT_STEPS, opt=jadamw.AdamWConfig(
            lr=1e-3, weight_decay=0.01), warmup_steps=2, seed=0))


def _references(jparams, moe_prm, batch):
    """The reference's single-device results on the same weights."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jcfglib
    from repro.models import lm as jlm
    from repro.models import moe as jmoe
    from repro.optim import adamw as jadamw
    from repro.optim import schedule as jschedule
    cfgs = _cfgs(jcfglib)
    inp = _inputs()
    ref = {}
    x = jnp.asarray(inp["moe_x"])
    for name in ("moe", "moe3"):
        def loss(p, x, cfg=cfgs[name]):
            y, aux = jmoe.moe_capacity(p, x, cfg)
            return jnp.sum(y ** 2), (y, aux)
        (_, (y, aux)), g = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(moe_prm[name], x)
        ref[f"{name}_y"], ref[f"{name}_aux"] = y, aux
        ref[f"{name}_g_x"] = g[1]
        for k in moe_prm[name]:
            ref[f"{name}_g_{k}"] = g[0][k].value
    ref["tp"] = inp["tp_x"] @ inp["tp_w"]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for name, impl in (("dense", "capacity"), ("moe", "capacity"),
                       ("moe", "ragged")):
        cfg = cfgs[name]
        prm = jparams[name]
        opt_cfg = jadamw.AdamWConfig(lr=TRAIN_CFG["lr"])
        opt = jadamw.init(prm, opt_cfg)
        step_fn = jax.jit(jax.value_and_grad(
            lambda p, cfg=cfg, impl=impl: jlm.loss_fn(
                p, cfg, jb, remat_policy="none", moe_impl=impl),
            has_aux=True))
        name = name if impl == "capacity" else f"{name}_{impl}"
        losses = []
        for step in range(2):
            (loss, _), g = step_fn(prm)
            if step == 0:
                ref[f"train_{name}_g0"] = _jtree_np(g)
            losses.append(float(loss))
            lr = jschedule.warmup_cosine(step, TRAIN_CFG["warmup"],
                                         TRAIN_CFG["total"])
            prm, opt, _ = jadamw.update(g, opt, prm, opt_cfg, lr_scale=lr)
        ref[f"train_{name}_losses"] = np.asarray(losses)
        ref[f"train_{name}_p"] = _jtree_np(prm)
    tokens = jnp.asarray(inp["tokens"])
    for name, impl in [(n, "capacity") for n in LM_NAMES] + [
            (RAGGED_SERVE[0], "ragged")]:
        cfg = cfgs[name]
        key = name if impl == "capacity" else f"{name}_{impl}"
        ref[f"prefill_{key}"], _ = jlm.forward(
            jparams[name], cfg, tokens[:, :SEQ], remat_policy="none",
            moe_impl=impl)
        state = jlm.init_decode_state(cfg, BATCH, MAX_LEN, jnp.float32)
        dec = jax.jit(lambda p, t, s, cfg=cfg, impl=impl: jlm.decode_step(
            p, cfg, t, s, moe_impl=impl))
        for i in range(DECODE):
            logits, state = dec(jparams[name], tokens[:, i:i + 1], state)
            ref[f"decode_{key}_{i}"] = logits
    return {k: (v if isinstance(v, dict) else np.asarray(v))
            for k, v in ref.items()}


@pytest.fixture(scope="module")
def sharding(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from repro import configs as jcfglib
    from repro.models import lm as jlm
    from repro.models import moe as jmoe
    out = tmp_path_factory.mktemp("lm_sharding")
    cfgs = _cfgs(jcfglib)
    jparams = {name: jlm.init(jax.random.PRNGKey(i), cfgs[name])
               for i, name in enumerate(LM_NAMES)}
    for name, prm in jparams.items():
        np.savez(out / f"params_{name}.npz", **_flat(_jtree_np(prm)))
    moe_prm = {name: jmoe.moe_init(jax.random.PRNGKey(5 + i), cfgs[name],
                                   jnp.float32)
               for i, name in enumerate(("moe", "moe3"))}
    for name, prm in moe_prm.items():
        np.savez(out / f"moe_{name}.npz",
                 **{k: np.asarray(p.value) for k, p in prm.items()})
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 256, (BATCH, SEQ), dtype=np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    np.savez(out / "train_batch.npz", **batch)
    pairs = {}
    for name, impl in FIT_CASES:
        key = "" if name == "dense" else f"_{name}_{impl}"
        pair = _fit_pair(name, impl)
        pairs[key] = (pair, pair.init_state())
        np.savez(out / f"params_fit{key}.npz",
                 **_flat(_jtree_np(pairs[key][1].params)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, __file__, *flag, str(out)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for flag in ([], ["--jax"])]
    try:
        ref = _references(jparams, moe_prm, batch)
        for key, (pair, fit_state) in pairs.items():
            ref[f"fit_losses{key}"] = np.asarray(
                pair.fit(state=fit_state).losses)
        from repro_torch.launch import train as launch_train
        ref["launch_ragged_losses"] = np.asarray(launch_train.main(
            RAGGED_LAUNCH + ["--ckpt-dir", str(out / "launch_ragged_one")]))
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-6000:]
    ranks = {r: dict(np.load(out / f"r{r}.npz")) for r in range(WORLD)}
    ranks["jax"] = dict(np.load(out / "jax.npz"))
    return ranks, ref, out


def _named(cfg, tree):
    """A numpy tree shaped as the reference's LM parameters as ``{port
    name: array}``."""
    from repro_torch.models.params import from_jax_lm_params
    return {k: p.detach().numpy() for k, p in from_jax_lm_params(
        cfg, tree, device="cpu").named_parameters()}


# ---------------------------------------------------------------------------
# specs and axes (no ranks)
# ---------------------------------------------------------------------------

def _duck(shape, names):
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape))


def _ref_leaves(tree, cfg):
    """(port name, reference P leaf, stacked) of every parameter of a
    reference LM tree, in the port's layer order."""
    from repro.models import lm as jlm
    from repro.models.params import P
    lead, period, n_periods = jlm.stack_plan(cfg)

    def walk(node, path):
        if isinstance(node, P):
            yield path, node
        elif isinstance(node, dict):
            for k, v in node.items():
                yield from walk(v, f"{path}.{k}" if path else k)
    for key, sub in tree.items():
        if key == "lead":
            for i, blk in enumerate(sub):
                for path, p in walk(blk, f"layers.{i}"):
                    yield path, p, False
        elif key == "period":
            for s, blk in enumerate(sub):
                for pi in range(n_periods):
                    at = len(lead) + pi * len(period) + s
                    for path, p in walk(blk, f"layers.{at}"):
                        yield path, p, True
        elif key == "enc_blocks":
            for i, blk in enumerate(sub):
                for path, p in walk(blk, f"enc_blocks.{i}"):
                    yield path, p, False
        else:
            for path, p in walk(sub, key):
                yield path, p, False


def _shape_tree(jcfg):
    import jax
    from repro.models import lm as jlm
    return jax.eval_shape(lambda k: jlm.init(k, jcfg), jax.random.PRNGKey(0))


@pytest.mark.parametrize("mesh_name", sorted(SPEC_MESHES))
@pytest.mark.parametrize("arch", cfglib.ARCH_NAMES)
def test_specs_match_reference(arch, mesh_name):
    from repro import configs as jcfglib
    from repro.distributed import sharding as jshd
    from repro.distributed import step as jstep
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import step as steplib
    from repro_torch.models import lm
    jcfg, cfg = jcfglib.get_config(arch).reduced(), \
        cfglib.get_config(arch).reduced()
    shape, names = SPEC_MESHES[mesh_name]
    mesh = _duck(shape, names)
    jtree = _shape_tree(jcfg)
    skeleton = lm.LM(cfg, device="meta", seed=None)
    for fsdp in (True, False):
        for seq in (None, "model"):
            jplan = jshd.ParallelPlan.for_mesh(mesh, fsdp, seq)
            plan = shd.ParallelPlan.for_mesh(mesh, fsdp, seq)
            assert dataclasses.asdict(plan) == dataclasses.asdict(jplan)
            got = shd.param_specs(skeleton, plan, mesh)
            seen = set()
            for name, p, stacked in _ref_leaves(jtree, jcfg):
                want = tuple(jshd.spec_for_axes(p.axes, p.value.shape,
                                                jplan, mesh))
                assert got[name] == (want[1:] if stacked else want), name
                seen.add(name)
            assert seen == set(got)
            for axes, shp in ((("batch", "seq", None), (4, 16, 64)),
                              (("batch", None, "act_heads", None),
                               (3, 8, 4, 16)),
                              (("expert", "capacity", None), (8, 32, 64)),
                              (("batch", "seq", "act_vocab"), (2, 6, 256))):
                assert shd.spec_for_axes(axes, shp, plan, mesh) == tuple(
                    jshd.spec_for_axes(axes, shp, jplan, mesh))
            for sharded_seq in (False, True):
                assert shd.batch_spec(plan, mesh, seq_sharded=sharded_seq) \
                    == tuple(jshd.batch_spec(jplan, mesh,
                                             seq_sharded=sharded_seq))
            for batch, max_len in ((4, 16), (3, 16), (1, 32), (2, 6)):
                want = jstep.decode_state_specs(jcfg, mesh, jplan, batch,
                                                max_len)
                got_st = steplib.decode_state_specs(cfg, mesh, plan, batch,
                                                    max_len)
                for wl, gl in ((want.lead, got_st.lead),
                               (want.period, got_st.period)):
                    assert len(wl) == len(gl)
                    for wc, gc in zip(wl, gl):
                        assert type(gc).__name__ == type(wc).__name__
                        assert [tuple(s) for s in wc] == list(gc)
                assert tuple(want.length) == got_st.length == ()


@pytest.mark.parametrize("arch", cfglib.ARCH_NAMES)
def test_logical_axes_match_reference(arch):
    from repro import configs as jcfglib
    from repro.distributed.sharding import effective_axes
    from repro_torch.models import lm
    from repro_torch.models.params import param_axes
    jcfg = jcfglib.get_config(arch).reduced()
    axes = param_axes(lm.LM(cfglib.get_config(arch).reduced(),
                            device="meta", seed=None))
    want = {}
    for name, p, stacked in _ref_leaves(_shape_tree(jcfg), jcfg):
        ax = tuple(p.axes)
        if stacked:      # the reference's view of one layer's slice
            ax = effective_axes(types.SimpleNamespace(
                axes=ax, value=np.empty(p.value.shape[1:])))
        want[name] = tuple(ax)
    assert axes == want


@pytest.mark.parametrize("arch", cfglib.ARCH_NAMES)
def test_moment_groups_are_the_reference_stacks(arch):
    """``lm.moment_groups`` names, for each tensor the reference stacks
    over a period slot's layers, the port's layers of it in period order:
    the int8 moments that share one scale in both packages."""
    from repro import configs as jcfglib
    from repro_torch.models import lm
    jcfg, cfg = jcfglib.get_config(arch).reduced(), \
        cfglib.get_config(arch).reduced()
    stacks: dict = {}
    for name, p, stacked in _ref_leaves(_shape_tree(jcfg), jcfg):
        if stacked:
            stacks.setdefault(id(p), []).append(name)
    names = [k for k, _ in lm.LM(cfg, device="meta",
                                 seed=None).named_parameters()]
    got = lm.moment_groups(cfg, names)
    assert sorted(got) == sorted(tuple(v) for v in stacks.values())


def test_from_jax_lm_params_checks_axes():
    import jax

    from repro import configs as jcfglib
    from repro.models import lm as jlm
    from repro.models.params import P
    from repro_torch.models.params import from_jax_lm_params
    jcfg = jcfglib.get_config("qwen3-moe-30b-a3b").reduced()
    cfg = cfglib.get_config("qwen3-moe-30b-a3b").reduced()
    tree = jax.tree_util.tree_map(
        lambda p: P(np.asarray(p.value), p.axes), jlm.init(
            jax.random.PRNGKey(0), jcfg), is_leaf=lambda x: isinstance(x, P))
    model = from_jax_lm_params(cfg, tree, device="cpu")      # axes agree
    assert model.layers[0].ffn.axes["w_up"] == ("expert", "embed", "mlp")
    bad = tree["period"][0]["ffn"]["w_up"]
    tree["period"][0]["ffn"]["w_up"] = P(bad.value, ("layers", "expert",
                                                     "mlp", "embed"))
    with pytest.raises(ValueError, match="axes"):
        from_jax_lm_params(cfg, tree, device="cpu")
    tree["period"][0]["ffn"]["w_up"] = bad
    tree["lm_head"] = P(tree["lm_head"].value, ("vocab", "embed"))
    with pytest.raises(ValueError, match="lm_head: reference axes"):
        from_jax_lm_params(cfg, tree, device="cpu")


def test_ashard_is_the_identity_outside_a_context():
    from repro_torch.distributed import sharding as shd
    x = torch.randn(4, 8)
    assert shd.ashard(x, "batch", None) is x
    assert not shd.sharding_active() and shd.current_context() is None
    mesh = _duck((2, 2), ("data", "model"))
    plan = shd.ParallelPlan.for_mesh(mesh)
    assert plan.batch_axes == ("data",) and plan.model_axes == ("model",)
    # a plain tensor inside a context stays as it is too
    shd._CTX.append((mesh, plan))
    try:
        assert shd.ashard(x, "batch", None) is x
        assert shd.current_context() == (mesh, plan)
    finally:
        shd._CTX.pop()


def test_launch_mesh_host_needs_a_launcher(monkeypatch):
    from repro_torch.launch import train as launch_train
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        launch_train.main(["--reduced", "--device", "cpu", "--mesh", "host",
                           "--steps", "1"])


def test_import_without_jax_sharding_modules():
    code = ("import sys; sys.modules['jax'] = None; "
            "import repro_torch.distributed.sharding, "
            "repro_torch.distributed.step, repro_torch.distributed.pipeline, "
            "repro_torch.launch.mesh, repro_torch.launch.train, "
            "repro_torch.distributed, repro_torch.launch; "
            "from repro_torch.distributed import build_train_step, "
            "pipeline_forward, ParallelPlan; "
            "assert not any(m == 'repro' or m.startswith(('repro.', 'jax')) "
            "for m in sys.modules if sys.modules[m] is not None); print('ok')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ---------------------------------------------------------------------------
# the ranks against the reference
# ---------------------------------------------------------------------------

def test_mesh_refusals(sharding):
    ranks, _, _ = sharding
    for r in range(WORLD):
        assert ranks[r]["refuse_uninit"] == 1 and ranks[r]["refuse_size"] == 1
        assert ranks[r]["moe_cuda_refuses_cpu"] == 1
        assert ranks[r]["moe3_cuda_refuses_cpu"] == 1


@pytest.mark.parametrize("against", ["reference_shard_map", "moe_capacity"])
def test_moe_shard_map(sharding, against):
    ranks, ref, _ = sharding
    want = ranks["jax"] if against == "reference_shard_map" else ref
    for r in range(WORLD):
        got = ranks[r]
        np.testing.assert_allclose(got["moe_y"], want["moe_y"], rtol=1e-4,
                                   atol=1e-4, err_msg=f"rank {r}")
        for k in ("x", "router", "w_up", "w_gate", "w_down"):
            np.testing.assert_allclose(got[f"moe_g_{k}"], want[f"moe_g_{k}"],
                                       rtol=2e-3, atol=2e-3,
                                       err_msg=f"rank {r} d{k}")
    np.testing.assert_allclose(ranks[0]["moe_aux"], ref["moe_aux"],
                               rtol=1e-5)


def test_moe_shard_map_global_fallback(sharding):
    """E = 3 experts do not divide the model dim: moe_capacity on every
    rank, replicated."""
    ranks, ref, _ = sharding
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r]["moe3_y"], ref["moe3_y"],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(ranks[r]["moe3_aux"], ref["moe3_aux"],
                                   rtol=1e-5)
        for k in ("x", "router", "w_up", "w_gate", "w_down"):
            np.testing.assert_allclose(ranks[r][f"moe3_g_{k}"],
                                       ref[f"moe3_g_{k}"], rtol=2e-3,
                                       atol=2e-3)


@pytest.mark.parametrize("name", ["moe", "moe3"])
def test_moe_ragged_shard_map(sharding, name):
    """The dropless layer on the 2 × 2 mesh against the reference's
    ``moe(impl="ragged")`` under its host mesh: expert-parallel on
    segment_matmul where the 4 experts divide "model", ``moe_ragged``
    whole on every rank where the 3 do not."""
    ranks, _, _ = sharding
    want = ranks["jax"]
    key = f"{name}_ragged"
    for r in range(WORLD):
        got = ranks[r]
        np.testing.assert_allclose(got[f"{key}_y"], want[f"{key}_y"],
                                   rtol=1e-4, atol=1e-4, err_msg=f"rank {r}")
        np.testing.assert_allclose(got[f"{key}_aux"], want[f"{key}_aux"],
                                   rtol=1e-4, err_msg=f"rank {r} aux")
        for k in ("x", "router", "w_up", "w_gate", "w_down"):
            np.testing.assert_allclose(got[f"{key}_g_{k}"],
                                       want[f"{key}_g_{k}"], rtol=2e-3,
                                       atol=2e-3, err_msg=f"rank {r} d{k}")


def test_ragged_local_parts_sum_to_the_whole_layer():
    """The model ranks' parts of ``moe_ragged_shard_map`` (each all of
    the sorted assignments, its own experts' first and the rest past its
    groups) sum to the part of one rank that owns every expert, forward
    and gradients, where one rank owns no assignment (its part is 0)."""
    from repro_torch.models import moe as moe_mod
    cfg = cfglib.get_config("qwen3-moe-30b-a3b").reduced()
    e, k, d, f = cfg.num_experts, cfg.top_k, cfg.d_model, cfg.moe_d_ff
    e_m, t = e // 4, 6
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(t, d, generator=gen, requires_grad=True)
    # no assignment targets the last rank's experts
    te = torch.randint(0, e - e_m, (t, k), generator=gen, dtype=torch.int32)
    tp = torch.rand(t, k, generator=gen, requires_grad=True)
    ws = [(torch.randn(e, *s, generator=gen) / 8).requires_grad_()
          for s in ((d, f), (d, f), (f, d))]
    ct = torch.randn(t, d, generator=gen)

    def part(e_m, r):         # rank r's experts' weights
        return moe_mod._ragged_local(
            x, te, tp, *(w[r * e_m:(r + 1) * e_m] for w in ws), cfg=cfg,
            e_m=e_m, m_rank=r, impl="ref")

    def run(e_m, ranks):
        y = sum(part(e_m, r) for r in ranks)
        return [y] + list(torch.autograd.grad((y * ct).sum(),
                                              [x, tp] + ws))
    for got, want in zip(run(e_m, range(4)), run(e, [0])):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert not part(e_m, 3).any()


def test_tp_out_project(sharding):
    ranks, ref, _ = sharding
    for r in range(WORLD):
        for key in ("tp", "tp_from_plain_x", "tp_plain_ctx_free"):
            np.testing.assert_allclose(ranks[r][key], ref["tp"], rtol=1e-4,
                                       atol=1e-4, err_msg=f"{key} rank {r}")
        np.testing.assert_allclose(ranks[r]["tp"], ranks["jax"]["tp"],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["dense", "moe", "moe_ragged"])
def test_sharded_train_step(sharding, name):
    from repro_torch import configs as cfglib
    ranks, ref, _ = sharding
    cfg = _cfgs(cfglib)[name.split("_")[0]]
    want_g = _named(cfg, ref[f"train_{name}_g0"])
    want_p = _named(cfg, ref[f"train_{name}_p"])
    for r in range(WORLD):
        got = ranks[r]
        np.testing.assert_allclose(got[f"train_{name}_losses"],
                                   ref[f"train_{name}_losses"], rtol=1e-4)
        for k in want_g:
            np.testing.assert_allclose(got[f"train_{name}_g0_{k}"],
                                       want_g[k], rtol=2e-3, atol=2e-3,
                                       err_msg=f"rank {r} grad {k}")
            np.testing.assert_allclose(got[f"train_{name}_p_{k}"],
                                       want_p[k], rtol=2e-3, atol=2e-3,
                                       err_msg=f"rank {r} param {k}")


def test_sharded_train_step_int8_moments(sharding):
    """int8 moments: the payload sharded as its parameter, the scale
    replicated, and taken over the whole period slot (every rank holds the
    same scale, and the largest |q| of a slot's layers, every shard of
    them, is 127); the first moments within 2e-3 of the port's
    single-device int8 step."""
    from repro_torch.distributed import step as steplib
    from repro_torch.models import lm
    from repro_torch.models.params import from_jax_lm_params
    from repro_torch.optim import adamw
    ranks, _, out = sharding
    cfg = _cfgs(cfglib)["dense"]
    model = from_jax_lm_params(cfg, _load_tree(out, "dense"), device="cpu")
    params = {k: p.detach().clone().requires_grad_()
              for k, p in model.named_parameters()}
    opt_cfg = adamw.AdamWConfig(lr=TRAIN_CFG["lr"], state_dtype="int8")
    batch = {k: torch.from_numpy(v)
             for k, v in np.load(out / "train_batch.npz").items()}
    loss, _ = lm.loss_fn(params, cfg, batch, remat_policy="none")
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    groups = lm.moment_groups(cfg, params)
    _, opt, _ = adamw.update_(grads, adamw.init(params, opt_cfg),
                              params, opt_cfg, 0.0, groups)
    want = np.concatenate([(opt.mu[k].q.float() * opt.mu[k].scale)
                           .reshape(-1).numpy() for k in sorted(opt.mu)])
    np.testing.assert_allclose(ranks[0]["int8_mu"], want, rtol=2e-3,
                               atol=2e-3)
    assert steplib.TrainStepConfig().moe_impl == "capacity"
    for r in range(WORLD):
        assert ranks[r]["int8_layout"] == 1
        assert ranks[r]["int8_scale_replicated"] == 1
        np.testing.assert_array_equal(ranks[r]["int8_scales"],
                                      ranks[0]["int8_scales"])
        np.testing.assert_array_equal(ranks[r]["int8_mu"],
                                      ranks[0]["int8_mu"])
        assert np.all(np.isfinite(ranks[r]["train_dense_int8_losses"]))
    names = sorted(params)
    max_q = dict(zip(names, ranks[0]["int8_max_q"]))
    assert groups and all(len(g) == 2 for g in groups)    # 2 periods
    for unit in adamw._units(names, groups):
        assert max(max_q[k] for k in unit) == 127, unit


@pytest.mark.parametrize("name,shape", SERVE_CASES,
                         ids=[f"{n}-{s[0]}x{s[1]}" for n, s in SERVE_CASES])
def test_sharded_prefill_and_decode(sharding, name, shape):
    ranks, ref, _ = sharding
    key = f"{name}_{shape[0]}x{shape[1]}"
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r][f"prefill_{key}"],
                                   ref[f"prefill_{name}"], rtol=2e-3,
                                   atol=2e-3, err_msg=f"prefill rank {r}")
        for i in range(DECODE):
            np.testing.assert_allclose(ranks[r][f"decode_{key}_{i}"],
                                       ref[f"decode_{name}_{i}"], rtol=2e-3,
                                       atol=2e-3,
                                       err_msg=f"decode {i} rank {r}")
    if name in ("dense", "moe"):
        # 2 KV heads on a 4-way model dim: the cache shards the sequence
        want = (None, "data", "model", None, None) if shape == (1, 4) \
            else (None, "data", None, "model", None)
        assert str(ranks[0][f"kv_spec_{key}"]) == repr(want)


def test_sharded_prefill_and_decode_ragged(sharding):
    """The dropless MoE under the mesh in the serving steps, against the
    reference's single-device ``forward`` / ``decode_step`` with
    ``moe_impl="ragged"``."""
    ranks, ref, _ = sharding
    name, shape = RAGGED_SERVE
    key = f"{name}_{shape[0]}x{shape[1]}_ragged"
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r][f"prefill_{key}"],
                                   ref[f"prefill_{name}_ragged"], rtol=2e-3,
                                   atol=2e-3, err_msg=f"prefill rank {r}")
        for i in range(DECODE):
            np.testing.assert_allclose(ranks[r][f"decode_{key}_{i}"],
                                       ref[f"decode_{name}_ragged_{i}"],
                                       rtol=2e-3, atol=2e-3,
                                       err_msg=f"decode {i} rank {r}")


def test_fit_with_a_mesh_matches_reference(sharding):
    ranks, ref, _ = sharding
    for r in range(WORLD):
        assert len(ranks[r]["fit_losses"]) == FIT_STEPS
        np.testing.assert_allclose(ranks[r]["fit_losses"], ref["fit_losses"],
                                   rtol=2e-3)
        own, shared = ranks[r]["fit_ckpt"]
        assert own >= 2 and shared == -1


def test_fit_with_a_mesh_ragged_moe(sharding):
    """``fit(LMTask(moe_impl="ragged"), mesh=)`` on the reduced MoE config
    against ``repro.fit`` of ``LMTask(moe_impl="ragged")``."""
    ranks, ref, _ = sharding
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r]["fit_losses_moe_ragged"],
                                   ref["fit_losses_moe_ragged"], rtol=2e-3)
        own, shared = ranks[r]["fit_ckpt_moe_ragged"]
        assert own >= 2 and shared == -1


def test_launch_train_mesh_host_ragged(sharding):
    """``launch.train --mesh host --moe-impl ragged`` on the reduced MoE
    arch against the same command on one device."""
    ranks, ref, _ = sharding
    want = ref["launch_ragged_losses"]
    assert len(want) == 2 and np.all(np.isfinite(want))
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r]["launch_ragged_losses"], want,
                                   rtol=2e-3, err_msg=f"rank {r}")


def test_launch_train_mesh_host(sharding):
    ranks, _, _ = sharding
    for r in range(WORLD):
        losses = ranks[r]["launch_losses"]
        assert len(losses) == 3 and np.all(np.isfinite(losses))
        np.testing.assert_array_equal(losses, ranks[0]["launch_losses"])


def test_pipeline_forward(sharding):
    ranks, _, _ = sharding
    inp = _inputs()
    want = inp["pp_x"]
    for i in range(4):
        want = np.tanh(want @ inp["pp_w"][i])
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r]["pipeline"], want, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(ranks[r]["pipeline"],
                                   ranks["jax"]["pipeline"], rtol=1e-5,
                                   atol=1e-5)


def test_elastic_restore_and_shares(sharding):
    ranks, _, _ = sharding
    for r in range(WORLD):
        assert ranks[r]["elastic_bitwise"] == 1
        assert ranks[r]["restore_same_mesh"] == 1
        assert ranks[r]["shares"] == 1
        assert ranks[r]["sharded_param_count"] > 0


if __name__ == "__main__":
    if sys.argv[1] == "--jax":
        _run_jax(sys.argv[2])
    else:
        sys.exit(_run_ranks(sys.argv[1]))

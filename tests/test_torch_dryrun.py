"""The port's dry run (``repro_torch.launch.dryrun``), its step tally and
the kernels' fakes, on the CPU, against the reference where it computes
without compiling.

  * ``configs.shapes.input_specs`` against the reference's for the ten
    archs × four shapes: names, shapes and dtypes exactly;
  * ``--list`` printing exactly the reference's lines (the reference's
    dry run is imported only in a subprocess: at import it appends a
    512-device flag to ``XLA_FLAGS``);
  * every arch × shape × mesh cell's ``num_params`` and per-device
    parameter, optimizer and cache bytes against the reference's
    arithmetic (``sharded_bytes``'s floor division over its
    ``param_specs`` / moments / ``decode_state_specs`` on
    ``jax.eval_shape`` trees with a duck-typed mesh), up to the one
    layout that differs by design: the reference's 4-byte device scalars
    (the AdamW step, the decode length) are host ints in the port (int8
    moments hold one scale a stacked period slot in both);
  * the sharded loss keeps the gold logit a data shard's: on a fake
    2 × 2 mesh, where the global batch's fp32 logits dominate a reduced
    MoE step, no tensor of their size is made and the peak stays below
    twice their size;
  * fake against real: a reduced dense and a reduced MoE config on a
    2 × 2 mesh, train (``LMTask`` under ``fit(mesh=)``, as phase 3j
    trains), prefill and decode: the dry run's FLOPs and collective counts
    and bytes by kind equal those of the same step on 4 real gloo CPU
    ranks (rank 0; a module fixture runs this file as a script: ``python
    tests/test_torch_dryrun.py OUTDIR``), and its parameter and moment
    bytes the ranks' local ones;
  * the three production cells at full width and cut depth (the lead and
    one period, ``run_cell(cfg=)``) on the CPU: status ok, FLOPs and collective
    bytes > 0; one ``--diff`` cell with per-period FLOPs > 0; records
    under ``--out``, never the reference's ``results/dryrun/``;
  * the dry run and the tally import with ``jax`` blocked;
  * the six kernel wrappers with ``impl="cuda"`` on CUDA-typed fake
    tensors: the shape, dtype and device of their plain versions on real
    CPU inputs, no build and no launch; the flop counter's 2·M·K·N for
    segment_matmul and 2·S·K·N for the fused kernel.
"""
import datetime
import functools
import json
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
from repro_torch.configs import shapes as shapelib  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT_S = 240
BATCH, SEQ, MAX_LEN = 4, 16, 16
STEP_KINDS = ("train", "prefill", "decode")


def _env():
    path = [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]
    # two threads a process: the suite runs beside these in other workers
    return dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
                PYTHONPATH=os.pathsep.join(path))


# ---------------------------------------------------------------------------
# input_specs and --list against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", cfglib.ARCH_NAMES)
def test_input_specs_match_reference(arch):
    import jax.numpy as jnp

    from repro import configs as jcfglib
    from repro.configs import shapes as jshapes
    jcfg, cfg = jcfglib.get_config(arch), cfglib.get_config(arch)
    dtypes = {jnp.dtype(jnp.int32): torch.int32,
              jnp.dtype(jnp.bfloat16): torch.bfloat16,
              jnp.dtype(jnp.float32): torch.float32}
    for shape in shapelib.SHAPE_NAMES:
        want = jshapes.input_specs(jcfg, shape)
        got = shapelib.input_specs(cfg, shape)
        assert list(got) == list(want), (arch, shape)
        for k, spec in want.items():
            assert tuple(got[k].shape) == tuple(spec.shape), (arch, shape, k)
            assert got[k].dtype == dtypes[jnp.dtype(spec.dtype)], (arch, k)
            assert got[k].device.type == "meta"


def test_list_matches_reference():
    outs = [subprocess.run([sys.executable, "-m", f"{pkg}.launch.dryrun",
                            "--list"], cwd=ROOT, env=_env(),
                           capture_output=True, text=True, timeout=120)
            for pkg in ("repro", "repro_torch")]
    for o in outs:
        assert o.returncode == 0, o.stderr[-3000:]
    assert outs[1].stdout == outs[0].stdout
    assert len(outs[1].stdout.splitlines()) == 40


# ---------------------------------------------------------------------------
# per-device bytes against the reference's arithmetic, every cell
# ---------------------------------------------------------------------------

def _duck(shape, names):
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape))


def _parts(spec, sizes) -> int:
    parts = 1
    for entry in tuple(spec):
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None:
                parts *= sizes[ax]
    return parts


def _reference_bytes(arch, shape, multi_pod, state_dtype):
    import jax
    import jax.numpy as jnp

    from repro import configs as jcfglib
    from repro.distributed import step as jstep
    from repro.models import lm as jlm
    cfg = jcfglib.get_config(arch)
    out, cell, plan, mesh, leaves, specs, sizes = _ref_common(
        arch, shape, multi_pod)
    if cell.kind == "train":
        per = {"float32": 4, "bfloat16": 2, "int8": 1}[state_dtype]
        moment = sum(int(p.value.size) * per // _parts(s, sizes)
                     for p, s in zip(leaves, specs))
        scales = len(leaves) if state_dtype == "int8" else 0
        # mu and nu, each leaf's fp32 scale replicated, the int32 step
        out["opt_bytes_per_device"] = 2 * (moment + 4 * scales) + 4
    elif cell.kind == "decode":
        st = jax.eval_shape(lambda: jlm.init_decode_state(
            cfg, cell.global_batch, cell.seq_len, jnp.dtype(cfg.dtype)))
        sp = jstep.decode_state_specs(cfg, mesh, plan, cell.global_batch,
                                      cell.seq_len)
        is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
        st_leaves = jax.tree_util.tree_leaves(st)
        sp_leaves = jax.tree_util.tree_leaves(sp, is_leaf=is_spec)
        assert len(st_leaves) == len(sp_leaves)
        out["cache_bytes_per_device"] = sum(
            int(a.size) * a.dtype.itemsize // _parts(s, sizes)
            for a, s in zip(st_leaves, sp_leaves))
    return out


@functools.lru_cache(maxsize=None)
def _ref_tree(arch):
    """The reference LM's parameter tree of ``arch`` (shapes only), in its
    config's dtype."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jcfglib
    from repro.models import lm as jlm
    cfg = jcfglib.get_config(arch)
    return jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0), cfg,
                                           jnp.dtype(cfg.dtype)))


def _ref_common(arch, shape, multi_pod):
    import jax

    from repro.configs import shapes as jshapes
    from repro.distributed import sharding as jshd
    from repro.models.params import is_param
    cell = jshapes.SHAPES[shape]
    mesh = (_duck((2, 16, 16), ("pod", "data", "model")) if multi_pod
            else _duck((16, 16), ("data", "model")))
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    tree = _ref_tree(arch)
    leaves = jax.tree_util.tree_leaves(tree, is_leaf=is_param)
    n_par = sum(int(p.value.size) for p in leaves)
    seq_axis = "data" if (cell.kind == "decode"
                          and cell.global_batch % 16 != 0) else None
    # the reference decides from the bf16 tree's size: the same count
    fsdp = n_par * 2 / 16 > 12e9 if cell.kind == "decode" else True
    plan = jshd.ParallelPlan.for_mesh(mesh, fsdp=fsdp,
                                      seq_shard_axis=seq_axis)
    specs = jax.tree_util.tree_leaves(
        jshd.param_specs(tree, plan, mesh),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(specs) == len(leaves)
    out = {"num_params": n_par}
    out["param_bytes_per_device"] = sum(
        int(p.value.size) * p.value.dtype.itemsize // _parts(s, sizes)
        for p, s in zip(leaves, specs))
    return out, cell, plan, mesh, leaves, specs, sizes


@pytest.mark.parametrize("arch", cfglib.ARCH_NAMES)
def test_state_bytes_match_reference_every_cell(arch):
    from repro_torch.launch import dryrun
    state_dtype = dryrun.STATE_DTYPE.get(arch, "float32")
    for shape in shapelib.SHAPE_NAMES:
        if shapelib.cell_applicable(cfglib.get_config(arch), shape):
            continue
        for multi in (False, True):
            want = _reference_bytes(arch, shape, multi, state_dtype)
            mesh = (_duck((2, 16, 16), ("pod", "data", "model")) if multi
                    else _duck((16, 16), ("data", "model")))
            got = dryrun.state_bytes(arch, shape, mesh)
            assert set(got) == set(want), (arch, shape, multi)
            assert got["num_params"] == want["num_params"]
            assert got["param_bytes_per_device"] == \
                want["param_bytes_per_device"], (arch, shape, multi)
            if "opt_bytes_per_device" in want:
                # the reference's int32 step
                assert got["opt_bytes_per_device"] == \
                    want["opt_bytes_per_device"] - 4, (arch, shape, multi)
            if "cache_bytes_per_device" in want:
                # the reference's int32 decode length
                assert got["cache_bytes_per_device"] == \
                    want["cache_bytes_per_device"] - 4, (arch, shape, multi)


# ---------------------------------------------------------------------------
# fake against real: the same steps on 4 gloo CPU ranks
# ---------------------------------------------------------------------------

def _small_cfgs():
    return {"dense": cfglib.get_config("qwen3-8b").reduced(),
            "moe": cfglib.get_config("qwen3-moe-30b-a3b").reduced(
                capacity_factor=8.0)}


def _train_config():
    from repro_torch.distributed import step as steplib
    from repro_torch.optim import adamw
    return steplib.TrainStepConfig(opt=adamw.AdamWConfig(lr=1e-3),
                                   warmup_steps=1, total_steps=3,
                                   remat_policy="none", moe_impl="capacity")


def _provider(cfg):
    from repro_torch.data.tokens import TokenDatasetConfig
    from repro_torch.train import TokenProvider
    return TokenProvider(TokenDatasetConfig(vocab_size=cfg.vocab_size,
                                            seq_len=SEQ, global_batch=BATCH))


def _tallied(tally, local=None) -> dict:
    out = {"flops": tally.flops, "collectives": tally.collectives()}
    if local is not None:
        out["state_bytes"] = local
    return out


def _rank_main(rank: int, outdir: str):
    import torch.distributed as dist

    from repro_torch import train
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import step as steplib
    from repro_torch.distributed.collectives import route_all_gather
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.tally import StepTally
    from repro_torch.models import lm
    torch.set_num_threads(1)
    out = pathlib.Path(outdir)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(out / "store"), WORLD),
        rank=rank, world_size=WORLD, timeout=datetime.timedelta(seconds=90))
    res = {}
    try:
        route_all_gather("CPU")            # the card's all-gather path
        mesh = make_host_mesh(2, 2, device_type="cpu")
        plan = shd.ParallelPlan.for_mesh(mesh)
        for name, cfg in _small_cfgs().items():
            # train: LMTask under fit(mesh=), then one tallied warm step
            ts = _train_config()
            task = train.LMTask(cfg, moe_impl="capacity", device="cpu")
            data = _provider(cfg)
            trainer = train.Trainer(task, data, train.TrainerConfig(
                steps=1, warmup_steps=ts.warmup_steps, opt=ts.opt), mesh=mesh)
            run = trainer.fit()
            with StepTally() as tally:
                trainer.step(run.state, 1)
            st = run.state
            local = sum(t.to_local().numel() * t.to_local().element_size()
                        for tree in (st.params, st.opt_state.mu,
                                     st.opt_state.nu) for t in tree.values())
            res[f"{name}/train"] = _tallied(tally, local)
            del trainer, run, st
            # prefill and decode on the model the dry run builds
            model = shd.distribute(lm.LM(cfg, device="cpu", seed=0), plan,
                                   mesh)
            model.requires_grad_(False)
            tokens = torch.zeros((BATCH, SEQ), dtype=torch.int32)
            prefill = steplib.build_prefill_step(cfg, mesh, plan)
            with StepTally() as tally:
                prefill(model, {"tokens": shd.place_tensor(
                    tokens, mesh, shd.placements(shd.spec_for_axes(
                        ("batch", "seq"), tokens.shape, plan, mesh), mesh))})
            res[f"{name}/prefill"] = _tallied(tally)
            serve, shardings_for = steplib.build_serve_step(
                cfg, mesh, plan, BATCH, MAX_LEN)
            state = steplib.shard_decode_state(
                lm.init_decode_state(cfg, BATCH, MAX_LEN,
                                     getattr(torch, cfg.dtype),
                                     device="cpu"),
                shardings_for(None)[2], mesh)
            with StepTally() as tally:
                serve(model, torch.zeros((BATCH, 1), dtype=torch.int32),
                      state)
            res[f"{name}/decode"] = _tallied(tally)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        (out / "ranks.json").write_text(json.dumps(res))


def _fake_main(outdir: str):
    """The dry run of the same steps, in a process of its own."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    res = {}
    dev = torch.device("cpu")
    for name, cfg in _small_cfgs().items():
        batch = _provider(cfg).batch(0)
        specs = {k: torch.empty(np.shape(a), device="meta",
                                dtype=torch.as_tensor(a).dtype)
                 for k, a in batch.items()}
        with dryrun.fake_world(WORLD):
            mesh = make_host_mesh(2, 2, device_type="cpu")
            plan = shd.ParallelPlan.for_mesh(mesh)
            tally, local = dryrun.trace_step("train", cfg, mesh, plan, specs,
                                             dev, train_config=_train_config())
            res[f"{name}/train"] = _tallied(tally,
                                            local["param"] + local["opt"])
            res[f"{name}/train"]["memory"] = tally.memory()
            tok = {"tokens": torch.empty((BATCH, SEQ), dtype=torch.int32,
                                         device="meta")}
            tally, _ = dryrun.trace_step("prefill", cfg, mesh, plan, tok, dev)
            res[f"{name}/prefill"] = _tallied(tally)
            tok = {"tokens": torch.empty((BATCH, 1), dtype=torch.int32,
                                         device="meta")}
            tally, _ = dryrun.trace_step("decode", cfg, mesh, plan, tok, dev,
                                         batch=BATCH, max_len=MAX_LEN)
            res[f"{name}/decode"] = _tallied(tally)
    (pathlib.Path(outdir) / "fake.json").write_text(json.dumps(res))


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


@pytest.fixture(scope="module")
def fake_and_real(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    procs = [subprocess.Popen([sys.executable, __file__, *flag, str(out)],
                              cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for flag in ([], ["--fake"])]
    try:
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-6000:]
    return (json.loads((out / "fake.json").read_text()),
            json.loads((out / "ranks.json").read_text()))


@pytest.mark.parametrize("kind", STEP_KINDS)
@pytest.mark.parametrize("name", ["dense", "moe"])
def test_dry_run_counts_the_real_step(fake_and_real, name, kind):
    fake, real = fake_and_real
    key = f"{name}/{kind}"
    assert fake[key]["flops"] == real[key]["flops"] > 0
    assert fake[key]["collectives"] == real[key]["collectives"]
    assert fake[key]["collectives"]["total_bytes"] > 0
    if kind == "train":
        assert fake[key]["state_bytes"] == real[key]["state_bytes"]
        mem = fake[key]["memory"]
        assert mem["peak_bytes"] >= sum(mem["at_peak"].values()) > 0


def test_sharded_loss_keeps_the_gold_logit_a_data_shards():
    """A reduced MoE step on a fake 2 × 2 mesh whose global batch's fp32
    logits (8 × 128 × 16,384) dominate it: the loss's gold-logit gather
    runs on each data shard, so no rank makes a tensor of the global
    batch's logits (its backward under DTensor made one of zeros), and the
    peak stays below twice their size. The data shard's own logits, the
    vocabulary gathered, are half their size, and the gather that builds
    them holds two such buffers at once, so the peak cannot fall below
    their size while it stays."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    b, s, v = 8, 128, 16384
    cfg = cfglib.get_config("qwen3-moe-30b-a3b").reduced(
        vocab_size=v, capacity_factor=8.0)
    specs = {k: torch.empty((b, s), dtype=torch.int64, device="meta")
             for k in ("tokens", "labels")}
    with dryrun.fake_world(WORLD):
        mesh = make_host_mesh(2, 2, device_type="cpu")
        tally, local = dryrun.trace_step(
            "train", cfg, mesh, shd.ParallelPlan.for_mesh(mesh), specs,
            torch.device("cpu"), train_config=_train_config())
    mem = tally.memory()
    logits = b * s * v * 4
    assert local["param"] + local["opt"] < logits / 8       # they dominate
    assert mem["largest_bytes"] < logits
    assert logits / 2 <= mem["peak_bytes"] < 2 * logits


# ---------------------------------------------------------------------------
# production cells at full width, cut depth; --diff; output
# ---------------------------------------------------------------------------

PRODUCTION = (("stablelm-1.6b", "decode_32k", "single"),
              ("rwkv6-3b", "long_500k", "multi"),
              ("qwen3-moe-30b-a3b", "train_4k", "single"))


_CUT_CELL = """
import dataclasses, json, sys
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.models import lm
arch, shape, mesh, out = sys.argv[1:]
cfg = configs.get_config(arch)
lead, period, _ = lm.stack_plan(cfg)
cut = dataclasses.replace(cfg, num_layers=len(lead) + max(len(period), 1))
res = dryrun.run_cell(arch, shape, mesh == "multi", cfg=cut, device="cpu")
open(out, "w").write(json.dumps(res))
"""


@pytest.fixture(scope="module")
def production_records(tmp_path_factory):
    """Each production cell cut to its lead and one period
    (``run_cell(cfg=)``, as ``diff_cell`` cuts), and one ``--diff`` cell
    through the CLI, each in a process of its own."""
    out = tmp_path_factory.mktemp("cells")
    cmds = [[sys.executable, "-c", _CUT_CELL, arch, shape, mesh,
             str(out / f"{arch}__{shape}__{mesh}.json")]
            for arch, shape, mesh in PRODUCTION]
    cmds.append([sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", "rwkv6-3b", "--shape", "long_500k", "--diff",
                 "--device", "cpu", "--out", str(out / "diff.json")])
    procs = [subprocess.Popen(c, cwd=ROOT, env=_env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-6000:]
    return out


@pytest.mark.parametrize("cell", PRODUCTION, ids=lambda c: "__".join(c))
def test_production_cell_traces(production_records, cell):
    arch, shape, mesh = cell
    res = json.loads((production_records
                      / f"{arch}__{shape}__{mesh}.json").read_text())
    assert res["status"] == "ok", res
    assert res["flops"] > 0 and res["cost_analysis"]["flops"] == res["flops"]
    assert res["collectives"]["total_bytes"] > 0
    assert set(res["collectives"]["bytes"]) == {
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute"}
    assert res["world"] == (512 if mesh == "multi" else 256)
    mem = res["memory"]
    assert mem["peak_bytes"] > 0 and mem["fits"] == (
        mem["peak_bytes"] <= mem["device_bytes"])
    assert res["param_bytes_per_device"] > 0 and res["trace_s"] > 0


def test_diff_cell_per_period(production_records):
    res = json.loads((production_records / "diff.json").read_text())
    assert res["status"] == "ok", res
    assert res["flops_2p"] - res["flops_1p"] > 0
    assert res["coll_2p"] >= res["coll_1p"] > 0


def test_records_never_go_to_the_reference_directory():
    from repro_torch.launch import dryrun
    assert dryrun.RESULTS_DIR == ROOT / "results" / "torch_dryrun"
    assert dryrun.DIFF_DIR == ROOT / "results" / "torch_roofline_diff"


def test_a_cell_without_a_card_raises_and_skips_are_recorded(tmp_path):
    from repro_torch.launch import dryrun
    skipped = dryrun.run_cell("qwen3-8b", "long_500k", device="cpu")
    assert skipped["status"] == "skipped" and "sub-quadratic" in \
        skipped["reason"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="card"):
            dryrun.run_cell("qwen3-8b", "decode_32k")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-8b", "--shape", "long_500k", "--out", str(tmp_path)],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads((tmp_path / "qwen3-8b__long_500k__single.json")
                     .read_text())
    assert rec["status"] == "skipped"


def test_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import repro_torch.launch.dryrun, repro_torch.launch.tally, "
            "repro_torch.configs.shapes, repro_torch.launch; "
            "from repro_torch.launch import dryrun, StepTally; "
            "assert not any(m == 'repro' or m.startswith(('repro.', 'jax')) "
            "for m in sys.modules if sys.modules[m] is not None); print('ok')")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ---------------------------------------------------------------------------
# the kernels' fakes
# ---------------------------------------------------------------------------

def _kernel_calls():
    """``(calls, on)``: ``calls(tensors, impl)`` maps each kernel to its
    public call; ``on(device)`` gives the inputs on ``device``."""
    from repro_torch.kernels import ops as kops
    rng = np.random.default_rng(0)
    m, v, s, f = 300, 60, 40, 16
    seg = np.sort(rng.integers(0, s, m)).astype(np.int32)
    gidx = rng.integers(0, v, m).astype(np.int32)
    arrays = {"h": rng.standard_normal((v, f), np.float32),
              "x": rng.standard_normal((m, f), np.float32),
              "sm": rng.standard_normal((m, 4), np.float32),
              "w": rng.standard_normal((f, 24), np.float32),
              "wt": rng.random(m).astype(np.float32),
              "wg": rng.standard_normal((3, f, 24), np.float32),
              "seg": seg, "gidx": gidx,
              "sizes": np.array([100, 0, 150], np.int32)}

    def on(d):
        return {k: torch.from_numpy(a).to(d) for k, a in arrays.items()}

    def calls(t, impl):
        return {
            "gather_segment_reduce": lambda: kops.gather_segment_reduce(
                t["h"], t["gidx"], t["seg"], s, t["wt"], impl=impl),
            "segment_reduce": lambda: kops.segment_reduce(
                t["x"], t["seg"], s, "max", impl=impl),
            "segment_softmax": lambda: kops.segment_softmax(
                t["sm"], t["seg"], s, impl=impl),
            "fused_transform_reduce": lambda: kops.fused_transform_reduce(
                t["h"], t["w"], t["gidx"], t["seg"], s, t["wt"], "mean",
                impl=impl),
            "segment_matmul": lambda: kops.segment_matmul(
                t["x"], t["sizes"], t["wg"], impl=impl),
            "sddmm": lambda: kops.sddmm(t["h"], t["h"], t["seg"], t["gidx"],
                                        impl=impl),
        }
    return calls, on


@pytest.mark.parametrize("kernel", ["gather_segment_reduce", "segment_reduce",
                                    "segment_softmax", "fused_transform_reduce",
                                    "segment_matmul", "sddmm"])
def test_kernel_fake_gives_the_plain_versions_shape(kernel, monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as kops

    def no_build(*a, **k):
        raise AssertionError("a fake call must not build a kernel")
    monkeypatch.setattr(_build, "load", no_build)
    calls, on = _kernel_calls()
    want = calls(on("cpu"), "ref")[kernel]()
    before = kops.launch_counts()
    with FakeTensorMode():
        t = {k: torch.empty(v.shape, dtype=v.dtype, device="cuda")
             for k, v in on("cpu").items()}
        got = calls(t, "cuda")[kernel]()
    assert tuple(got.shape) == tuple(want.shape)
    assert got.dtype == want.dtype
    assert got.device.type == "cuda"
    assert kops.launch_counts() == before


def test_flop_formulas_of_the_product_kernels():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import ops as kops
    m, k, n, s = 300, 16, 24, 40
    with FakeTensorMode():
        x = torch.empty(m, k, device="cuda")
        w = torch.empty(3, k, n, device="cuda")
        sizes = torch.tensor([100, 0, 150], device="cuda")
        h = torch.empty(60, k, device="cuda")
        idx = torch.zeros(m, dtype=torch.int32, device="cuda")
        with FlopCounterMode(display=False) as fc:
            kops.segment_matmul(x, sizes, w, impl="cuda")
        assert fc.get_total_flops() == 2 * m * k * n
        with FlopCounterMode(display=False) as fc:
            kops.fused_transform_reduce(h, torch.empty(k, n, device="cuda"),
                                        idx, idx, s, impl="cuda")
        assert fc.get_total_flops() == 2 * s * k * n


@pytest.mark.parametrize("k,n", [(16, 24), (512, 256)])
@pytest.mark.parametrize("counter", ["flop_counter", "step_tally"])
def test_traced_dx_counts_with_w_transposed(counter, k, n):
    """The backward's dX, W read transposed (dY (M, N) @ W[g]ᵀ with W (G,
    K, N)), traced on fake CUDA tensors: 2·M·N·K FLOPs by the flop
    counter and by the dry run's tally, one segment_matmul, an (M, K)
    output; on the mma_sync path's metadata (N = 24) and on the wgmma
    path's offsets alone (N = 256)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import segment_matmul as smm
    from repro_torch.launch.tally import StepTally
    m = 300
    assert smm.path(torch.bfloat16, m, n, k, 3) == (
        "wgmma" if n == 256 else "mma_sync")
    with FakeTensorMode():
        dy = torch.empty(m, n, device="cuda", dtype=torch.bfloat16)
        w = torch.empty(3, k, n, device="cuda", dtype=torch.bfloat16)
        sizes = torch.tensor([100, 0, 150], device="cuda")
        mode = (FlopCounterMode(display=False) if counter == "flop_counter"
                else StepTally())
        with mode as c:
            dx = kops.segment_matmul(dy, sizes, w, impl="cuda",
                                     w_transposed=True)
        assert tuple(dx.shape) == (m, k) and dx.dtype == torch.bfloat16
        if counter == "flop_counter":
            assert c.get_total_flops() == 2 * m * n * k
        else:
            assert c.flops == 2 * m * n * k
            assert c.kernels["segment_matmul"] == 1


if __name__ == "__main__":
    if sys.argv[1] == "--fake":
        _fake_main(sys.argv[2])
    else:
        sys.exit(_run_ranks(sys.argv[1]))

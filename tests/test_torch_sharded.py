"""The port's sharded message passing on the CPU, against the reference.

A module-scoped fixture runs this file as a script, once: it spawns gloo
ranks (world 2 and world 4, the collectives' 2×2 pod × data layout inside
world 4), each with one thread and a process-group timeout, meeting at a
``FileStore`` under ``tmp_path``; each rank writes its results to an npz
file. Beside it runs a JAX subprocess (this file with ``--jax``) that
forces 4 host devices and runs the reference's collectives under
``shard_map``, as ``tests/_distributed_checks.py`` does. The cases then
hold every rank's results against the single-device reference
(``repro.core.mp``, ``repro.core.ops``, ``repro.models.gnn``,
``repro.fit``, all at ``impl="ref"``) at fp32 rtol 1e-5, atol 1e-5·max:
the shards sum in another order than one device. Every rank computes the
same replicated loss, so its gradients must be the single-device ones.
Sharded ``fit`` losses are held within rtol 1e-4 of ``repro.fit`` (as
``tests/test_torch_train.py`` holds the single-device ones: three AdamW
steps amplify the last bits), its parameters bitwise equal on every rank,
and each rank's checkpoints in a directory of its own.

    python tests/test_torch_sharded.py OUTDIR          # the gloo ranks
    python tests/test_torch_sharded.py --jax OUTDIR    # the JAX collectives
"""
import datetime
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLDS = (2, 4)
V, E, FEAT, HIDDEN, CLASSES, HEADS = 64, 384, 8, 16, 4, 4
FAMILIES = ("gcn", "gin", "sage", "gat")
FIT_FAMILIES = ("gcn", "gat")
FIT_STEPS = 3
FIT_DATA = dict(shapes=((48, 192), (64, 256)), graphs_per_shape=2, feat=16,
                num_classes=8, seed=0)
CASES = [(r, w) for r in ("sum", "mean", "max") for w in (False, True)]
TIMEOUT_S = 240


def _inputs():
    """The seeded numpy inputs every rank and the reference share."""
    rng = np.random.default_rng(7)
    out = {"w": rng.random(E).astype(np.float32),
           "ct": rng.standard_normal((V, FEAT)).astype(np.float32),
           "wt": rng.standard_normal((FEAT, HIDDEN)).astype(np.float32),
           "ct_t": rng.standard_normal((V, HIDDEN)).astype(np.float32)}
    for h in (1, 4):
        shape = (E,) if h == 1 else (E, h)
        out[f"e{h}"] = rng.standard_normal(shape).astype(np.float32)
        out[f"ct_e{h}"] = rng.standard_normal(shape).astype(np.float32)
    # the collectives: a block a rank (4 ranks; 2×2 for the pod layout)
    out["ring"] = rng.standard_normal((4, 16, 4)).astype(np.float32)
    out["ring_odd"] = rng.standard_normal((4, 6, 3)).astype(np.float32)
    out["mm_x"] = rng.standard_normal((16, 64)).astype(np.float32)
    out["mm_w"] = rng.standard_normal((64, 24)).astype(np.float32)
    out["pod"] = rng.standard_normal((2, 2, 16, 8)).astype(np.float32)
    out["pod2"] = rng.standard_normal((2, 2, 16, 8)).astype(np.float32)
    return out


def _graph():
    from repro_torch.data.graphs import synth_graph
    return synth_graph("sharded", V, E, feat=FEAT, seed=3)


# ---------------------------------------------------------------------------
# the ranks (script mode)
# ---------------------------------------------------------------------------

def _raises(exc, fn) -> int:
    try:
        fn()
    except exc:
        return 1
    return 0


def _rank_checks(rank: int, world: int, out: pathlib.Path, res: dict):
    import torch.distributed as dist

    import repro_torch as rt
    from repro_torch.core.dist_mp import (make_shard_mesh,
                                          mp_transform_sharded,
                                          segment_softmax_sharded)
    from repro_torch.data.graphs import synth_typed_graph
    from repro_torch.models.params import from_jax_params
    from repro_torch.train import (GraphEpochProvider, NodeClassification,
                                   Trainer, TrainerConfig)
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.optim.adamw import AdamWConfig

    inp = dict(np.load(out / "inputs.npz"))
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    res["refuse_size"] = _raises(ValueError,
                                 lambda: make_shard_mesh(world + 1,
                                                         device="cpu"))
    res["refuse_no_card"] = _raises(RuntimeError,
                                    lambda: make_shard_mesh(world))
    mesh = make_shard_mesh(world, device="cpu")
    g = _graph()
    pg = g.partition(world, device="cpu")
    pplan = pg.make_plan(feat=FEAT)
    ei = torch.from_numpy(g.edge_index)
    x0 = torch.from_numpy(g.x)

    def grads(y, ct, wrt):
        return torch.autograd.grad((y * ct).sum(), wrt)

    for reduce, weighted in CASES:
        x = x0.clone().requires_grad_()
        w = t["w"].clone().requires_grad_()
        y = rt.mp_sharded(x, pg, reduce=reduce,
                          edge_weight=w if weighted else None, pplan=pplan,
                          mesh=mesh)
        gs = grads(y, t["ct"], [x, w] if weighted else [x])
        key = f"mp_{reduce}_{int(weighted)}"
        res[key] = y.detach().numpy()
        res[key + "_gx"] = gs[0].numpy()
        if weighted:
            res[key + "_gw"] = gs[1].numpy()
    # the ring collective in the merge
    x = x0.clone().requires_grad_()
    w = t["w"].clone().requires_grad_()
    y = rt.mp_sharded(x, pg, edge_weight=w, pplan=pplan, mesh=mesh,
                      collective="ring")
    gx, gw = grads(y, t["ct"], [x, w])
    res.update(ring=y.detach().numpy(), ring_gx=gx.numpy(),
               ring_gw=gw.numpy())
    # mean with a transform (the order from the cost model; never fused)
    x = x0.clone().requires_grad_()
    wt = t["wt"].clone().requires_grad_()
    y = mp_transform_sharded(x, wt, pg, reduce="mean", pplan=pplan,
                             mesh=mesh)
    gx, gwt = grads(y, t["ct_t"], [x, wt])
    res.update(mpt=y.detach().numpy(), mpt_gx=gx.numpy(),
               mpt_gw=gwt.numpy())
    # the softmax: the rank's block; the global loss is the sum over ranks
    # of each block's term, so each rank's gradient is the whole one
    for h in (1, 4):
        e = t[f"e{h}"].clone().requires_grad_()
        p = segment_softmax_sharded(e, pg, pplan=pplan, mesh=mesh)
        ct = pg.shard_edges(t[f"ct_e{h}"], rank)
        (ge,) = grads(p, ct, [e])
        res[f"sm{h}"] = p.detach().numpy()
        res[f"sm{h}_ge"] = ge.numpy()
    res["edge_gather"] = pg.edge_gather[rank].numpy()
    res["edge_valid"] = pg.edge_valid[rank].numpy()

    # the families, called and served
    params = np.load(out / "params.npz")
    dis = torch.from_numpy(g.deg_inv_sqrt)
    for fam in FAMILIES:
        layers = [{k.split("/")[2]: params[k] for k in params.files
                   if k.startswith(f"{fam}/{i}/")} for i in range(3)]
        model = from_jax_params(fam, layers)
        with torch.no_grad():
            res[f"model_{fam}"] = model(x0, ei, V, dis, partition=pg,
                                        mesh=mesh).numpy()
        srv = rt.GNNServer(model, fam, device="cpu", shards=world, mesh=mesh)
        srv.submit(g)
        (served,) = srv.step(flush=True)
        res[f"served_{fam}"] = served.logits
        if fam == "gcn":
            res["refuse_sampled"] = (
                _raises(NotImplementedError,
                        lambda: srv.serve_sampled(None))
                + _raises(NotImplementedError,
                          lambda: srv.sampled_pipeline(None)))

    # typed families refuse a partition
    tg = synth_typed_graph("typed", 32, 96, num_relations=3, feat=FEAT,
                           seed=1)
    rgcn = rt.gnn_init("rgcn", FEAT, HIDDEN, CLASSES, num_relations=3,
                       device="cpu")
    res["refuse_typed_layer"] = _raises(NotImplementedError, lambda: rgcn(
        torch.from_numpy(tg.x), torch.from_numpy(tg.edge_index), 32,
        partition=tg.partition(world, device="cpu"), mesh=mesh,
        edge_type=torch.from_numpy(tg.edge_type)))
    task = NodeClassification(model="rgcn", d_in=FEAT, device="cpu",
                              num_relations=3)
    res["refuse_typed_task"] = _raises(
        NotImplementedError, lambda: task.prepare(tg, mesh=mesh))

    # three steps of sharded training from the reference's initial state
    for fam in FIT_FAMILIES:
        data = GraphEpochProvider(**FIT_DATA)
        task = NodeClassification.from_provider(
            data, model=fam, hidden=32, heads=2 if fam == "gat" else 1,
            device="cpu")
        state = torch.load(out / f"state_{fam}.pt", weights_only=False)
        # every rank checkpoints into its own directory under the shared one
        ckpt_dir = out / f"ckpt_{fam}_{world}"
        cfg = TrainerConfig(opt=AdamWConfig(lr=1e-2, weight_decay=0.01),
                            steps=FIT_STEPS, warmup_steps=2, seed=0,
                            ckpt_dir=str(ckpt_dir), ckpt_every=2)
        fit = Trainer(task, data, cfg, mesh=mesh).fit(state=state)
        res[f"fit_{fam}_ckpt"] = np.asarray([
            ckpt.latest_step(str(ckpt_dir / f"rank{rank}")) or -1,
            ckpt.latest_step(str(ckpt_dir)) or -1])
        res[f"fit_{fam}_losses"] = np.asarray(fit.losses)
        res[f"fit_{fam}_params"] = np.concatenate(
            [p.detach().reshape(-1).numpy()
             for p in fit.state.params.values()])

    if world == 4:
        from repro_torch.distributed import collectives as coll
        res["c_ring"] = coll.ring_allreduce(t["ring"][rank]).numpy()
        res["c_ring_odd"] = coll.ring_allreduce(t["ring_odd"][rank]).numpy()
        res["c_matmul"] = coll.make_ring_matmul()(t["mm_x"],
                                                  t["mm_w"]).numpy()
        pod_group, data_group = coll.pod_data_groups(2, 2)
        p, d = divmod(rank, 2)
        res["c_hier"] = coll.hierarchical_psum(t["pod"][p, d], pod_group,
                                               data_group).numpy()
        ef = torch.zeros(8, 8)
        for i, key in enumerate(("pod", "pod2")):
            red, ef = coll.compressed_psum(t[key][p, d], ef, pod_group,
                                           data_group)
            res[f"c_comp{i}"], res[f"c_comp{i}_ef"] = red.numpy(), ef.numpy()
    dist.barrier()


def _rank_main(rank: int, world: int, outdir: str):
    import torch.distributed as dist
    from repro_torch.core.dist_mp import make_shard_mesh
    torch.set_num_threads(1)
    out = pathlib.Path(outdir)
    res = {"refuse_uninit": _raises(RuntimeError,
                                    lambda: make_shard_mesh(world))}
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(out / f"store{world}"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        _rank_checks(rank, world, out, res)
    finally:
        dist.destroy_process_group()
    np.savez(out / f"w{world}_r{rank}.npz", **res)


def _run_ranks(outdir: str) -> int:
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, w, outdir))
             for w in WORLDS for r in range(w)]
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


def _run_jax_collectives(outdir: str) -> None:
    """The reference's collectives under shard_map on 4 host devices."""
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=4")
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as PS

    from repro.distributed import collectives
    inp = _inputs()
    res = {}
    ring = jax.make_mesh((4,), ("r",))
    for key in ("ring", "ring_odd"):
        res[f"c_{key}"] = np.asarray(shard_map(
            lambda xl: collectives.ring_allreduce(xl[0], "r")[None],
            mesh=ring, in_specs=PS("r"), out_specs=PS("r"),
            check_rep=False)(jnp.asarray(inp[key])))
    res["c_matmul"] = np.asarray(collectives.make_ring_matmul(
        jax.make_mesh((4,), ("model",)), "model")(
        jnp.asarray(inp["mm_x"]), jnp.asarray(inp["mm_w"])))
    pods = jax.make_mesh((2, 2), ("pod", "data"))
    res["c_hier"] = np.asarray(shard_map(
        lambda xl: collectives.hierarchical_psum(
            xl[0, 0], "pod", "data")[None, None],
        mesh=pods, in_specs=PS("pod", "data"), out_specs=PS("pod", "data"),
        check_rep=False)(jnp.asarray(inp["pod"])))

    def comp(x1, x2):
        ef = jnp.zeros((8, 8), jnp.float32)
        outs = []
        for xl in (x1, x2):
            red, ef = collectives.compressed_psum(xl[0, 0], ef, "pod",
                                                  "data")
            outs += [red[None, None], ef[None, None]]
        return tuple(outs)
    got = shard_map(comp, mesh=pods, in_specs=(PS("pod", "data"),) * 2,
                    out_specs=(PS("pod", "data"),) * 4, check_rep=False)(
        jnp.asarray(inp["pod"]), jnp.asarray(inp["pod2"]))
    for i in range(2):
        res[f"c_comp{i}"] = np.asarray(got[2 * i])
        res[f"c_comp{i}_ef"] = np.asarray(got[2 * i + 1])
    np.savez(pathlib.Path(outdir) / "jax_collectives.npz", **res)


# ---------------------------------------------------------------------------
# the fixture: reference state in, both subprocesses, the references
# ---------------------------------------------------------------------------

def _fit_pair(fam):
    from repro import train as jtrain
    from repro.optim import adamw as jadamw
    jd = jtrain.GraphEpochProvider(**FIT_DATA)
    return jtrain.Trainer(
        jtrain.NodeClassification.from_provider(
            jd, model=fam, hidden=32, heads=2 if fam == "gat" else 1,
            impl="ref"),
        jd, jtrain.TrainerConfig(
            opt=jadamw.AdamWConfig(lr=1e-2, weight_decay=0.01),
            steps=FIT_STEPS, warmup_steps=2, seed=0))


def _references(params):
    """Single-device reference results on the same inputs (impl="ref")."""
    import jax
    import jax.numpy as jnp

    from repro.core import ops as jops
    from repro.core.mp import mp as jmp
    from repro.core.mp import mp_transform as jmp_transform
    from repro.models import gnn as jgnn
    inp = {k: jnp.asarray(v) for k, v in _inputs().items()}
    g = _graph()
    ei, x = jnp.asarray(g.edge_index), jnp.asarray(g.x)
    ref = {}
    for reduce, weighted in CASES:
        key = f"mp_{reduce}_{int(weighted)}"
        if weighted:
            y, vjp = jax.vjp(lambda a, w: jmp(
                a, ei, V, reduce=reduce, edge_weight=w, impl="ref"),
                x, inp["w"])
            ref[key + "_gx"], ref[key + "_gw"] = vjp(inp["ct"])
        else:
            y, vjp = jax.vjp(lambda a: jmp(a, ei, V, reduce=reduce,
                                               impl="ref"), x)
            (ref[key + "_gx"],) = vjp(inp["ct"])
        ref[key] = y
    ref["ring"], ref["ring_gx"], ref["ring_gw"] = (
        ref["mp_sum_1"], ref["mp_sum_1_gx"], ref["mp_sum_1_gw"])
    y, vjp = jax.vjp(lambda a, w: jmp_transform(
        a, w, ei, V, reduce="mean", impl="ref"), x, inp["wt"])
    ref["mpt"] = y
    ref["mpt_gx"], ref["mpt_gw"] = vjp(inp["ct_t"])
    for h in (1, 4):
        p, vjp = jax.vjp(lambda e: jops.segment_softmax(e, ei[1], V, "ref"),
                         inp[f"e{h}"])
        ref[f"sm{h}"] = p
        (ref[f"sm{h}_ge"],) = vjp(inp[f"ct_e{h}"])
    dis = jnp.asarray(g.deg_inv_sqrt)
    for fam in FAMILIES:
        ref[f"model_{fam}"] = jgnn.forward(params[fam], fam, x, ei, V, dis,
                                           impl="ref")
    return {k: np.asarray(v) for k, v in ref.items()}


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    import jax

    from repro.models import gnn as jgnn
    from repro_torch.models.params import from_jax_state
    out = tmp_path_factory.mktemp("sharded")
    np.savez(out / "inputs.npz", **_inputs())
    params = {fam: jgnn.init(jax.random.PRNGKey(i), fam, FEAT, HIDDEN,
                             CLASSES, heads=HEADS if fam == "gat" else 1)
              for i, fam in enumerate(FAMILIES)}
    np.savez(out / "params.npz", **{
        f"{fam}/{i}/{k}": np.asarray(p.value)
        for fam, layers in params.items() for i, lay in enumerate(layers)
        for k, p in lay.items()})
    pairs, states = {}, {}
    for fam in FIT_FAMILIES:
        pairs[fam] = _fit_pair(fam)
        states[fam] = pairs[fam].init_state()
        torch.save(from_jax_state(fam, states[fam], device="cpu"),
                   out / f"state_{fam}.pt")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, __file__, *flag, str(out)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for flag in ([], ["--jax"])]
    try:
        ref = _references(params)
        for fam in FIT_FAMILIES:
            ref[f"fit_{fam}_losses"] = np.asarray(
                pairs[fam].fit(state=states[fam]).losses)
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-6000:]
    ranks = {(w, r): dict(np.load(out / f"w{w}_r{r}.npz"))
             for w in WORLDS for r in range(w)}
    ranks["jax"] = dict(np.load(out / "jax_collectives.npz"))
    return ranks, ref


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    atol = 1e-5 * max(float(np.max(np.abs(want))) if want.size else 0.0, 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol, err_msg=what)


def _each_rank(ranks, world):
    return [(r, ranks[(world, r)]) for r in range(world)]


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("reduce,weighted", CASES)
def test_mp_sharded_and_gradients(sharded, world, reduce, weighted):
    ranks, ref = sharded
    key = f"mp_{reduce}_{int(weighted)}"
    for r, res in _each_rank(ranks, world):
        for k in [key, key + "_gx"] + ([key + "_gw"] if weighted else []):
            _close(res[k], ref[k], f"{k} rank {r}")


@pytest.mark.parametrize("world", WORLDS)
def test_ring_collective_in_the_merge(sharded, world):
    ranks, ref = sharded
    for r, res in _each_rank(ranks, world):
        for k in ("ring", "ring_gx", "ring_gw"):
            _close(res[k], ref[k], f"{k} rank {r}")


@pytest.mark.parametrize("world", WORLDS)
def test_mp_transform_sharded_mean(sharded, world):
    ranks, ref = sharded
    for r, res in _each_rank(ranks, world):
        for k in ("mpt", "mpt_gx", "mpt_gw"):
            _close(res[k], ref[k], f"{k} rank {r}")


def test_mp_transform_sharded_refuses_fused_and_max_reorders():
    """The sharded transform never runs the fused arm, and a max does not
    commute with W: both refusals come before any collective."""
    from repro_torch.core.dist_mp import mp_transform_sharded
    g = _graph()
    pg = g.partition(2, device="cpu")
    x, w = torch.from_numpy(g.x), torch.zeros(FEAT, HIDDEN)
    with pytest.raises(ValueError, match="does not commute"):
        mp_transform_sharded(x, w, pg, reduce="max", order="fused")
    with pytest.raises(ValueError, match="fused"):
        mp_transform_sharded(x, w, pg, reduce="sum", order="fused")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("heads", [1, 4])
def test_segment_softmax_sharded(sharded, world, heads):
    ranks, ref = sharded
    want = ref[f"sm{heads}"]
    for r, res in _each_rank(ranks, world):
        valid, rows = res["edge_valid"], res["edge_gather"]
        got = res[f"sm{heads}"]
        assert np.all(got[~valid] == 0.0), "padding must be exactly 0"
        _close(got[valid], want[rows[valid]], f"softmax rank {r}")
        _close(res[f"sm{heads}_ge"], ref[f"sm{heads}_ge"],
               f"softmax grad rank {r}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("family", FAMILIES)
def test_family_logits_called_and_served(sharded, world, family):
    ranks, ref = sharded
    for r, res in _each_rank(ranks, world):
        _close(res[f"model_{family}"], ref[f"model_{family}"],
               f"{family} rank {r}")
        _close(res[f"served_{family}"], ref[f"model_{family}"],
               f"served {family} rank {r}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("family", FIT_FAMILIES)
def test_sharded_fit_matches_reference_and_ranks_agree(sharded, world,
                                                       family):
    ranks, ref = sharded
    first = ranks[(world, 0)][f"fit_{family}_params"]
    for r, res in _each_rank(ranks, world):
        losses = res[f"fit_{family}_losses"]
        assert len(losses) == FIT_STEPS
        np.testing.assert_allclose(losses, ref[f"fit_{family}_losses"],
                                   rtol=1e-4, err_msg=f"rank {r}")
        np.testing.assert_array_equal(res[f"fit_{family}_params"], first,
                                      err_msg=f"rank {r} params")
        # a checkpoint in the rank's own directory, none in the shared one
        own, shared = res[f"fit_{family}_ckpt"]
        assert own >= 2 and shared == -1, (r, own, shared)


@pytest.mark.parametrize("name", ["c_ring", "c_ring_odd", "c_matmul",
                                  "c_hier", "c_comp0", "c_comp1"])
def test_collectives_match_reference(sharded, name):
    """ring_allreduce and ring_psum_matmul against the reference's under
    shard_map (the ring sums in the reference's order: bitwise equal);
    hierarchical_psum and compressed_psum on the 2×2 pod × data layout,
    the second compressed step fed the first's error feedback."""
    ranks, _ = sharded
    want = ranks["jax"][name]
    for r in range(4):
        got = ranks[(4, r)][name]
        if name == "c_matmul":
            _close(got, want, f"{name} rank {r}")
            continue
        p, d = divmod(r, 2)
        blk = want[r] if want.ndim == 3 else want[p, d]
        if name in ("c_ring", "c_comp0", "c_comp1"):
            np.testing.assert_array_equal(got, blk, err_msg=f"rank {r}")
        else:
            _close(got, blk, f"{name} rank {r}")
        if name.startswith("c_comp"):
            np.testing.assert_array_equal(
                ranks[(4, r)][name + "_ef"], ranks["jax"][name + "_ef"][p, d],
                err_msg=f"{name} error feedback rank {r}")


@pytest.mark.parametrize("check", [
    "refuse_uninit", "refuse_size", "refuse_no_card", "refuse_sampled",
    "refuse_typed_layer", "refuse_typed_task"])
@pytest.mark.parametrize("world", WORLDS)
def test_refusals(sharded, check, world):
    """make_shard_mesh raises before init_process_group, for a group of
    another size, and on the card by default (there is none here); the
    sharded server refuses sampled serving (both entry points); typed
    layers and a typed task refuse a mesh."""
    ranks, _ = sharded
    want = 2 if check == "refuse_sampled" else 1
    for r, res in _each_rank(ranks, world):
        assert int(res[check]) == want, f"{check} rank {r}"


if __name__ == "__main__":
    if sys.argv[1] == "--jax":
        _run_jax_collectives(sys.argv[2])
    else:
        sys.exit(_run_ranks(sys.argv[1]))

"""The port's training slice on the CPU, against the reference.

Optimizer and schedules to the reference's fp32 arithmetic; the checkpoint
module as ``tests/test_checkpoint.py`` holds the reference's; the
fault-tolerant loop's replay; providers; the loss; and 5-step trajectories
of every trained family through ``repro_torch.fit`` against ``repro.fit``
at ``impl="ref"``, both started from one state (the reference's initial
state carried over): losses within rtol 1e-4 (both sum in fp32 in their
own orders, and five AdamW steps amplify the last bits), step-0 gradients
within rtol = atol = 1e-5.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
from repro import train as jtrain  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedule as jschedule  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch import train  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.data.graphs import synth_typed_graph  # noqa: E402
from repro_torch.distributed.fault_tolerance import (  # noqa: E402
    ResilientLoop, ResilientLoopConfig)
from repro_torch.models import gnn  # noqa: E402
from repro_torch.models.params import from_jax_state  # noqa: E402
from repro_torch.optim import adamw, schedule  # noqa: E402

SHAPES = ((48, 192), (64, 256))


# ---------------------------------------------------------------------------
# optimizer and schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_matches_reference(state_dtype):
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 3), "b": (7,), "c": ()}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    cfg_kw = dict(lr=3e-2, weight_decay=0.1, grad_clip=0.5,
                  state_dtype=state_dtype)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg_kw), adamw.AdamWConfig(**cfg_kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in params.items()}
    js, ts = jadamw.init(jp, jcfg), adamw.init(tp, tcfg)
    for step in range(4):
        grads = {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in shapes.items()}
        scale = jschedule.warmup_cosine(step, 2, 4)
        jp, js, jm = jadamw.update({k: jnp.asarray(g) for k, g in
                                    grads.items()}, js, jp, jcfg, scale)
        tp, ts, tm = adamw.update({k: torch.from_numpy(g) for k, g in
                                   grads.items()}, ts, tp, tcfg,
                                  schedule.warmup_cosine(step, 2, 4))
        assert ts.step == int(js.step) == step + 1
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert tm["lr"] == float(jm["lr"])
        for k in shapes:
            assert tp[k].requires_grad
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7)
            for tmom, jmom in ((ts.mu[k], js.mu[k]), (ts.nu[k], js.nu[k])):
                got = adamw._decode(tmom, state_dtype).numpy()
                want = np.asarray(jadamw._decode(jmom, state_dtype))
                # int8: a moment may round to the next step of the scale
                tol = (float(np.max(np.abs(want))) / 127 * 1.01
                       if state_dtype == "int8" else 1e-6)
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=tol)


@pytest.mark.parametrize("name", ["warmup_cosine", "constant"])
def test_schedules_match_reference(name):
    # both in fp32; numpy's and XLA's cosines may differ in the last bit
    for step in range(0, 25):
        got = schedule.get(name)(step, 5, 20)
        want = float(jschedule.get(name)(step, 5, 20))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=str(step))
    with pytest.raises(ValueError, match="unknown LR schedule"):
        schedule.get("linear")


# ---------------------------------------------------------------------------
# checkpoints (following tests/test_checkpoint.py)
# ---------------------------------------------------------------------------

def _tree():
    return {
        "w": torch.arange(12.0).reshape(3, 4).requires_grad_(),
        "opt": {"mu": adamw.QTensor(torch.ones((3, 4), dtype=torch.int8),
                                    torch.tensor(0.5))},
        "step": 7,
        "bf": torch.ones((2, 2), dtype=torch.bfloat16) * 1.5,
        "np": np.arange(3, dtype=np.int64),
    }


def _leaves(tree):
    return [leaf for _, leaf in ckpt._flatten(tree)]


def test_checkpoint_roundtrip_with_bf16(tmp_path):
    tree = _tree()
    ckpt.save(tree, tmp_path, 10)
    manifest = json.loads((tmp_path / "step_10" / "MANIFEST.json")
                          .read_text())
    assert {"bfloat16", "int8", "float32"} <= {
        leaf["dtype"] for leaf in manifest["leaves"]}
    back = ckpt.restore(tree, tmp_path)
    assert back["step"] == 7 and isinstance(back["opt"]["mu"], adamw.QTensor)
    assert back["w"].requires_grad
    for a, b in zip(_leaves(tree), _leaves(back)):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a.detach(), b.detach())
        else:
            np.testing.assert_array_equal(a, b)


def test_checkpoint_incomplete_ignored(tmp_path):
    tree = _tree()
    ckpt.save(tree, tmp_path, 10)
    (tmp_path / "step_20").mkdir()                  # a crash mid-save
    (tmp_path / "step_20" / "junk.npy").write_bytes(b"xx")
    assert ckpt.latest_step(tmp_path) == 10
    assert ckpt.restore(tree, tmp_path)["step"] == 7


def test_checkpoint_retention_and_async(tmp_path):
    tree = _tree()
    for s in (10, 20, 30):
        ckpt.save(tree, tmp_path, s, keep=2)
    assert not (tmp_path / "step_10").exists()
    assert ckpt.latest_step(tmp_path) == 30
    th = ckpt.save_async(tree, tmp_path / "a", 5)
    tree["w"].data.fill_(-1.0)          # the snapshot was taken already
    th.join(timeout=30)
    assert not th.is_alive()
    ckpt.wait_pending()
    assert ckpt.latest_step(tmp_path / "a") == 5
    assert float(ckpt.restore(tree, tmp_path / "a")["w"][2, 3].detach()) == \
        11.0


def test_checkpoint_shape_mismatch_and_latest_at_or_before(tmp_path):
    tree = _tree()
    ckpt.save(tree, tmp_path, 1)
    bad = dict(tree, w=torch.zeros(5, 4))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(bad, tmp_path)
    for s in (2, 5, 9):
        ckpt.save({"x": np.ones(3) * s}, tmp_path / "b", s)
    assert ckpt.latest_step(tmp_path / "b") == 9
    assert ckpt.latest_step(tmp_path / "b", at_or_before=5) == 5
    assert ckpt.latest_step(tmp_path / "b", at_or_before=4) == 2
    assert ckpt.latest_step(tmp_path / "b", at_or_before=1) is None


def test_resilient_loop_replays_after_an_injected_failure(tmp_path):
    def step_fn(state, step):
        return {"x": state["x"] + step}, {}

    fired = []

    def faulty(step, metrics, verdict):
        if step == 5 and not fired:
            fired.append(step)
            raise RuntimeError("injected")

    loop = ResilientLoop(ResilientLoopConfig(str(tmp_path), ckpt_every=2),
                         step_fn, {"x": torch.zeros(())})
    final = loop.run(8, metrics_cb=faulty)
    assert float(final["x"]) == sum(range(8))
    assert ("restored", 4) in loop.events
    assert any(e[0] == "failure" for e in loop.events)


# ---------------------------------------------------------------------------
# providers, task, loss
# ---------------------------------------------------------------------------

def test_provider_matches_reference_and_counts_buckets():
    kw = dict(shapes=SHAPES, graphs_per_shape=2, feat=8, num_classes=4)
    data, jdata = train.GraphEpochProvider(**kw), jtrain.GraphEpochProvider(
        **kw)
    assert isinstance(data, train.DatasetProvider) and len(data) == 4
    assert data.batch(1) is data.batch(1 + len(data))
    for step in range(len(data)):
        np.testing.assert_array_equal(data.batch(step).edge_index,
                                      jdata.batch(step).edge_index)
        np.testing.assert_array_equal(data.batch(step).x,
                                      jdata.batch(step).x)
    task = train.NodeClassification.from_provider(data, hidden=16,
                                                  device="cpu")
    assert isinstance(task, train.Task)
    trainer = train.Trainer(task, data, train.TrainerConfig(steps=6,
                                                            warmup_steps=1))
    res = trainer.fit()
    assert res.steps == 6 and len(res.losses) == 6
    assert len(res.buckets) == len(SHAPES)
    # each graph is planned once, with its source order
    g = data.batch(0)
    assert g.make_plan(task.plan_feat, device="cpu") is \
        task.prepare(g)[0]["plan"]
    with pytest.raises(ValueError, match="disagree"):
        train.NodeClassification.from_provider(data, model="rgcn",
                                               device="cpu").prepare(g)
    with pytest.raises(NotImplementedError, match="item 6"):
        task.prepare(g, mesh=object())


def test_loss_fn_matches_reference():
    g = synth_typed_graph("t", 40, 160, num_relations=3, feat=8,
                          num_classes=4, seed=0)
    for family in ("gcn", "rgcn"):
        typed = family == "rgcn"
        params = jgnn.init(jax.random.PRNGKey(0), family, 8, 16, 4,
                           num_relations=3)
        tkw = dict(edge_type=g.edge_type, type_perm=g.type_perm,
                   inv_type_perm=g.inv_type_perm,
                   type_counts=g.type_counts) if typed else {}
        want = jgnn.loss_fn(params, family, jnp.asarray(g.x),
                            jnp.asarray(g.edge_index), jnp.asarray(g.labels),
                            g.num_nodes, jnp.asarray(g.deg_inv_sqrt),
                            **{k: jnp.asarray(v) for k, v in tkw.items()})
        model = rt.from_jax_params(family, [
            {k: np.asarray(p.value) for k, p in lay.items()}
            for lay in params])
        got = gnn.loss_fn(model, torch.from_numpy(g.x),
                          torch.from_numpy(g.edge_index),
                          torch.from_numpy(g.labels), g.num_nodes,
                          torch.from_numpy(g.deg_inv_sqrt),
                          **{k: torch.from_numpy(v) for k, v in tkw.items()})
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# trajectories against repro.fit, and resume
# ---------------------------------------------------------------------------

def _pair(family, steps=5, ckpt_dir=None, ckpt_every=3):
    """(reference trainer, port trainer) on the same graphs and config."""
    typed = family in gnn.TYPED_MODELS
    kw = dict(shapes=SHAPES[:1] if typed else SHAPES, graphs_per_shape=2,
              feat=16, num_classes=8, typed=typed, num_relations=3, seed=0)
    heads = 2 if family in ("gat", "rgat") else 1
    cfg = dict(steps=steps, warmup_steps=2, seed=0, ckpt_dir=ckpt_dir,
               ckpt_every=ckpt_every)
    jd = jtrain.GraphEpochProvider(**kw)
    jt = jtrain.Trainer(
        jtrain.NodeClassification.from_provider(jd, model=family, hidden=32,
                                                heads=heads, impl="ref"),
        jd, jtrain.TrainerConfig(opt=jadamw.AdamWConfig(
            lr=1e-2, weight_decay=0.01), **cfg))
    td = train.GraphEpochProvider(**kw)
    tt = train.Trainer(
        train.NodeClassification.from_provider(td, model=family, hidden=32,
                                               heads=heads, device="cpu"),
        td, train.TrainerConfig(opt=adamw.AdamWConfig(
            lr=1e-2, weight_decay=0.01), **cfg))
    return jt, tt


@pytest.mark.parametrize("family", ["gcn", "gin", "sage", "gat", "rgcn",
                                    "rgat"])
def test_fit_trajectory_matches_reference(family):
    jt, tt = _pair(family)
    jstate = jt.init_state()
    state = from_jax_state(family, jstate, device="cpu")
    # step-0 gradients, from the same state on the same batch
    arrays, static = jt.task.prepare(jt.data.batch(0))
    jgrads = jax.grad(lambda p: jt.task.loss(p, arrays, static, None)[0])(
        jstate.params)
    tarrays, tstatic = tt.task.prepare(tt.data.batch(0))
    loss, _ = tt.task.loss(state.params, tarrays, tstatic)
    tgrads = dict(zip(state.params, torch.autograd.grad(
        loss, list(state.params.values()))))
    jflat = from_jax_state(family, jstate._replace(params=jgrads),
                           device="cpu").params
    for k, g in tgrads.items():
        np.testing.assert_allclose(g.numpy(), jflat[k].detach().numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    want = jt.fit(state=jstate)
    got = tt.fit(state=state)
    assert len(got.losses) == 5
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
    assert got.losses[-1] < got.losses[0]


def test_from_jax_state_runs_on_the_card_by_default():
    """Like every entry point, from_jax_state puts its tensors on the card
    unless the caller asks for the CPU, and raises without a card."""
    jt, _ = _pair("gcn")
    jstate = jt.init_state()
    state = from_jax_state("gcn", jstate, device="cpu")
    assert all(p.device.type == "cpu" for p in state.params.values())
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        from_jax_state("gcn", jstate)


def test_kill_and_resume_is_bitwise(tmp_path):
    """A run killed after its step-6 checkpoint and resumed gives the
    uninterrupted run's losses and final state, bit for bit."""
    _, full_t = _pair("gat", steps=10)
    full = full_t.fit()

    class Killed(Exception):
        pass

    def killer(step, metrics, verdict):
        if step == 7:
            raise Killed()          # not in ResilientLoop's catch list

    _, part = _pair("gat", steps=10, ckpt_dir=str(tmp_path))
    with pytest.raises(Killed):
        part.fit(metrics_cb=killer)
    assert ckpt.latest_step(tmp_path) == 6
    _, again = _pair("gat", steps=10, ckpt_dir=str(tmp_path))
    res = again.fit(resume=True)
    assert res.start_step == 6 and res.losses == full.losses[6:]
    for k, p in full.state.params.items():
        assert torch.equal(p, res.state.params[k]), k
    assert res.state.opt_state.step == full.state.opt_state.step == 10
    with pytest.raises(ValueError, match="not both"):
        again.fit(resume=True, state=again.init_state())


def test_fault_tolerant_replay_inside_fit(tmp_path):
    _, clean_t = _pair("gcn", steps=8)
    clean = clean_t.fit()
    fired = []

    def faulty(step, metrics, verdict):
        if step == 5 and not fired:
            fired.append(step)
            raise RuntimeError("injected")

    _, t = _pair("gcn", steps=8, ckpt_dir=str(tmp_path), ckpt_every=2)
    res = t.fit(metrics_cb=faulty)
    assert res.losses == clean.losses
    assert ("restored", 4) in res.events
    assert rt.fit is train.fit and repro.fit is jtrain.fit

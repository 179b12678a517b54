"""The port's LM task, provider, trainer and CLI on the CPU against the
reference.

``TokenProvider`` batches are bitwise the reference's. For reduced
qwen3-8b and qwen3-moe: 5-step ``fit`` trajectories of ``LMTask`` with
fp32 AdamW states, both trainers started from the reference's initial
state, the losses within rtol 1e-4 a step (both sum in fp32 in their own
orders, and AdamW steps amplify the last bits); with int8 states, each of
5 steps from the reference's state at that step (see that test for why).
The in-place
AdamW is bitwise the functional one; a killed run resumed from its
checkpoint, and a run that fails before its first checkpoint and replays
from its rebuilt entry state, are bitwise the uninterrupted run; ``fit``
leaves a given state as it was. ``build_step`` is None on one device and
raises with a mesh; the served paths build no autograd graph; the CLI
trains two steps with ``--device cpu``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jcfglib  # noqa: E402
from repro import train as jtrain  # noqa: E402
from repro.data import tokens as jtokens  # noqa: E402
from repro.models.params import P  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import configs as cfglib  # noqa: E402
from repro_torch import train  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.data import tokens  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.params import from_jax_lm_params  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve import lm as serve_lm  # noqa: E402

DATA = dict(seq_len=8, global_batch=2, seed=1)
LR = 1e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the
    machine's cores, and these tests' many small ops slow down by an
    order of magnitude when each worker's pool spans every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree_np(tree):
    return jax.tree_util.tree_map(lambda p: np.asarray(p.value), tree,
                                  is_leaf=lambda x: isinstance(x, P))


def _port_state(cfg, jstate, opt):
    """The reference's initial TrainState as the port's: its parameters
    carried over, zero moments, step 0."""
    model = from_jax_lm_params(cfg, _tree_np(jstate.params), device="cpu")
    params = {k: p.detach().clone().requires_grad_()
              for k, p in model.named_parameters()}
    return train.TrainState(params, adamw.init(params, opt), 0,
                            torch.Generator().manual_seed(0).get_state())


def _trainer(cfg, steps=5, state_dtype="float32", moe_impl="capacity",
             **kw):
    opt = adamw.AdamWConfig(lr=LR, weight_decay=0.01,
                            state_dtype=state_dtype)
    data = train.TokenProvider(tokens.TokenDatasetConfig(
        vocab_size=cfg.vocab_size, **DATA))
    task = train.LMTask(cfg, moe_impl=moe_impl, device="cpu")
    return train.Trainer(task, data, train.TrainerConfig(
        steps=steps, opt=opt, warmup_steps=2, seed=0, **kw))


@pytest.mark.parametrize("hosts", [1, 2])
def test_token_provider_is_bitwise_the_reference(hosts):
    cfg = dict(vocab_size=300, seq_len=12, global_batch=4, seed=3)
    for host in range(hosts):
        ours = train.TokenProvider(tokens.TokenDatasetConfig(**cfg),
                                   host_id=host, num_hosts=hosts)
        ref = jtrain.TokenProvider(jtokens.TokenDatasetConfig(**cfg),
                                   host_id=host, num_hosts=hosts)
        assert isinstance(ours, train.DatasetProvider)
        for step in (0, 3, 3, 11):
            a, b = ours.batch(step), ref.batch(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def _pair(arch, state_dtype):
    jcfg = jcfglib.get_config(arch).reduced()
    cfg = cfglib.get_config(arch).reduced()
    opt_kw = dict(lr=LR, weight_decay=0.01, state_dtype=state_dtype)
    jt = jtrain.Trainer(
        jtrain.LMTask(jcfg), jtrain.TokenProvider(jtokens.TokenDatasetConfig(
            vocab_size=jcfg.vocab_size, **DATA)),
        jtrain.TrainerConfig(steps=5, opt=jadamw.AdamWConfig(**opt_kw),
                             warmup_steps=2, seed=0))
    return cfg, jt, _trainer(cfg, state_dtype=state_dtype)


@pytest.mark.parametrize("arch", ["qwen3-8b", "qwen3-moe-30b-a3b"])
def test_fit_trajectory_matches_reference(arch):
    """fp32 moments: the two 5-step trajectories from one state."""
    cfg, jt, tt = _pair(arch, "float32")
    jstate = jt.init_state()
    state = _port_state(cfg, jstate, tt.cfg.opt)
    want = jt.fit(state=jstate)
    got = tt.fit(state=state)
    assert len(got.losses) == 5 and got.buckets == (train.LMStatic(2, 8),)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)


def _named(cfg, tree):
    """A numpy tree shaped as the reference's LM parameters, as
    ``{port name: tensor}``."""
    return {k: p.detach() for k, p in from_jax_lm_params(
        cfg, tree, device="cpu").named_parameters()}


def _int8_moments(cfg, tree):
    """The reference's int8 moment tree (a ``QTensor`` in each ``P``) as
    the port's: a period slot's stacked moment shares its one scale among
    the port's per-layer tensors."""
    is_p = lambda x: isinstance(x, P)   # noqa: E731
    q = _named(cfg, jax.tree_util.tree_map(
        lambda p: np.asarray(p.value.q), tree, is_leaf=is_p))
    scale = _named(cfg, jax.tree_util.tree_map(
        lambda p: np.full(p.value.q.shape, np.asarray(p.value.scale),
                          np.float32), tree, is_leaf=is_p))
    return {k: adamw.QTensor(v.to(torch.int8), scale[k].reshape(-1)[0]
                             .clone()) for k, v in q.items()}


@pytest.mark.parametrize("arch", ["qwen3-8b", "qwen3-moe-30b-a3b"])
def test_int8_steps_match_reference_from_its_states(arch):
    """int8 moments, step by step: each of 3 steps of the port's trainer
    starts from the reference's state at that step (its parameters, int8
    moments and step count carried over) and is held to the reference's
    step: the loss within rtol 1e-4, the updated parameters within
    1e-4·max|p| where the carried second moment is not 0. A free
    trajectory is no test here: with per-tensor absmax
    scales a second moment below 1/254 of its tensor's largest rounds to
    0, its update becomes m/eps, and both trajectories blow up along
    whichever element's rounding a last-bit difference flips. The
    re-quantized moments are held to the reference's too: each scale
    within rtol 1e-4 (a period slot's layers share the scale of the
    reference's stacked moment), each int8 payload within 1 (a rounding
    that a last-bit difference in the gradient flips)."""
    cfg, jt, tt = _pair(arch, "int8")
    jstate = jt.init_state()
    for step in range(3):
        arrays, static = jt.task.prepare(jt.data.batch(step))
        jnext, jm = jt._executable(static)(jstate, arrays)
        params = {k: v.clone().requires_grad_() for k, v in _named(
            cfg, _tree_np(jstate.params)).items()}
        opt = adamw.AdamWState(int(jstate.opt_state.step),
                               _int8_moments(cfg, jstate.opt_state.mu),
                               _int8_moments(cfg, jstate.opt_state.nu))
        state = train.TrainState(params, opt, int(jstate.step),
                                 torch.Generator().get_state())
        new, metrics = tt.step(state, step)
        np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        want = _named(cfg, _tree_np(jnext.params))
        for k, p in new.params.items():
            # where the carried second moment is 0 the update is
            # m / (c·|g| + eps), which a last-bit difference in a small
            # gradient moves by any amount
            held = opt.nu[k].q != 0
            assert bool(held.any()), k
            np.testing.assert_allclose(
                p.detach()[held].numpy(), want[k][held].numpy(), rtol=0,
                atol=1e-4 * float(want[k].abs().max()), err_msg=k)
        assert new.opt_state.step == int(jnext.opt_state.step) == step + 1
        for got, want_q in ((new.opt_state.mu, jnext.opt_state.mu),
                            (new.opt_state.nu, jnext.opt_state.nu)):
            want_q = _int8_moments(cfg, want_q)
            for k, m in got.items():
                np.testing.assert_allclose(float(m.scale),
                                           float(want_q[k].scale), rtol=1e-4,
                                           err_msg=k)
                diff = (m.q.int() - want_q[k].q.int()).abs()
                assert int(diff.max()) <= 1, k
        jstate = jnext


def test_every_arch_trains_through_fit():
    """``fit`` trains each of the ten archs at reduced() on the CPU from
    token batches alone (internvl2 with no prefix, whisper with no encoder
    input): finite losses, and every parameter the loss reads gets a
    gradient."""
    for arch in cfglib.ARCH_NAMES:
        cfg = cfglib.get_config(arch).reduced()
        t = _trainer(cfg, steps=2, moe_impl="ragged")
        init = t.init_state()
        arrays, static = t.task.prepare(t.data.batch(0))
        loss, _ = t.task.loss(init.params, arrays, static)
        grads = torch.autograd.grad(loss, list(init.params.values()),
                                    allow_unused=True)
        unread = {k for k, g in zip(init.params, grads) if g is None}
        # cohere's parallel block reads no norm2; whisper's encoder and
        # cross-attention read nothing without encoder input
        assert all(".norm2." in k or ".cross." in k or ".norm_x." in k
                   or k.startswith("enc_") for k in unread), (arch, unread)
        res = t.fit()
        assert len(res.losses) == 2 and all(np.isfinite(res.losses)), arch
        assert res.state.opt_state.step == 2
        assert not torch.equal(res.state.params["embed.table"],
                               init.params["embed.table"]), arch


def test_adamw_update_in_place_is_bitwise_the_functional_update():
    rng = np.random.default_rng(0)
    for state_dtype in ("float32", "bfloat16", "int8"):
        cfg = adamw.AdamWConfig(lr=3e-2, state_dtype=state_dtype)
        params = {k: torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).to(dt).requires_grad_()
            for k, s, dt in (("a", (9, 5), torch.float32),
                             ("b", (7,), torch.bfloat16))}
        p_f, s_f = params, adamw.init(params, cfg)
        p_i = {k: p.detach().clone().requires_grad_()
               for k, p in params.items()}
        s_i = adamw.init(p_i, cfg)
        for _ in range(3):
            grads = {k: torch.from_numpy(rng.standard_normal(
                p.shape).astype(np.float32)).to(p.dtype)
                for k, p in params.items()}
            before = {k: p.clone() for k, p in p_f.items()}
            p_f, s_f, _ = adamw.update(grads, s_f, p_f, cfg, 0.5)
            ids = {k: id(p) for k, p in p_i.items()}
            p_i, s_i, _ = adamw.update_(grads, s_i, p_i, cfg, 0.5)
            assert {k: id(p) for k, p in p_i.items()} == ids
            assert not any(torch.equal(before[k], p_f[k]) for k in before)
        for k in params:
            assert torch.equal(p_f[k], p_i[k]) and p_i[k].requires_grad
            for a, b in ((s_f.mu[k], s_i.mu[k]), (s_f.nu[k], s_i.nu[k])):
                assert torch.equal(adamw._decode(a, state_dtype),
                                   adamw._decode(b, state_dtype))
        assert s_f.step == s_i.step == 3


def test_adamw_int8_groups_share_the_slot_absmax():
    """int8 moments of a group are quantized by the absmax over all of the
    group (the reference's stacked tensor: the same q and scale as one
    tensor of the members stacked), each member holding that scale in a
    tensor of its own; ``update`` and ``update_`` give the same bits; a
    member alone, or no groups, is the tensor's own absmax."""
    rng = np.random.default_rng(1)
    cfg = adamw.AdamWConfig(lr=3e-2, state_dtype="int8")
    shapes = {"l1.w": (6, 4), "l3.w": (6, 4), "l2.w": (5,), "lead": (3,)}
    params = {k: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).requires_grad_() for k, s in shapes.items()}
    groups = (("l1.w", "l3.w"), ("l2.w",))
    stacked = {"w": torch.stack([params["l1.w"], params["l3.w"]]).detach()
               .clone().requires_grad_(), "l2.w": params["l2.w"].detach()
               .clone().requires_grad_(), "lead": params["lead"].detach()
               .clone().requires_grad_()}
    state = adamw.init(params, cfg)
    p_i = {k: p.detach().clone().requires_grad_() for k, p in params.items()}
    s_i = adamw.init(p_i, cfg)
    s_st = adamw.init(stacked, cfg)
    for _ in range(3):
        grads = {k: torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)) for k, s in shapes.items()}
        g_st = {"w": torch.stack([grads["l1.w"], grads["l3.w"]]),
                "l2.w": grads["l2.w"], "lead": grads["lead"]}
        params, state, _ = adamw.update(grads, state, params, cfg, 0.5,
                                        groups)
        p_i, s_i, _ = adamw.update_(grads, s_i, p_i, cfg, 0.5, groups)
        stacked, s_st, _ = adamw.update(g_st, s_st, stacked, cfg, 0.5)
    for tree_f, tree_i, tree_s in ((state.mu, s_i.mu, s_st.mu),
                                   (state.nu, s_i.nu, s_st.nu)):
        assert tree_f["l1.w"].scale is not tree_f["l3.w"].scale
        for k in shapes:
            assert torch.equal(tree_f[k].q, tree_i[k].q)
            assert torch.equal(tree_f[k].scale, tree_i[k].scale)
        want = tree_s["w"]
        for i, k in enumerate(("l1.w", "l3.w")):
            assert torch.equal(tree_f[k].q, want.q[i])
            assert torch.equal(tree_f[k].scale, want.scale)
        for k in ("l2.w", "lead"):
            assert torch.equal(tree_f[k].q, tree_s[k].q)
            assert torch.equal(tree_f[k].scale, tree_s[k].scale)
    for k in shapes:
        assert torch.equal(params[k], p_i[k])
    np.testing.assert_array_equal(
        torch.stack([params["l1.w"], params["l3.w"]]).detach().numpy(),
        stacked["w"].detach().numpy())


def test_kill_and_resume_is_bitwise(tmp_path):
    cfg = cfglib.get_config("qwen3-moe-30b-a3b").reduced()
    full = _trainer(cfg, steps=4).fit()

    class Killed(Exception):
        pass

    def killer(step, metrics, verdict):
        if step == 2:
            raise Killed()          # not in ResilientLoop's catch list

    with pytest.raises(Killed):
        _trainer(cfg, steps=4, ckpt_dir=str(tmp_path),
                 ckpt_every=2).fit(metrics_cb=killer)
    assert ckpt.latest_step(tmp_path) == 2
    res = _trainer(cfg, steps=4, ckpt_dir=str(tmp_path),
                   ckpt_every=2).fit(resume=True)
    assert res.start_step == 2 and res.losses == full.losses[2:]
    for k, p in full.state.params.items():
        assert torch.equal(p, res.state.params[k]), k


def test_replay_from_the_rebuilt_entry_state_is_bitwise():
    """A failure before any checkpoint rolls back to the state the run
    entered with: the trainer updates its state in place, so the loop
    rebuilds it (init_state again, or a copy of the given state)."""
    cfg = cfglib.get_config("qwen3-8b").reduced()
    clean = _trainer(cfg, steps=4).fit()
    fired = []

    def faulty(step, metrics, verdict):
        if step == 2 and not fired:
            fired.append(step)
            raise RuntimeError("injected")

    t = _trainer(cfg, steps=4)
    res = t.fit(metrics_cb=faulty)
    assert ("restored_entry", 0) in res.events
    assert res.losses == clean.losses
    # a given state: fit trains a copy, and replays from another
    given = t.init_state()
    before = {k: p.clone() for k, p in given.params.items()}
    fired.clear()
    res2 = t.fit(state=given, metrics_cb=faulty)
    assert res2.losses == clean.losses
    assert all(torch.equal(before[k], p) for k, p in given.params.items())
    for k, p in clean.state.params.items():
        assert torch.equal(p, res.state.params[k])
        assert torch.equal(p, res2.state.params[k])


def test_build_step_and_mesh():
    cfg = cfglib.get_config("qwen3-8b").reduced()
    task = train.LMTask(cfg, device="cpu")
    static = train.LMStatic(2, 8)
    assert task.build_step(train.TrainerConfig(), None, static) is None
    with pytest.raises(NotImplementedError, match="LM-sharding"):
        task.build_step(train.TrainerConfig(), object(), static)
    with pytest.raises(NotImplementedError, match="LM-sharding"):
        task.prepare({"tokens": np.zeros((2, 8), np.int32)}, mesh=object())
    assert isinstance(task, train.Task)
    assert {"LMTask", "LMStatic", "TokenProvider"} <= set(train.__all__)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.LMTask(cfg)


def test_serving_builds_no_graph():
    """The served paths stay gradient-free: the LM's parameters are frozen
    and decode runs under no_grad."""
    cfg = cfglib.get_config("qwen3-moe-30b-a3b").reduced()
    model = lm.LM(cfg, device="cpu", seed=0)
    assert not any(p.requires_grad for p in model.parameters())
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 5)))
    state = lm.init_decode_state(cfg, 2, 8, torch.float32, device="cpu")
    logits, state = serve.prefill_into_cache(model, toks, state)
    assert not logits.requires_grad and logits.grad_fn is None
    logits, _ = lm.decode_step(model, toks[:, :1], state)
    assert not logits.requires_grad
    for cache in state.period[0]:
        assert not cache.requires_grad
    batcher = serve_lm.ContinuousBatcher(model, 2, 12, dtype=torch.float32)
    batcher.submit(serve_lm.Request(0, toks[0].numpy(), 2))
    batcher.tick()
    assert batcher.last_logits is not None
    assert not batcher.last_logits.requires_grad


def test_launch_train_main_two_steps_on_the_cpu(tmp_path, capsys):
    """The CLI trains two steps of reduced_100m on the CPU (no checkpoint
    falls due; resuming is ``fit(resume=True)``, tested above)."""
    losses = launch_train.main([
        "--arch", "qwen3-moe-30b-a3b", "--reduced", "--device", "cpu",
        "--steps", "2", "--batch", "2", "--seq", "8",
        "--ckpt-dir", str(tmp_path), "--log-every", "1"])
    out = capsys.readouterr().out
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "arch=qwen3-moe-30b-a3b params=" in out and "final loss" in out
    assert "step     1 loss" in out and ckpt.latest_step(tmp_path) is None
    # the serve CLI reads the same reduced config
    assert serve.reduced_100m is launch_train.reduced_100m
    cfg = launch_train.reduced_100m(cfglib.get_config("qwen3-8b"))
    assert (cfg.d_model, cfg.vocab_size, cfg.dtype) == (512, 32768,
                                                        "float32")
    assert repro_torch.fit is train.fit
    assert dataclasses.is_dataclass(train.LMTask)

"""The port's LM training math on the CPU against the reference.

Loss and gradients: for each of the ten archs at ``reduced()`` size (MoE
archs under ``"capacity"`` and ``"ragged"``; internvl2 with
``prefix_embeds``, whisper with ``enc_embeds``; one case with a partial
``mask``), weights carried from ``repro.models.lm.init``, the port's
``loss_fn`` and its gradients against ``jax.value_and_grad`` of the
reference's. fp32: the loss within rtol 1e-5; each gradient within
atol 1e-4·max|g| of the reference's (both sum in fp32, in their own
orders, through every layer of the backward), where max|g| is at least
1e-3 of the model's largest gradient: a gradient that is 0 in exact
arithmetic (whisper's key bias, which shifts every score of a row alike)
is rounding noise in both.

The embedding's backward (sorted segment reduction) against ``jax.vjp`` of
the reference's ``layers.embed``, with repeated and unused ids: fp32
within 1e-6; bf16 within 2e-2·max|oracle| of the fp32 cast-then-reduce
oracle of ``tests/test_precision.py`` (the bf16 rounding of the output).
The MoE layer's backward with experts that receive no token against
``jax.vjp`` of the reference's ``moe_ragged``: the output within 1e-5,
each gradient within 1e-4·max|g| (the router's sums its tokens' terms in
another order). The remat
policies give bitwise-equal gradients, and "dots" recomputes fewer
matmuls than "full".
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfglib  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.models.params import P  # noqa: E402

from repro_torch import configs as cfglib  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models import layers, lm, moe  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.params import carry, from_jax_lm_params  # noqa

KEY = jax.random.PRNGKey(0)
MOE_ARCHS = [a for a in jcfglib.ARCH_NAMES
             if jcfglib.get_config(a).num_experts]
CASES = ([(a, "capacity") for a in jcfglib.ARCH_NAMES]
         + [(a, "ragged") for a in MOE_ARCHS])


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the
    machine's cores, and these tests' many small ops slow down by an
    order of magnitude when each worker's pool spans every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tree_np(tree):
    return jax.tree_util.tree_map(lambda p: np.asarray(p.value), tree,
                                  is_leaf=lambda x: isinstance(x, P))


def port_params(cfg, jtree):
    """The reference's tree as the port's flat ``{name: leaf}`` dict."""
    model = from_jax_lm_params(cfg, tree_np(jtree), device="cpu")
    return {k: p.detach().clone().requires_grad_()
            for k, p in model.named_parameters()}


def batches(cfg, seed=0, b=2, s=8, partial_mask=False):
    """(reference batch, port batch) from one numpy draw."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    arrs = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        arrs["prefix_embeds"] = rng.standard_normal(
            (b, cfg.num_prefix_embeds, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        arrs["enc_embeds"] = rng.standard_normal(
            (b, 6, cfg.d_model)).astype(np.float32)
    if partial_mask:
        arrs["mask"] = (rng.random((b, s)) < 0.6).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v) for k, v in arrs.items()})


@pytest.mark.parametrize("arch,impl", CASES)
def test_loss_and_grads_match_reference(arch, impl):
    jcfg = jcfglib.get_config(arch).reduced()
    cfg = cfglib.get_config(arch).reduced()
    jprm = jlm.init(KEY, jcfg)
    jbatch, batch = batches(cfg, partial_mask=arch == "qwen3-8b")
    (want, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, jcfg, b, remat_policy="none",
                                 moe_impl=impl), has_aux=True))(jprm, jbatch)
    params = port_params(cfg, jprm)
    loss, metrics = lm.loss_fn(params, cfg, batch, remat_policy="none",
                               moe_impl=impl)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(metrics["ce"].item(), float(jm["ce"]),
                               rtol=1e-5)
    np.testing.assert_allclose(metrics["moe_aux"].item(),
                               float(jm["moe_aux"]), rtol=1e-5, atol=1e-7)
    # a parameter the forward never reads (cohere's norm2) gets None here
    # and zeros from jax.grad
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), torch.autograd.grad(
                 loss, list(params.values()), allow_unused=True))}
    want_g = {k: w.detach().numpy() for k, w in from_jax_lm_params(
        cfg, tree_np(jgrads), device="cpu").named_parameters()}
    assert set(grads) == set(want_g)
    floor = 1e-3 * max(float(np.abs(w).max()) for w in want_g.values())
    for k, g in grads.items():
        w = want_g[k]
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0,
            atol=1e-4 * max(float(np.abs(w).max()), floor), err_msg=k)


def test_loss_fn_on_a_model_equals_the_params_dict():
    """An LM module and its flat parameter dict (through the meta-device
    skeleton) give the same loss; the skeleton holds no data."""
    cfg = cfglib.get_config("qwen3-moe-30b-a3b").reduced()
    model = lm.LM(cfg, device="cpu", seed=2)
    _, batch = batches(cfg, seed=3)
    want, _ = lm.loss_fn(model, cfg, batch, moe_impl="ragged")
    got, _ = lm.loss_fn(dict(model.named_parameters()), cfg, batch,
                        moe_impl="ragged")
    assert torch.equal(got, want)
    skeleton = lm.LM(cfg, device="meta", seed=None)
    assert all(p.is_meta for p in skeleton.parameters())
    with pytest.raises(ValueError, match="remat"):
        lm.loss_fn(model, cfg, batch, remat_policy="some")


# ---------------------------------------------------------------------------
# the embedding's backward: sort + segment reduction
# ---------------------------------------------------------------------------

def _embed_grad(table, ids, g):
    t = table.clone().requires_grad_()
    out = layers.embed(types.SimpleNamespace(table=t), ids)
    (dt,) = torch.autograd.grad(out, [t], g)
    return out, dt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_backward_matches_reference(dtype):
    rng = np.random.default_rng(4)
    vocab, d = 40, 16
    # repeated ids and ids that never occur (the rows past 30)
    ids = rng.integers(0, 30, (3, 11)).astype(np.int32)
    ids[0, :4] = 7
    table = rng.standard_normal((vocab, d)).astype(np.float32)
    g = rng.standard_normal((3, 11, d)).astype(np.float32)
    tdt = getattr(torch, dtype)
    table_t = torch.from_numpy(table).to(tdt)
    g_t = torch.from_numpy(g).to(tdt)
    with kops.fusion_scope() as ran:
        out, dt = _embed_grad(table_t, torch.from_numpy(ids), g_t)
    assert ran["unfused:segment_reduce_sum:ref"] == 1
    assert dt.dtype == tdt and torch.equal(out, table_t[ids])
    assert not bool(dt[30:].any())
    if dtype == "float32":
        _, vjp = jax.vjp(lambda t: jlayers.embed({"table": P(t, (None,
                                                                None))},
                                                jnp.asarray(ids)),
                         jnp.asarray(table))
        (want,) = vjp(jnp.asarray(g))
        np.testing.assert_allclose(dt.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    else:
        # the fp32 cast-then-reduce oracle of the same bf16 cotangent
        g32 = g_t.float().numpy().reshape(-1, d)
        want = jax.ops.segment_sum(jnp.asarray(g32), jnp.asarray(
            ids.reshape(-1)), vocab)
        np.testing.assert_allclose(dt.float().numpy(), np.asarray(want),
                                   rtol=0, atol=2e-2 * float(
                                       np.abs(np.asarray(want)).max()))


# ---------------------------------------------------------------------------
# the MoE layer's backward, and the remat policies
# ---------------------------------------------------------------------------

def test_moe_ragged_backward_with_empty_experts_matches_reference():
    """Experts 5-7 get no token (inputs with a positive mean, their router
    columns all -1): their weight gradients are exactly 0 in both."""
    base = dict(family="moe", num_layers=2, d_model=32, num_heads=4,
                num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=128,
                dtype="float32", max_seq=64, num_experts=8, top_k=2,
                moe_d_ff=16)
    cfg, jcfg = ModelConfig("t", **base), JModelConfig("t", **base)
    jprm = jmoe.moe_init(jax.random.PRNGKey(5), jcfg, jnp.float32)
    router = np.array(jprm["router"].value)
    router[:, 5:] = -1.0
    jprm["router"] = P(jnp.asarray(router), jprm["router"].axes)
    prm = moe.moe_init(None, cfg, torch.float32, "cpu")
    carry(prm, tree_np(jprm), "moe")
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((2, 12, cfg.d_model)) + 3.0).astype(np.float32)
    gy = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)

    def jfn(p, x):
        y, aux = jmoe.moe_ragged(p, x, jcfg, impl="ref")
        return y, aux
    (jy, jaux), vjp = jax.vjp(jfn, jprm, jnp.asarray(x))
    jg_prm, jg_x = vjp((jnp.asarray(gy), jnp.ones((), jnp.float32)))
    names = ["router", "w_up", "w_gate", "w_down"]
    leaves = [getattr(prm, n).detach().clone().requires_grad_()
              for n in names]
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_ragged(types.SimpleNamespace(**dict(zip(names, leaves))),
                            xt, cfg, impl="ref")
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    got = torch.autograd.grad((y, aux), leaves + [xt],
                              (torch.from_numpy(gy), torch.ones(())))
    wants = [np.asarray(jg_prm[n].value) for n in names] + [
        np.asarray(jg_x)]
    for n, g, want in zip(names + ["x"], got, wants):
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=n)
    for n in ("w_up", "w_gate", "w_down"):
        assert not bool(got[names.index(n)][5:].any())


def _mm_in_backward(loss, leaves):
    """(gradients, aten.mm calls the backward ran, recomputation included)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default:
                Count.n += 1
            return func(*args, **(kwargs or {}))
    with Count():
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return grads, Count.n


@pytest.mark.parametrize("arch,impl", [("qwen3-moe-30b-a3b", "capacity"),
                                       ("qwen3-moe-30b-a3b", "ragged"),
                                       ("jamba-v0.1-52b", "ragged"),
                                       ("whisper-tiny", "capacity")])
def test_remat_policies_give_bitwise_equal_gradients(arch, impl):
    cfg = cfglib.get_config(arch).reduced()
    model = lm.LM(cfg, device="cpu", seed=7)
    params = {k: p.detach().clone().requires_grad_()
              for k, p in model.named_parameters()}
    _, batch = batches(cfg, seed=8)
    out = {}
    for policy in ("none", "dots", "full"):
        loss, _ = lm.loss_fn(params, cfg, batch, remat_policy=policy,
                             moe_impl=impl)
        out[policy] = (loss.item(),) + _mm_in_backward(
            loss, list(params.values()))
    for policy in ("dots", "full"):
        assert out[policy][0] == out["none"][0]
        for k, a, b in zip(params, out["none"][1], out[policy][1]):
            assert (a is None and b is None) or torch.equal(a, b), (policy,
                                                                   k)
    # "full" recomputes every block's matmuls in the backward; "dots" keeps
    # them, as "none" does
    assert out["dots"][2] == out["none"][2] < out["full"][2]


def test_remat_replays_kernels_only_under_checkpointing():
    """A recomputed block launches (here: runs the plain version of) its
    ops again, and the accounting counts them: the combine runs once a MoE
    layer in the forward, once more in the backward under "full"."""
    cfg = dataclasses.replace(cfglib.get_config("qwen3-moe-30b-a3b")
                              .reduced(), num_layers=2)
    model = lm.LM(cfg, device="cpu", seed=9)
    params = {k: p.detach().clone().requires_grad_()
              for k, p in model.named_parameters()}
    _, batch = batches(cfg, seed=10)
    seen = {}
    for policy in ("none", "full"):
        with kops.fusion_scope() as ran:
            loss, _ = lm.loss_fn(params, cfg, batch, remat_policy=policy,
                                 moe_impl="ragged")
            torch.autograd.grad(loss, list(params.values()))
        seen[policy] = ran["unfused:gather_segment_reduce_weighted:ref"]
    assert seen == {"none": cfg.num_layers, "full": 2 * cfg.num_layers}


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_backward_is_bitwise_autograds(masked):
    """The loss's hand-written cross-entropy backward (the softmax and the
    gold's subtraction in place, one tensor of the logits' size) gives
    autograd's gradient of ``sum((logsumexp - gold) · mask)`` to the bit,
    and the same sums."""
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.standard_normal((3, 5, 33))
                              .astype(np.float32) * 4)
    labels = torch.from_numpy(rng.integers(0, 33, (3, 5)))
    mask = torch.from_numpy((rng.random((3, 5)) > 0.3).astype(np.float32)) \
        if masked else None
    a = logits.clone().requires_grad_()
    total, count = lm._ce_sums(a, labels, mask)
    (total / count).backward()
    b = logits.clone().requires_grad_()
    m = torch.ones(labels.shape) if mask is None else mask
    logz = torch.logsumexp(b, dim=-1)
    gold = torch.take_along_dim(b, labels[..., None], dim=-1)[..., 0]
    want = torch.sum((logz - gold) * m)
    (want / m.sum()).backward()
    assert torch.equal(total, want) and torch.equal(count, m.sum())
    assert torch.equal(a.grad, b.grad)

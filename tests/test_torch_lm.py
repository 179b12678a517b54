"""The port's LM stack on the CPU against the reference.

Configs: every port config equals the reference's field by field. Layers
(norms, RoPE with partial rotary, the gelu and gated MLPs, blocked
attention, decode attention with per-slot lengths) take the reference's
parameters and numpy inputs and agree within 1e-5 in fp32. The whole
model's forward and three decode steps, with weights carried from
``repro.models.lm.init``, agree within 1e-4·max|logit| for all ten archs
at ``reduced()`` size; in bf16 the port's forward is within 2e-2 of its
fp32 forward on the same (rounded) weights. The carrier rejects bad trees,
and the entry points raise without a card unless given ``device="cpu"``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfglib  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.models.params import P  # noqa: E402

from repro_torch import configs as cfglib  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.models import layers, lm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.params import carry, from_jax_lm_params  # noqa: E402

KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-5, atol=1e-5)


def tree_np(tree):
    """A reference parameter tree with numpy leaves."""
    return jax.tree_util.tree_map(lambda p: np.asarray(p.value), tree,
                                  is_leaf=lambda x: isinstance(x, P))


def carried(port_params, jax_params):
    carry(port_params, tree_np(jax_params), "params")
    return port_params


def tiny(**kw):
    base = dict(family="dense", num_layers=2, d_model=32, num_heads=4,
                num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=128,
                dtype="float32", max_seq=64)
    base.update(kw)
    return ModelConfig("t", **base), JModelConfig("t", **base)


def randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jcfglib.ARCH_NAMES)
def test_config_equals_reference_field_by_field(arch):
    assert cfglib.ARCH_NAMES == jcfglib.ARCH_NAMES
    ours, ref = cfglib.get_config(arch), jcfglib.get_config(arch)
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert dataclasses.asdict(ours.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert (ours.q_dim, ours.kv_dim, ours.padded_vocab) == \
        (ref.q_dim, ref.kv_dim, ref.padded_vocab)
    assert [(ours.is_moe_layer(i), ours.is_attn_layer(i))
            for i in range(ours.num_layers)] == \
        [(ref.is_moe_layer(i), ref.is_attn_layer(i))
         for i in range(ref.num_layers)]
    assert lm.stack_plan(ours) == jlm.stack_plan(ref)
    assert shapes.SHAPE_NAMES == jshapes.SHAPE_NAMES
    for name in shapes.SHAPE_NAMES:
        assert dataclasses.asdict(shapes.SHAPES[name]) == \
            dataclasses.asdict(jshapes.SHAPES[name])
        assert shapes.cell_applicable(ours, name) == \
            jshapes.cell_applicable(ref, name)
    assert cfglib.all_configs()[arch] == ours
    assert cfglib.get_module(arch).CONFIG is ours


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        cfglib.get_config("gpt-5")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norms_match_reference(norm):
    cfg, jcfg = tiny(norm=norm)
    rng = np.random.default_rng(0)
    x = randn(rng, 3, 5, cfg.d_model) * 3 + 1
    prm = {"scale": P(jnp.asarray(randn(rng, cfg.d_model)), ("embed",))}
    if norm == "layernorm":
        prm["bias"] = P(jnp.asarray(randn(rng, cfg.d_model)), ("embed",))
    want = jlayers.apply_norm(prm, jnp.asarray(x), jcfg)
    got = layers.apply_norm(carried(layers.norm_init(cfg, "cpu"), prm),
                            torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    scale = randn(rng, cfg.d_model)
    np.testing.assert_allclose(
        layers.simple_rms(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(jlayers.simple_rms(jnp.asarray(x), jnp.asarray(scale))),
        **TOL)


@pytest.mark.parametrize("partial", [1.0, 0.25])
def test_rope_matches_reference(partial):
    rng = np.random.default_rng(1)
    x = randn(rng, 2, 7, 3, 16)
    pos = rng.integers(0, 500, (2, 7))
    want = jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0, partial)
    got = layers.rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0,
                      partial)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("act,gated,bias", [("gelu", False, True),
                                            ("silu", True, False),
                                            ("relu", True, True)])
def test_mlp_matches_reference(act, gated, bias):
    cfg, jcfg = tiny(act=act, mlp_gated=gated, use_bias=bias)
    jprm = jlayers.mlp_init(KEY, jcfg, jnp.float32)
    if bias:
        rng = np.random.default_rng(2)
        jprm["b_up"] = P(jnp.asarray(randn(rng, cfg.d_ff)), ("mlp",))
        jprm["b_down"] = P(jnp.asarray(randn(rng, cfg.d_model)), ("embed",))
    x = randn(np.random.default_rng(3), 2, 5, cfg.d_model)
    want = jlayers.mlp(jprm, jnp.asarray(x), jcfg)
    prm = carried(layers.mlp_init(None, cfg, torch.float32, "cpu"), jprm)
    got = layers.mlp(prm, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_blocked_attention_matches_reference(causal):
    """Blocks of 4 over 10 positions: three blocks, the last one short;
    grouped KV heads; qk-norm, biases and partial RoPE in the projection."""
    cfg, jcfg = tiny(qk_norm=True, use_bias=True, partial_rotary=0.5)
    jprm = jlayers.attention_init(KEY, jcfg, jnp.float32)
    x = randn(np.random.default_rng(4), 2, 10, cfg.d_model)
    want = jlayers.attention(jprm, jnp.asarray(x), jcfg, causal=causal,
                             block=4)
    prm = carried(layers.attention_init(None, cfg, torch.float32, "cpu"),
                  jprm)
    got = layers.attention(prm, torch.from_numpy(x), cfg, causal=causal,
                           block=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_attention_decode_with_lengths_matches_reference():
    cfg, jcfg = tiny(qk_norm=True)
    jprm = jlayers.attention_init(KEY, jcfg, jnp.float32)
    prm = carried(layers.attention_init(None, cfg, torch.float32, "cpu"),
                  jprm)
    rng = np.random.default_rng(5)
    b, s_max = 3, 12
    k0 = randn(rng, b, s_max, cfg.num_kv_heads, cfg.head_dim)
    v0 = randn(rng, b, s_max, cfg.num_kv_heads, cfg.head_dim)
    lengths = np.asarray([0, 5, 11], np.int32)
    x = randn(rng, b, 1, cfg.d_model)
    want, wc = jlayers.attention_decode(
        jprm, jnp.asarray(x), jcfg,
        jlayers.KVCache(jnp.asarray(k0), jnp.asarray(v0),
                        jnp.zeros((), jnp.int32)), lengths=jnp.asarray(lengths))
    cache = layers.KVCache(torch.from_numpy(k0.copy()),
                           torch.from_numpy(v0.copy()), 0)
    got, gc = layers.attention_decode(prm, torch.from_numpy(x), cfg, cache,
                                      lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gc.k.numpy(), np.asarray(wc.k), **TOL)
    np.testing.assert_allclose(gc.v.numpy(), np.asarray(wc.v), **TOL)
    assert gc.k is cache.k and gc.length == 1      # written in place
    # the shared-length path
    want2, _ = jlayers.attention_decode(
        jprm, jnp.asarray(x), jcfg,
        jlayers.KVCache(jnp.asarray(k0), jnp.asarray(v0),
                        jnp.asarray(4, jnp.int32)))
    got2, _ = layers.attention_decode(
        prm, torch.from_numpy(x), cfg,
        layers.KVCache(torch.from_numpy(k0.copy()),
                       torch.from_numpy(v0.copy()), 4))
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), **TOL)


# ---------------------------------------------------------------------------
# the whole model: forward and decode for every arch
# ---------------------------------------------------------------------------

def _extras(cfg, rng, b):
    """(reference kwargs, port kwargs) of the stubbed frontends."""
    if cfg.family == "vlm":
        pe = randn(rng, b, cfg.num_prefix_embeds, cfg.d_model)
        return ({"prefix_embeds": jnp.asarray(pe)},
                {"prefix_embeds": torch.from_numpy(pe)})
    if cfg.family == "audio":
        ee = randn(rng, b, 6, cfg.d_model)
        return ({"enc_embeds": jnp.asarray(ee)},
                {"enc_embeds": torch.from_numpy(ee)})
    return {}, {}


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("arch", jcfglib.ARCH_NAMES)
def test_forward_and_decode_match_reference(arch):
    jcfg = jcfglib.get_config(arch).reduced()
    cfg = cfglib.get_config(arch).reduced()
    jprm = jlm.init(KEY, jcfg)
    model = from_jax_lm_params(cfg, tree_np(jprm), device="cpu")
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    jkw, kw = _extras(cfg, rng, 2)
    # the reference jitted: the same arithmetic, half the CPU time of its
    # eager scans
    want, want_aux = jax.jit(lambda p, t, kw: jlm.forward(
        p, jcfg, t, remat_policy="none", **kw))(jprm, jnp.asarray(toks), jkw)
    got, aux = model(torch.from_numpy(toks), **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)

    jstate = jlm.init_decode_state(jcfg, 2, 16, jnp.float32)
    state = lm.init_decode_state(cfg, 2, 16, torch.float32, device="cpu")
    jenc = jlm.encode(jprm, jcfg, jkw["enc_embeds"]) if jkw.get(
        "enc_embeds") is not None else None
    enc = model.encode(kw["enc_embeds"]) if jenc is not None else None
    jstep = jax.jit(lambda p, t, st, enc: jlm.decode_step(p, jcfg, t, st,
                                                         enc_out=enc))
    for t in range(3):
        want, jstate = jstep(jprm, jnp.asarray(toks[:, t:t + 1]), jstate, jenc)
        got, state = lm.decode_step(model, torch.from_numpy(toks[:, t:t + 1]),
                                    state, enc_out=enc)
        _close(got, want)
    assert state.length == 3


def test_bf16_forward_within_tolerance_of_fp32():
    """qwen3-moe reduced in bf16 against the fp32 forward of the same
    bf16-rounded weights (the cast-then-reduce oracle)."""
    cfg = dataclasses.replace(cfglib.get_config("qwen3-moe-30b-a3b").reduced(),
                              dtype="bfloat16")
    model16 = lm.LM(cfg, device="cpu", seed=3)
    model32 = lm.LM(cfg, dtype=torch.float32, device="cpu", seed=None)
    model32.load_state_dict({k: v.float()
                             for k, v in model16.state_dict().items()})
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 12)))
    for impl in ("capacity", "ragged"):
        got, _ = model16(toks, moe_impl=impl)
        want, _ = model32(toks, moe_impl=impl)
        _close(got, want, rel=2e-2)


def test_port_forward_matches_its_decode():
    """The port's own consistency check (as the reference's
    test_forward_matches_decode_moe): 7 decode steps give the forward's
    logits, dense and MoE."""
    for cfg in (tiny()[0], tiny(num_experts=4, top_k=2, moe_d_ff=32,
                                capacity_factor=8.0)[0]):
        model = lm.LM(cfg, device="cpu", seed=1)
        toks = torch.from_numpy(np.random.default_rng(8).integers(
            0, cfg.vocab_size, (2, 7)))
        full, _ = model(toks, moe_impl="ragged")
        state = lm.init_decode_state(cfg, 2, 16, torch.float32, device="cpu")
        steps = []
        for t in range(7):
            lg, state = lm.decode_step(model, toks[:, t:t + 1], state,
                                       moe_impl="ragged")
            steps.append(lg[:, 0])
        np.testing.assert_allclose(torch.stack(steps, 1).numpy(),
                                   full.detach().numpy(), rtol=2e-3,
                                   atol=2e-3)


# ---------------------------------------------------------------------------
# the carrier and the devices
# ---------------------------------------------------------------------------

def test_from_jax_lm_params_rejects_bad_trees():
    jcfg = jcfglib.get_config("jamba-v0.1-52b").reduced()
    cfg = cfglib.get_config("jamba-v0.1-52b").reduced()
    tree = tree_np(jlm.init(KEY, jcfg))
    model = from_jax_lm_params(cfg, tree, device="cpu")
    assert len(model.layers) == cfg.num_layers

    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["period"][0]["mixer"]["in_proj"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="stacked layers"):
        from_jax_lm_params(cfg, bad, device="cpu")
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["final_norm"]["scale"] = np.zeros(cfg.d_model + 1, np.float32)
    with pytest.raises(ValueError, match="shape"):
        from_jax_lm_params(cfg, bad, device="cpu")
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    del bad["period"][1]["ffn"]["w_up"]
    with pytest.raises(ValueError, match="keys"):
        from_jax_lm_params(cfg, bad, device="cpu")
    bad = dict(tree, lm_head=tree["embed"]["table"])
    bad.pop("final_norm")
    with pytest.raises(ValueError, match="keys"):
        from_jax_lm_params(cfg, bad, device="cpu")


def test_entry_points_need_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run there")
    cfg = cfglib.get_config("qwen3-8b").reduced()
    tree = tree_np(jlm.init(KEY, jcfglib.get_config("qwen3-8b").reduced()))
    for call in (lambda: lm.LM(cfg),
                 lambda: lm.init_decode_state(cfg, 2, 8),
                 lambda: from_jax_lm_params(cfg, tree)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert lm.LM(cfg, device="cpu").device.type == "cpu"

"""The port's LM serving on the CPU against the reference's.

``SyntheticTokens`` gives the reference's batches bit for bit;
``prefill_into_cache`` the reference's logits (within 1e-4·max|logit|) and
KV caches (1e-5); ``ContinuousBatcher`` the reference's tokens, token for
token, on carried weights (more requests than slots, prompts of several
lengths, MoE layers, a stack whose period count equals the batch size so
that only a structural slot reset is right); ``launch.serve.main`` runs a
reduced config end to end.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfglib  # noqa: E402
from repro.data import tokens as jtokens  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.params import P  # noqa: E402
from repro.serve import lm as jserve_lm  # noqa: E402

from repro_torch import configs as cfglib  # noqa: E402
from repro_torch.data import tokens  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.params import from_jax_lm_params  # noqa: E402
from repro_torch.serve import lm as serve_lm  # noqa: E402

KEY = jax.random.PRNGKey(0)


def carried(arch):
    jcfg = jcfglib.get_config(arch).reduced()
    cfg = cfglib.get_config(arch).reduced()
    jprm = jlm.init(KEY, jcfg)
    tree = jax.tree_util.tree_map(lambda p: np.asarray(p.value), jprm,
                                  is_leaf=lambda x: isinstance(x, P))
    return jcfg, jprm, cfg, from_jax_lm_params(cfg, tree, device="cpu")


@pytest.mark.parametrize("hosts", [1, 2])
def test_synthetic_tokens_bitwise(hosts):
    dcfg = dict(vocab_size=300, seq_len=12, global_batch=4, seed=3)
    for host in range(hosts):
        ours = tokens.SyntheticTokens(tokens.TokenDatasetConfig(**dcfg),
                                      host_id=host, num_hosts=hosts)
        ref = jtokens.SyntheticTokens(jtokens.TokenDatasetConfig(**dcfg),
                                      host_id=host, num_hosts=hosts)
        for step in (0, 1, 7):
            a, b = ours.batch(step), ref.batch(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="split"):
        tokens.SyntheticTokens(tokens.TokenDatasetConfig(**dcfg), num_hosts=3)


def test_prefill_into_cache_matches_reference():
    jcfg, jprm, cfg, model = carried("qwen3-moe-30b-a3b")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (3, 4)).astype(np.int32)
    want, jstate = jserve.prefill_into_cache(
        jprm, jcfg, jnp.asarray(prompts),
        jlm.init_decode_state(jcfg, 3, 10, jnp.float32))
    got, state = serve.prefill_into_cache(
        model, torch.from_numpy(prompts),
        lm.init_decode_state(cfg, 3, 10, torch.float32, device="cpu"))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    assert state.length == int(jstate.length) == 4
    for ours, ref in zip(state.period, jstate.period):
        for a, b in zip(ours, ref):
            assert tuple(a.shape) == b.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "jamba-v0.1-52b"])
def test_continuous_batcher_matches_reference_token_for_token(arch):
    """qwen3-moe reduced: 2 layers in 2 periods, 2 slots (the period and
    batch axes have equal sizes); jamba reduced: Mamba states, MoE every
    other layer."""
    jcfg, jprm, cfg, model = carried(arch)
    rng = np.random.default_rng(1)
    reqs = [(uid, rng.integers(0, cfg.vocab_size, n).astype(np.int32), g)
            for uid, (n, g) in enumerate([(5, 4), (2, 6), (7, 3), (3, 5),
                                          (4, 2)])]
    ref = jserve_lm.ContinuousBatcher(jprm, jcfg, batch_size=2, max_len=16)
    ours = serve_lm.ContinuousBatcher(model, batch_size=2, max_len=16)
    streamed = []
    for uid, prompt, gen in reqs:
        ref.submit(jserve_lm.Request(uid, prompt, gen))
        ours.submit(serve_lm.Request(
            uid, prompt, gen, on_token=lambda u, t: streamed.append((u, t))))
    want = ref.run_until_drained()
    got = ours.run_until_drained()
    assert got == want
    assert all(len(got[uid]) == gen for uid, _, gen in reqs)
    for uid, _, _ in reqs:
        assert [t for u, t in streamed if u == uid] == got[uid]
    assert ours.last_logits.shape == (2, 1, cfg.padded_vocab)


def test_reset_slot_cache_is_structural():
    """A lead layer's cache has the batch on axis 0, a period slot's on
    axis 1: resetting slot 1 zeroes exactly those rows (kimi reduced: one
    lead dense layer, one MoE period)."""
    cfg = cfglib.get_config("kimi-k2-1t-a32b").reduced()
    model = lm.LM(cfg, device="cpu", seed=0)
    b = serve_lm.ContinuousBatcher(model, batch_size=3, max_len=5)
    for caches in (b.state.lead, b.state.period):
        for cache in caches:
            for t in cache:
                t.fill_(1.0)
    b._reset_slot_cache(1)
    k_lead, k_period = b.state.lead[0][0], b.state.period[0][0]
    assert k_lead.shape[0] == 3 and k_period.shape[1] == 3
    assert bool((k_lead[1] == 0).all()) and bool((k_lead[[0, 2]] == 1).all())
    assert bool((k_period[:, 1] == 0).all())
    assert bool((k_period[:, [0, 2]] == 1).all())


def test_launch_serve_main_on_a_reduced_config():
    argv = ["--arch", "qwen3-moe-30b-a3b", "--reduced", "--device", "cpu",
            "--batch", "2", "--prompt-len", "3", "--gen", "2"]
    cfg = serve.reduced_100m(cfglib.get_config("qwen3-moe-30b-a3b"))
    assert (cfg.num_experts, cfg.d_model, cfg.vocab_size) == (8, 512, 32768)
    gen = serve.main(argv)
    assert gen.shape == (2, 2)
    assert ((gen >= 0) & (gen < cfg.vocab_size)).all()
    np.testing.assert_array_equal(serve.main(argv), gen)   # seeded
    hot = serve.main(argv + ["--temperature", "1.0"])
    assert hot.shape == (2, 2)

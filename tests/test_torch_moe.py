"""The port's MoE layer on the CPU against the reference's.

Router, the capacity path (with and without overflow drops) and the
dropless path take the reference's weights and the same numpy inputs. The
port's dropless plain path (``"ragged"``) is held against the reference's
``impl="pallas"``, whose segment_matmul runs the Pallas kernel in interpret
mode. fp32 within 1e-5; bf16 within 2e-2 of the fp32 forward of the same
bf16-rounded inputs. ``impl="cuda"`` raises on CPU tensors and counts no
launch.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfglib  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.models.params import P  # noqa: E402

from repro_torch import configs as cfglib  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.params import carry  # noqa: E402

KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-5, atol=1e-5)


def cfgs(**kw):
    base = dict(family="moe", num_layers=2, d_model=32, num_heads=4,
                num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=128,
                dtype="float32", max_seq=64, num_experts=8, top_k=2,
                moe_d_ff=16, capacity_factor=8.0)
    base.update(kw)
    return ModelConfig("t", **base), JModelConfig("t", **base)


def weights(cfg, jcfg, seed=0):
    jprm = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    prm = moe.moe_init(None, cfg, torch.float32, "cpu")
    carry(prm, jax.tree_util.tree_map(lambda p: np.asarray(p.value), jprm,
                                      is_leaf=lambda x: isinstance(x, P)),
          "moe")
    return jprm, prm


def inputs(cfg, b=2, s=16, seed=1):
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("norm_topk", [False, True])
def test_route_matches_reference(norm_topk):
    cfg, jcfg = cfgs(norm_topk=norm_topk)
    jprm, prm = weights(cfg, jcfg)
    jx, x = inputs(cfg)
    je, jp, jaux = jmoe._route(jprm, jx.reshape(-1, cfg.d_model), jcfg)
    e, p, aux = moe._route(prm, x.reshape(-1, cfg.d_model), cfg)
    assert e.dtype == torch.int32
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
def test_moe_capacity_matches_reference(capacity_factor):
    """Ample capacity, and capacity 32 for 64 tokens · top-2 over 2
    experts: the assignments past an expert's 32 slots are dropped."""
    cfg, jcfg = cfgs(capacity_factor=capacity_factor,
                     num_experts=8 if capacity_factor > 1 else 2)
    jprm, prm = weights(cfg, jcfg)
    jx, x = inputs(cfg, s=16 if capacity_factor > 1 else 32)
    want, waux = jmoe.moe_capacity(jprm, jx, jcfg)
    got, aux = moe.moe_capacity(prm, x, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(waux), **TOL)
    if capacity_factor < 1:       # drops happened: ragged (dropless) differs
        dropless, _ = moe.moe_ragged(prm, x, cfg)
        assert not np.allclose(got.numpy(), dropless.numpy(), atol=1e-3)


def test_moe_ragged_matches_reference_pallas_path():
    cfg, jcfg = cfgs(num_experts=4)
    jprm, prm = weights(cfg, jcfg)
    jx, x = inputs(cfg, b=1)
    want, waux = jmoe.moe_ragged(jprm, jx, jcfg, impl="pallas")
    got, aux = moe.moe(prm, x, cfg, impl="ragged")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(waux), **TOL)
    # with ample capacity the static-shape path is the dropless one
    cap, _ = moe.moe(prm, x, cfg, impl="capacity")
    np.testing.assert_allclose(cap.numpy(), got.numpy(), **TOL)


@pytest.mark.parametrize("impl", ["capacity", "ragged"])
def test_shared_experts_through_kimi_reduced(impl):
    jcfg = jcfglib.get_config("kimi-k2-1t-a32b").reduced()
    cfg = cfglib.get_config("kimi-k2-1t-a32b").reduced()
    assert cfg.num_shared_experts == 1 and cfg.norm_topk
    jprm, prm = weights(cfg, jcfg, seed=2)
    assert "shared" in prm
    jx, x = inputs(cfg, s=8)
    want, _ = jmoe.moe(jprm, jx, jcfg, impl=impl)
    got, _ = moe.moe(prm, x, cfg, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bf16_within_tolerance_of_fp32():
    cfg, _ = cfgs(num_experts=8, top_k=2)
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    prm16 = moe.moe_init(torch.Generator().manual_seed(4), cfg16,
                         torch.bfloat16, "cpu")
    prm32 = moe.moe_init(None, cfg, torch.float32, "cpu")
    prm32.load_state_dict({k: v.float()
                           for k, v in prm16.state_dict().items()})
    x = inputs(cfg, s=24)[1].to(torch.bfloat16)
    for impl in ("capacity", "ragged"):
        got, _ = moe.moe(prm16, x, cfg16, impl=impl)
        want, _ = moe.moe(prm32, x.float(), cfg, impl=impl)
        assert got.dtype == torch.bfloat16
        scale = float(want.abs().max())
        np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                                   rtol=2e-2, atol=2e-2 * scale)


def test_cuda_impl_raises_on_cpu_tensors():
    cfg, jcfg = cfgs()
    _, prm = weights(cfg, jcfg)
    x = inputs(cfg)[1]
    before = kops.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        moe.moe(prm, x, cfg, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        moe.moe_ragged(prm, x, cfg, impl="cuda")
    assert kops.launch_counts() == before
    with pytest.raises(ValueError, match="unknown moe impl"):
        moe.moe(prm, x, cfg, impl="pallas")
    with pytest.raises(ValueError, match="impl must be"):
        moe.moe_ragged(prm, x, cfg, impl="pallas")

"""The port's relation-typed path (RGCN / relational GAT) against the
reference, on the CPU.

Same inputs for both packages, made with numpy from a seed. Integer data
(typed graphs, relation plans, group metadata) must be bitwise equal. The
grouped matmul's plain version is held against the reference's Pallas
kernel in interpret mode: fp32 within 1e-5, bf16 within 2e-2 (the output
is rounded to 8 mantissa bits). ``mp_typed`` is held against the
reference's ``impl="pallas"`` (interpret mode) within 1e-5; the 3-layer
models, with weights carried by ``from_jax_params``, against the
reference's ``impl="ref"`` forward within 1e-4 (``MODEL_TOL`` of
``tests/test_torch_models.py``: the two packages reassociate fp32 sums).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import plan as jplan  # noqa: E402
from repro.core.config_space import KernelConfig as JConfig  # noqa: E402
from repro.core.mp import mp_typed as j_mp_typed  # noqa: E402
from repro.data import graphs as jgraphs  # noqa: E402
from repro.kernels import segment_matmul as jsmm  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402

from repro_torch import hetero_inference  # noqa: E402
from repro_torch.core import mp as tmp  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core.config_space import KernelConfig as TConfig  # noqa: E402
from repro_torch.data import graphs as tgraphs  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import segment_matmul as tsmm  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.models.params import from_jax_params  # noqa: E402

MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
TYPED_FIELDS = ("edge_type", "type_perm", "inv_type_perm", "type_counts",
                "typed_src")


def _tol(dtype):
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=1e-5, atol=1e-5))


# ---------------------------------------------------------------------------
# typed graphs: bitwise identical to the reference for the same seed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("v,e,r,type_alpha,seed", [
    (60, 400, 4, 1.2, 0), (500, 5000, 133, 1.2, 0), (30, 0, 3, 1.2, 1),
    (200, 900, 40, 4.0, 2)])
def test_synth_typed_graph_bitwise(v, e, r, type_alpha, seed):
    tg = tgraphs.synth_typed_graph("t", v, e, num_relations=r, feat=6,
                                   type_alpha=type_alpha, seed=seed)
    jg = jgraphs.synth_typed_graph("t", v, e, num_relations=r, feat=6,
                                   type_alpha=type_alpha, seed=seed)
    assert isinstance(tg, tgraphs.TypedGraph)
    assert tg.num_relations == jg.num_relations == r
    for f in ("edge_index", "x", "labels", "deg_inv_sqrt") + TYPED_FIELDS:
        a, b = getattr(tg, f), getattr(jg, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_typed_graph_validation_matches_reference():
    g = jgraphs.synth_graph("g", 40, 200, feat=4, seed=0)
    base = dict(name="g", edge_index=g.edge_index, num_nodes=g.num_nodes,
                x=g.x, labels=g.labels, deg_inv_sqrt=g.deg_inv_sqrt)
    bad = [dict(edge_type=None), dict(edge_type=np.zeros(7, np.int32)),
           dict(edge_type=np.full(200, 5, np.int32), num_relations=3)]
    for kw in bad:
        with pytest.raises(ValueError) as want:
            jgraphs.TypedGraph(**base, **kw)
        with pytest.raises(ValueError) as got:
            tgraphs.TypedGraph(**base, **kw)
        assert str(got.value) == str(want.value)
    flipped = dict(base, edge_index=g.edge_index[:, ::-1].copy())
    with pytest.raises(ValueError, match="sorted"):
        tgraphs.TypedGraph(**flipped, edge_type=np.zeros(200, np.int32))
    et = np.arange(200, dtype=np.int32) % 3
    tg = tgraphs.TypedGraph(**base, edge_type=et, num_relations=3)
    with pytest.raises(ValueError, match="round-trip"):
        tgraphs.TypedGraph(**base, edge_type=et, num_relations=3,
                           type_perm=tg.type_perm,
                           inv_type_perm=tg.type_perm[::-1].copy(),
                           type_counts=tg.type_counts)


# ---------------------------------------------------------------------------
# relation plans and group metadata: the reference's integers exactly
# ---------------------------------------------------------------------------

SIZES = {
    "zipf": lambda rng: rng.zipf(1.5, 12).clip(max=300),
    "empty_groups": lambda rng: np.array([0, 40, 0, 0, 7, 0, 65, 0, 0, 1]),
    "single": lambda rng: np.array([173]),
    "all_empty": lambda rng: np.zeros(5, np.int64),
}


@pytest.mark.parametrize("kind", list(SIZES))
@pytest.mark.parametrize("m_b", [8, 16, 64])
@pytest.mark.parametrize("pad", [0, 21])
def test_make_relation_plan_matches_reference(kind, m_b, pad):
    sizes = SIZES[kind](np.random.default_rng(m_b)).astype(np.int32)
    m = int(sizes.sum()) + pad
    tp = tplan.make_relation_plan(sizes, num_rows=m,
                                  config=TConfig("SR", 32, 128, m_b, 1),
                                  device="cpu")
    jp = jplan.make_relation_plan(sizes, num_rows=m,
                                  config=JConfig("SR", 32, 128, m_b, 1))
    for f in ("offsets", "first_group", "group_count"):
        t, j = getattr(tp, f), np.asarray(getattr(jp, f))
        assert t.dtype == torch.int32, f
        np.testing.assert_array_equal(t.numpy(), j, err_msg=f)
    assert (tp.num_rows, tp.num_groups, tp.max_groups, tp.worst_case_groups) \
        == (jp.num_rows, jp.num_groups, jp.max_groups, jp.worst_case_groups)
    assert dataclasses.astuple(tp.stats) == dataclasses.astuple(jp.stats)
    # the per-call path computes the same integers where the sizes lie
    for t, j in zip(tsmm.group_metadata(torch.from_numpy(sizes), m, m_b),
                    jsmm.group_metadata(sizes, m, m_b)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_relation_plan_validation_and_misuse():
    sizes = np.array([3, 0, 5], np.int32)
    p = tplan.make_relation_plan(sizes, device="cpu")
    assert p.num_rows == 8 and p.to("cpu") is p
    with pytest.raises(ValueError, match="rebuild the plan"):
        p.validate(9, 3)
    with pytest.raises(ValueError, match="num_rows"):
        tplan.make_relation_plan(sizes, num_rows=4, device="cpu")
    with pytest.raises(ValueError, match="non-negative"):
        tplan.make_relation_plan(np.array([2, -1]), device="cpu")
    with pytest.raises(ValueError, match="non-empty"):
        tplan.make_relation_plan(np.zeros(0, np.int32), device="cpu")
    tg = tgraphs.synth_typed_graph("t", 50, 300, num_relations=6, feat=4)
    rp = tg.make_relation_plan(feat=16, device="cpu")
    assert rp.num_rows == 300 and rp.num_groups == 6
    np.testing.assert_array_equal(np.diff(rp.offsets.numpy()), tg.type_counts)


# ---------------------------------------------------------------------------
# the grouped matmul's plain version against the reference's Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,pad,k,n", [
    ("zipf", 0, 16, 24), ("empty_groups", 13, 32, 8), ("single", 5, 8, 40),
    ("all_empty", 9, 8, 8)])
def test_segment_matmul_plain_matches_pallas(dtype, kind, pad, k, n):
    rng = np.random.default_rng(len(kind) + k)
    sizes = SIZES[kind](rng).astype(np.int32)
    m = int(sizes.sum()) + pad
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((sizes.size, k, n)) / np.sqrt(k)).astype(
        np.float32)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    want = jsmm.segment_matmul_pallas(jnp.asarray(x, jd), jnp.asarray(sizes),
                                      jnp.asarray(w, jd), m_b=16, n_b=128,
                                      interpret=True)
    got = tsmm.segment_matmul_ref(torch.from_numpy(x).to(td),
                                  torch.from_numpy(sizes),
                                  torch.from_numpy(w).to(td))
    assert got.dtype == td and got.shape == (m, n)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dtype))
    if pad:
        assert bool((got[m - pad:] == 0).all()), "rows of no group are 0"


def _tf32_hi(a):
    """``a`` with its low 13 mantissa bits cleared: the kernel's x_hi, and
    TF32 as the tensor core reads an fp32 operand (truncated)."""
    return (a.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _tf32_rna(a):
    """``a`` rounded to TF32's 10 mantissa bits, ties away from zero, as
    ``cvt.rna.tf32.f32`` rounds it."""
    return ((a.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("k", [32, 64])
def test_segment_matmul_3xtf32_split_error(k):
    """The fp32 arithmetic of csrc/segment_matmul.cu, emulated: x = x_hi +
    x_lo, w = w_hi + w_lo (x_lo = x - x_hi, truncated to TF32 as the tensor
    core reads it), out = x_lo·w_hi + x_hi·w_lo + x_hi·w_hi with fp32
    accumulation. Its error is that of a plain fp32 product (within
    1e-6 of an fp64 product, relative to Σ|x·w|), well inside the kernel's
    1e-4 check; one plain TF32 pass is not (about 3 digits)."""
    rng = np.random.default_rng(k)
    sizes = np.array([300, 0, 137, 75], np.int32)
    x = torch.from_numpy(rng.standard_normal((512, k)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((sizes.size, k, 64))
                          / np.sqrt(k)).astype(np.float32))
    split = torch.zeros(512, 64)
    start = 0
    for g, n in enumerate(sizes.tolist()):
        xg, wg = x[start:start + n], w[g]
        xh, wh = _tf32_hi(xg), _tf32_hi(wg)
        xl, wl = _tf32_hi(xg - xh), _tf32_hi(wg - wh)
        split[start:start + n] = xl @ wh + xh @ wl + xh @ wh
        start += n
    ref = tsmm.segment_matmul_ref(x.double(), torch.from_numpy(sizes),
                                  w.double())
    scale = tsmm.segment_matmul_ref(x.double().abs(), torch.from_numpy(sizes),
                                    w.double().abs()).clamp_min(1e-30)
    assert float(((split.double() - ref).abs() / scale).max()) < 1e-6
    single = tsmm.segment_matmul_ref(_tf32_rna(x), torch.from_numpy(sizes),
                                     _tf32_rna(w))
    assert float(((single.double() - ref).abs() / scale).max()) > 1e-4
    want = jsmm.segment_matmul_pallas(jnp.asarray(x.numpy()),
                                      jnp.asarray(sizes),
                                      jnp.asarray(w.numpy()), m_b=16,
                                      n_b=128, interpret=True)
    np.testing.assert_allclose(split.numpy(), np.asarray(want, np.float32),
                               **_tol("float32"))


# ---------------------------------------------------------------------------
# typed message passing and the 3-layer typed models
# ---------------------------------------------------------------------------

def _typed_graph(seed=0):
    return jgraphs.synth_typed_graph("t", 90, 700, num_relations=5, feat=12,
                                     seed=seed)


@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_mp_typed_matches_reference(reduce, weighted):
    g = _typed_graph(seed=1)
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((5, 12, 10)) / 4).astype(np.float32)
    ew = rng.random(g.num_edges).astype(np.float32) if weighted else None
    jp = jplan.make_graph_plan(g.edge_index, g.num_nodes, feat=12)
    jrp = jplan.make_relation_plan(g.type_counts, num_rows=g.num_edges,
                                   feat=10)
    want = j_mp_typed(
        jnp.asarray(g.x), jnp.asarray(w), jnp.asarray(g.edge_index),
        jnp.asarray(g.edge_type), g.num_nodes, reduce=reduce,
        edge_weight=None if ew is None else jnp.asarray(ew), plan=jp,
        rplan=jrp, impl="pallas")
    t = torch.from_numpy
    kw = dict(reduce=reduce, edge_weight=None if ew is None else t(ew))
    derived = tmp.mp_typed(t(g.x), t(w), t(g.edge_index), t(g.edge_type),
                           g.num_nodes, **kw)
    given = tmp.mp_typed(t(g.x), t(w), t(g.edge_index), t(g.edge_type),
                         g.num_nodes, type_perm=t(g.type_perm),
                         inv_type_perm=t(g.inv_type_perm),
                         type_counts=t(g.type_counts), **kw)
    for got in (derived, given):
        assert got.shape == (g.num_nodes, 10)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def _jax_layers(params):
    return [{k: np.asarray(p.value) for k, p in lay.items()} for lay in params]


@pytest.mark.parametrize("family", gnn.TYPED_MODELS)
def test_typed_models_match_reference_with_carried_weights(family):
    heads = 2 if family == "rgat" else 1
    g = _typed_graph(seed=4)
    params = jgnn.init(jax.random.PRNGKey(0), family, 12, 24, 6, heads=heads,
                       num_relations=g.num_relations)
    want = jgnn.forward(
        params, family, jnp.asarray(g.x), jnp.asarray(g.edge_index),
        g.num_nodes, impl="ref", edge_type=jnp.asarray(g.edge_type),
        type_perm=jnp.asarray(g.type_perm),
        inv_type_perm=jnp.asarray(g.inv_type_perm),
        type_counts=jnp.asarray(g.type_counts))
    model = from_jax_params(family, _jax_layers(params))
    assert model.dims == [12, 24, 24, 6]
    layer = model.layers[0]
    assert tuple(layer.w_rel.shape) == (5, 12, 24 * heads)
    tg = tgraphs.synth_typed_graph("t", 90, 700, num_relations=5, feat=12,
                                   seed=4)
    t = torch.from_numpy
    with torch.no_grad(), kops.fusion_scope() as fusion:
        got = gnn.forward(model, t(tg.x), t(tg.edge_index), tg.num_nodes,
                          edge_type=t(tg.edge_type),
                          type_perm=t(tg.type_perm),
                          inv_type_perm=t(tg.inv_type_perm),
                          type_counts=t(tg.type_counts),
                          plan=tg.make_plan(device="cpu"),
                          rplan=tg.make_relation_plan(device="cpu"))
    assert fusion["unfused:segment_matmul:ref"] == 3, "one grouped op a layer"
    assert got.shape == (tg.num_nodes, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_typed_models_need_edge_type_and_a_device():
    model = gnn.init("rgcn", 8, 16, 4, num_relations=3, device="cpu")
    assert model.layers[0].w_rel.shape == (3, 8, 16)
    g = tgraphs.synth_graph("g", 20, 60, feat=8)
    with pytest.raises(ValueError, match="edge_type"):
        model(torch.from_numpy(g.x), torch.from_numpy(g.edge_index), 20)
    assert "rgcn" not in gnn.MODELS and gnn.TYPED_MODELS == ("rgcn", "rgat")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            gnn.init("rgat", 8, 16, 4, heads=2)


def test_hetero_inference_entry_point_on_cpu(capsys):
    out = hetero_inference.main(["--nodes", "120", "--edges", "900",
                                 "--relations", "6", "--hidden", "16",
                                 "--heads", "2", "--device", "cpu"])
    assert set(out) == {"rgcn", "rgat"}
    for logits in out.values():
        assert logits.shape == (120, 16) and bool(torch.isfinite(logits).all())
    printed = capsys.readouterr().out
    assert printed.count("grouped launches 3 for 3 layers") == 2
    assert "grouped vs per-relation loop" in printed

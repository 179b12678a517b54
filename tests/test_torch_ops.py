"""The port's public segment ops (segment_reduce, gather, sddmm, the grouped
matmul) against the reference on the CPU, and the rule that plan metadata
never crosses devices.

Same inputs for both packages, made with numpy from a seed. The plain
versions are held against the reference's Pallas kernels in interpret mode:
fp32 within 1e-5; bf16 within 2e-2 (the output is rounded to 8 mantissa
bits), also against the fp32 plain version of the upcast inputs. The public
ops are held against ``repro.core.ops`` at ``impl="ref"`` in fp32 within
1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import ops as jops  # noqa: E402
from repro.core.config_space import KernelConfig as JConfig  # noqa: E402
from repro.kernels.sddmm import sddmm_pallas  # noqa: E402
from repro.kernels.segment_reduce import segment_reduce_pallas  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.data.graphs import synth_graph, synth_typed_graph  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.sddmm import (check_indices, sddmm_cuda,  # noqa: E402
                                       sddmm_ref)
from repro_torch.kernels.segment_matmul import segment_matmul_cuda  # noqa: E402
from repro_torch.kernels.segment_reduce import (  # noqa: E402
    segment_reduce_cuda, segment_reduce_ref)
from repro_torch.models import gnn  # noqa: E402

DTYPES = ["float32", "bfloat16"]
T_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
J_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
JCFG = JConfig("SR", 16, 128, 32, 1)


def _tol(dtype):
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=1e-5, atol=1e-5))


def _np(a):
    a = np.asarray(a.float() if isinstance(a, torch.Tensor) else
                   jnp.asarray(a, jnp.float32), np.float32)
    return a


def _index(kind: str, rng):
    """(sorted idx, num_segments) with the shapes that stress a window."""
    if kind == "gapped":        # ids multiple of 4: many empty segments
        return np.sort(rng.integers(0, 50, 600) * 4).astype(np.int32), 203
    if kind == "hub":           # one segment holding half the rows
        idx = np.concatenate([rng.integers(0, 60, 300), np.full(300, 17)])
        return np.sort(idx).astype(np.int32), 61
    if kind == "empty":
        return np.zeros(0, np.int32), 9
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# segment_reduce: the plain version against the reference's Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
@pytest.mark.parametrize("kind", ["gapped", "hub", "empty"])
def test_segment_reduce_plain_matches_pallas(dtype, reduce, kind):
    rng = np.random.default_rng(len(kind))
    idx, s = _index(kind, rng)
    x = rng.standard_normal((idx.size, 20)).astype(np.float32)
    want = segment_reduce_pallas(jnp.asarray(x, J_DTYPE[dtype]),
                                 jnp.asarray(idx), s, reduce, config=JCFG,
                                 interpret=True)
    xt = torch.from_numpy(x).to(T_DTYPE[dtype])
    got = segment_reduce_ref(xt, torch.from_numpy(idx), s, reduce)
    assert got.dtype == T_DTYPE[dtype] and got.shape == (s, 20)
    g, w = _np(got), _np(want)
    np.testing.assert_array_equal(np.isneginf(g), np.isneginf(w))
    fin = np.isfinite(w)
    np.testing.assert_allclose(g[fin], w[fin], **_tol(dtype))
    empty = np.setdiff1d(np.arange(s), idx)
    assert np.all(g[empty] == (-np.inf if reduce == "max" else 0.0))
    oracle = _np(segment_reduce_ref(xt.float(), torch.from_numpy(idx), s,
                                    reduce))
    np.testing.assert_allclose(g[fin], oracle[fin], **_tol(dtype))


def test_segment_reduce_plain_drops_rows_past_num_segments():
    idx = torch.tensor([0, 0, 2, 5, 5], dtype=torch.int32)   # 5 = dropped
    x = torch.arange(10, dtype=torch.float32).reshape(5, 2)
    out = segment_reduce_ref(x, idx, 3, "mean")
    torch.testing.assert_close(out, torch.tensor([[1., 2.], [0., 0.],
                                                  [4., 5.]]))


# ---------------------------------------------------------------------------
# sddmm: the plain version against the reference's Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 24, 300])
def test_sddmm_plain_matches_pallas(dtype, n):
    rng = np.random.default_rng(n)
    a = rng.standard_normal((70, n)).astype(np.float32)
    b = rng.standard_normal((45, n)).astype(np.float32)
    row = rng.integers(0, 70, 500).astype(np.int32)    # unsorted, repeated
    col = rng.integers(0, 45, 500).astype(np.int32)
    want = sddmm_pallas(jnp.asarray(a, J_DTYPE[dtype]),
                        jnp.asarray(b, J_DTYPE[dtype]), jnp.asarray(row),
                        jnp.asarray(col), interpret=True)
    at, bt = (torch.from_numpy(v).to(T_DTYPE[dtype]) for v in (a, b))
    got = sddmm_ref(at, bt, torch.from_numpy(row), torch.from_numpy(col))
    assert got.dtype == T_DTYPE[dtype] and got.shape == (500,)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


def test_sddmm_plain_takes_mixed_dtypes():
    """The public op's plain version takes an fp32 A with a bf16 B, as the
    reference's does (its jnp product promotes to fp32); the card path
    wants one dtype."""
    rng = np.random.default_rng(7)
    a = rng.standard_normal((30, 40)).astype(np.float32)
    b = rng.standard_normal((25, 40)).astype(np.float32)
    row = rng.integers(0, 30, 200).astype(np.int32)
    col = rng.integers(0, 25, 200).astype(np.int32)
    want = jops.sddmm(jnp.asarray(a), jnp.asarray(b, jnp.bfloat16),
                      jnp.asarray(row), jnp.asarray(col), "ref")
    got = kops.sddmm(torch.from_numpy(a), torch.from_numpy(b).bfloat16(),
                     torch.from_numpy(row), torch.from_numpy(col), impl="ref")
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_sddmm_checks_every_index_on_the_host():
    i = torch.tensor([0, 3, 1], dtype=torch.int32)
    check_indices(i, i, 4, 4)
    check_indices(torch.zeros(0, dtype=torch.int32),
                  torch.zeros(0, dtype=torch.int32), 0, 0)
    for row, col in (([0, 4, 1], [0, 0, 0]), ([0, 0, 0], [-1, 0, 0]),
                     ([0, 0, 0], [0, 0, 9])):
        with pytest.raises(ValueError, match="sddmm"):
            check_indices(torch.tensor(row), torch.tensor(col), 4, 9)


# ---------------------------------------------------------------------------
# the public ops against repro.core.ops at impl="ref"
# ---------------------------------------------------------------------------

def _public_cases():
    rng = np.random.default_rng(11)
    idx, s = _index("gapped", rng)
    x = rng.standard_normal((idx.size, 16)).astype(np.float32)
    h = rng.standard_normal((40, 16)).astype(np.float32)
    gi = rng.integers(0, 40, 300).astype(np.int32)
    sizes = np.array([0, 50, 0, 130, 7, 0], np.int32)
    xm = rng.standard_normal((200, 12)).astype(np.float32)
    wm = rng.standard_normal((6, 12, 9)).astype(np.float32)
    row = rng.integers(0, 40, 300).astype(np.int32)
    j, t = jnp.asarray, torch.from_numpy
    cases = {
        "gather": (lambda: jops.gather(j(h), j(gi)),
                   lambda: rt.gather(t(h), t(gi))),
        "sddmm": (lambda: jops.sddmm(j(h), j(h), j(row), j(gi), "ref"),
                  lambda: rt.sddmm(t(h), t(h), t(row), t(gi))),
        "grouped_segment_matmul": (
            lambda: jops.grouped_segment_matmul(j(xm), j(sizes), j(wm), "ref"),
            lambda: rt.grouped_segment_matmul(t(xm), t(sizes), t(wm))),
        "segment_matmul": (
            lambda: jops.segment_matmul(j(xm), j(sizes), j(wm), "ref"),
            lambda: rt.segment_matmul(t(xm), t(sizes), t(wm), "ref")),
    }
    for reduce in ("sum", "mean", "max"):
        cases[f"segment_reduce_{reduce}"] = (
            lambda r=reduce: jops.segment_reduce(j(x), j(idx), s, r, "ref"),
            lambda r=reduce: rt.segment_reduce(t(x), t(idx), s, r))
    return cases


@pytest.mark.parametrize("op", list(_public_cases()))
def test_public_ops_match_reference(op):
    want_fn, got_fn = _public_cases()[op]
    want, got = _np(want_fn()), got_fn()
    assert not got.requires_grad
    g = _np(got)
    assert g.shape == want.shape
    np.testing.assert_array_equal(np.isneginf(g), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(g[fin], want[fin], rtol=1e-5, atol=1e-5)


def test_public_ops_are_forward_only_and_accounted():
    x = torch.randn(6, 3, requires_grad=True)
    idx = torch.tensor([0, 0, 1, 1, 1, 2], dtype=torch.int32)
    with kops.fusion_scope() as fusion:
        y = rt.segment_reduce(x, idx, 3, "mean")
        rt.sddmm(x, x, idx, idx)
        rt.segment_matmul(x, torch.tensor([2, 4]), torch.randn(2, 3, 5))
    assert dict(fusion) == {"unfused:segment_reduce_mean:ref": 1,
                            "unfused:sddmm:ref": 1,
                            "unfused:segment_matmul:ref": 1}
    # the backward runs (it used to raise) and accounts its own work: the
    # mean's gradient is a gather by segment, no scatter
    with kops.fusion_scope() as fusion:
        y.sum().backward()
    assert dict(fusion) == {}
    torch.testing.assert_close(x.grad, torch.tensor([0.5, 0.5, 1 / 3, 1 / 3,
                                                     1 / 3, 1.0])[:, None]
                               .expand(6, 3))
    with pytest.raises(ValueError, match="unknown reduce"):
        rt.segment_reduce(x, idx, 3, "min")
    assert {"segment_reduce", "sddmm", "segment_matmul"} <= \
        set(kops.launch_counts())


# ---------------------------------------------------------------------------
# impl="cuda" on CPU tensors raises and launches nothing
# ---------------------------------------------------------------------------

def _cuda_calls():
    x = torch.randn(6, 4)
    idx = torch.tensor([0, 0, 1, 1, 2, 2], dtype=torch.int32)
    sizes = torch.tensor([2, 4], dtype=torch.int32)
    w = torch.randn(2, 4, 3)
    meta = torch.zeros(1, dtype=torch.int32)
    return {
        "segment_reduce": lambda: kops.segment_reduce(x, idx, 3, impl="cuda"),
        "sddmm": lambda: kops.sddmm(x, x, idx, idx, impl="cuda"),
        "segment_matmul": lambda: kops.segment_matmul(x, sizes, w,
                                                      impl="cuda"),
        "public_segment_reduce": lambda: rt.segment_reduce(x, idx, 3, "sum",
                                                           "cuda"),
        "segment_reduce_cuda": lambda: segment_reduce_cuda(
            x, idx, 3, "sum", torch.zeros(4, dtype=torch.int64)),
        "sddmm_cuda": lambda: sddmm_cuda(x, x, idx, idx),
        "segment_matmul_cuda": lambda: segment_matmul_cuda(
            x, w, torch.tensor([0, 2, 6], dtype=torch.int32), meta, meta, 64),
    }


@pytest.mark.parametrize("call", list(_cuda_calls()))
def test_impl_cuda_on_cpu_tensors_raises(call):
    before = kops.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        _cuda_calls()[call]()
    assert kops.launch_counts() == before


# ---------------------------------------------------------------------------
# plans live where the data lives: built there once, never copied per call
# ---------------------------------------------------------------------------

def test_plan_on_another_device_raises():
    g = synth_graph("g", 60, 400, feat=8, seed=2)
    plan = g.make_plan(device="cpu")
    assert plan.row_ptr.device.type == "cpu"
    elsewhere = plan.to("meta")
    assert elsewhere.device.type == "meta" and plan.to("cpu") is plan
    x = torch.randn(60, 8)
    src, dst = (torch.from_numpy(a) for a in g.edge_index)
    want = kops.gather_segment_reduce(x, src, dst, 60, impl="ref")
    got = kops.gather_segment_reduce(x, src, dst, 60, plan=plan,
                                     impl="blocked")
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="lies on meta"):
        kops.gather_segment_reduce(x, src, dst, 60, plan=elsewhere,
                                   impl="blocked")
    rplan = tplan.make_relation_plan([2, 4], device="cpu").to("meta")
    assert rplan.offsets.device.type == "meta"


def test_entry_points_need_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    g = synth_typed_graph("t", 30, 100, num_relations=3, feat=4)
    calls = [lambda: tplan.make_plan(g.edge_index[1], 30),
             lambda: tplan.make_graph_plan(g.edge_index, 30),
             lambda: tplan.make_relation_plan(g.type_counts),
             lambda: g.make_plan(),
             lambda: g.make_relation_plan(),
             lambda: gnn.init("gcn", 4, 8, 2),
             lambda: gnn.make_model_plan(g.edge_index, 30, 8)]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert tplan.make_plan(g.edge_index[1], 30, device="cpu").device == \
        torch.device("cpu")
    assert gnn.init("gcn", 4, 8, 2, device="cpu").layers[0].w.device == \
        torch.device("cpu")


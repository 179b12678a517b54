"""The plain versions of the port's kernels against the reference's Pallas
kernels (interpret mode on the CPU), plus the port's backend rules.

Same inputs for both packages, made with numpy from a seed. Tolerances are
the tiers of ``tests/test_precision.py``: fp32 within 1e-5; bf16 within
2e-2, against the reference's bf16 kernel and against the fp32
cast-then-reduce oracle (the port's plain version on the upcast inputs).
bf16 is not compared with the reference's bf16 ``impl="ref"``, whose mean
counts in bf16.
"""
import functools
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import ops as jops  # noqa: E402
from repro.core.config_space import KernelConfig as JConfig  # noqa: E402

from repro_torch.core import mp as tmp  # noqa: E402
from repro_torch.core.config_space import KernelConfig as TConfig  # noqa: E402
from repro_torch.core.config_space import default_config  # noqa: E402
from repro_torch.core.plan import make_plan  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.fused_transform_reduce import (  # noqa: E402
    fusable, fused_transform_reduce_cuda)
from repro_torch.kernels import gather_segment_reduce as tgsr  # noqa: E402
from repro_torch.kernels import segment_reduce as tsrd  # noqa: E402
from repro_torch.kernels import segment_softmax as tssm  # noqa: E402
from repro_torch.kernels.gather_segment_reduce import (  # noqa: E402
    gather_segment_reduce_cuda)
from repro_torch.kernels.segment_softmax import segment_softmax_cuda  # noqa: E402
from repro.kernels.segment_reduce import segment_reduce_pallas  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
JCFG = JConfig("SR", 64, 128, 64, 1)
DTYPES = ["float32", "bfloat16"]
T_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
J_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _tol(dtype):
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=1e-5, atol=1e-5))


def _graph(v=70, e=340, f=12, seed=0):
    """The ``tests/test_precision.py`` graph: sorted dst, src, x, w."""
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, v, e)).astype(np.int32)
    src = rng.integers(0, v, e).astype(np.int32)
    x = rng.standard_normal((v, f)).astype(np.float32)
    w = rng.standard_normal(e).astype(np.float32)
    return src, dst, x, w, v


def _np(a):
    a = np.asarray(a.float() if isinstance(a, torch.Tensor) else
                   jnp.asarray(a, jnp.float32), np.float32)
    return np.where(np.isneginf(a), 0.0, a)


def _t(a, dtype="float32"):
    t = torch.from_numpy(a)
    return t.to(T_DTYPE[dtype]) if t.is_floating_point() else t


def _j(a, dtype="float32"):
    a = jnp.asarray(a)
    return a.astype(J_DTYPE[dtype]) if a.dtype == jnp.float32 else a


# ---------------------------------------------------------------------------
# plain versions against the reference's Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_gather_segment_reduce_plain_matches_pallas(dtype, reduce, weighted):
    src, dst, x, w, v = _graph(seed=1)
    wj = _j(w, dtype) if weighted else None
    if weighted:
        want = jops.index_weight_segment_reduce(_j(x, dtype), _j(src), wj,
                                                _j(dst), v, reduce, "pallas",
                                                JCFG)
    else:
        want = jops.index_segment_reduce(_j(x, dtype), _j(src), _j(dst), v,
                                         reduce, "pallas", JCFG)
    wt = _t(w, dtype) if weighted else None
    got = kops.gather_segment_reduce(_t(x, dtype), _t(src), _t(dst), v,
                                     weight=wt, reduce=reduce)
    assert got.dtype == T_DTYPE[dtype]
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    if dtype == "bfloat16":     # the fp32 cast-then-reduce oracle
        oracle = kops.gather_segment_reduce(
            _t(x, dtype).float(), _t(src), _t(dst), v,
            weight=None if wt is None else wt.float(), reduce=reduce)
        np.testing.assert_allclose(_np(got), _np(oracle), **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("heads", [None, 4])
def test_segment_softmax_plain_matches_pallas(dtype, heads):
    rng = np.random.default_rng(2)
    m, s = 300, 40
    idx = np.sort(rng.integers(0, s, m)).astype(np.int32)
    shape = (m,) if heads is None else (m, heads)
    e = (rng.standard_normal(shape) * 5.0).astype(np.float32)
    want = jops.segment_softmax(_j(e, dtype), _j(idx), s, "pallas", JCFG)
    got = kops.segment_softmax(_t(e, dtype), _t(idx), s)
    assert got.dtype == T_DTYPE[dtype] and got.shape == shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    oracle = kops.segment_softmax(_t(e, dtype).float(), _t(idx), s)
    np.testing.assert_allclose(_np(got), _np(oracle), **_tol(dtype))


def test_segment_softmax_plain_zeroes_dropped_rows():
    idx = torch.tensor([0, 0, 1, 3, 3], dtype=torch.int32)   # 3 = dropped
    out = kops.segment_softmax(torch.randn(5, 2), idx, 3)
    assert bool((out[3:] == 0).all())
    torch.testing.assert_close(out[:2].sum(0), torch.ones(2))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_fused_transform_reduce_plain_matches_pallas(dtype, reduce, weighted):
    src, dst, x, w, v = _graph(seed=4)
    wm = (np.random.default_rng(5).standard_normal((12, 20)) / 4).astype(
        np.float32)
    want = jops.fused_transform_reduce(
        _j(x, dtype), _j(wm, dtype), _j(src),
        _j(w, dtype) if weighted else None, _j(dst), v, reduce, "pallas", JCFG)
    wt = _t(w, dtype) if weighted else None
    got = kops.fused_transform_reduce(_t(x, dtype), _t(wm, dtype), _t(src),
                                      _t(dst), v, weight=wt, reduce=reduce)
    assert got.dtype == T_DTYPE[dtype] and got.shape == (v, 20)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


# ---------------------------------------------------------------------------
# the blocked schedule: the CPU evidence that the kernel reads the plan
# metadata right (runs of rows that start inside segments, segments cut by
# run ends, a hub over several runs, empty segments, padding)
# ---------------------------------------------------------------------------

def _windowed_graph():
    """num_segments % s_b != 0, 13 padding rows (dst = num_segments), and
    no destination in [32, 64): block 1 of s_b = 32 owns nothing."""
    rng = np.random.default_rng(9)
    v = 150
    dst = rng.integers(0, v, 900)
    dst = np.sort(np.where((dst >= 32) & (dst < 64), dst + 40, dst))
    dst = np.concatenate([dst, np.full(13, v)]).astype(np.int32)
    src = rng.integers(0, v, dst.size).astype(np.int32)
    x = rng.standard_normal((v, 9)).astype(np.float32)
    w = rng.standard_normal(dst.size).astype(np.float32)
    return src, dst, x, w, v


def _hub_graph():
    """A hub of 300 rows into segment 40, alone in the empty stretch
    [20, 60], between short segments, plus 6 padding rows."""
    rng = np.random.default_rng(12)
    v = 90
    dst = rng.integers(0, v, 400)
    dst = np.sort(np.concatenate([dst[(dst < 20) | (dst > 60)],
                                  np.full(300, 40)]))
    dst = np.concatenate([dst, np.full(6, v)]).astype(np.int32)
    src = rng.integers(0, v, dst.size).astype(np.int32)
    x = rng.standard_normal((v, 9)).astype(np.float32)
    w = rng.standard_normal(dst.size).astype(np.float32)
    return src, dst, x, w, v


_GRAPHS = {"windowed": _windowed_graph, "hub": _hub_graph}


@functools.lru_cache(maxsize=None)
def _pallas_gather(graph, reduce, weighted):
    """The reference's gather kernel (interpret mode) on the same inputs."""
    src, dst, x, w, v = _GRAPHS[graph]()
    if weighted:
        out = jops.index_weight_segment_reduce(_j(x), _j(src), _j(w), _j(dst),
                                               v, reduce, "pallas", JCFG)
    else:
        out = jops.index_segment_reduce(_j(x), _j(src), _j(dst), v, reduce,
                                        "pallas", JCFG)
    return _np(out)


@pytest.mark.parametrize("graph", list(_GRAPHS))
@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("tiling", [(32, 64), (32, 7), (64, 1000)])
def test_blocked_schedule_matches_plain(graph, reduce, weighted, tiling):
    """Through the wrapper the schedule runs the kernel's runs of
    RUN_ROWS; called directly it also runs runs of the tiling's m_b rows,
    which cut more segments at this small size."""
    src, dst, x, w, v = _GRAPHS[graph]()
    cfg = TConfig("SR", tiling[0], 128, tiling[1], 1)
    run = cfg.m_b
    plan = make_plan(dst, v, config=cfg, device="cpu")
    rp = plan.row_ptr.numpy()
    assert plan.row_ptr.dtype == torch.int64
    np.testing.assert_array_equal(
        rp, np.searchsorted(dst, np.arange(v + 1), side="left"))
    if graph == "windowed" and cfg.s_b == 32:
        assert int(plan.chunk_count[1]) == 0, "block 1 must own no rows"
    if graph == "hub":      # the hub is cut by a run end, or spans several
        assert rp[41] // tgsr.RUN_ROWS > rp[40] // tgsr.RUN_ROWS
        if run < 300:
            assert rp[41] // run - rp[40] // run >= 2
    wt = _t(w) if weighted else None
    want = kops.gather_segment_reduce(_t(x), _t(src), _t(dst), v, weight=wt,
                                      reduce=reduce, impl="ref")
    # the hub's 300 rows are summed in partials of a run, folded in run
    # order, so its sum differs from index_add_'s order by fp32 rounding:
    # held to the fp32 tier of tests/test_precision.py there
    tol = 1e-6 if graph == "windowed" else 1e-5
    for p in (plan, None):      # plan metadata, or derived per call
        got = kops.gather_segment_reduce(_t(x), _t(src), _t(dst), v,
                                         weight=wt, reduce=reduce, config=cfg,
                                         plan=p, impl="blocked")
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    got_run = tgsr.gather_segment_reduce_blocked(
        _t(x), _t(src), _t(dst), v, wt, reduce, plan.row_ptr, run)
    torch.testing.assert_close(got_run, want, rtol=tol, atol=tol)
    for out in (got, got_run):
        np.testing.assert_allclose(_np(out), _pallas_gather(graph, reduce,
                                                            weighted),
                                   **_tol("float32"))
    if reduce == "max":
        empty = (rp[1:] == rp[:-1])
        assert empty.any() and bool(torch.isneginf(got[empty]).all())


def test_run_length_matches_kernel_source():
    """The wrapper sizes the kernel's scratch and the blocked schedule cuts
    its runs with RUN_ROWS: it must be the kernel's own constant."""
    src = (ROOT / "src/repro_torch/kernels/csrc/gather_segment_reduce.cu"
           ).read_text()
    assert re.findall(r"constexpr int RUN = (\d+);", src) == [
        str(tgsr.RUN_ROWS)]


# the two kernels that share the row-run schedule: segment_reduce (the
# gather's runs with an identity gather) and segment_softmax (runs of
# (max, sum-exp) pairs); the short run lengths cut more segments at this
# small size
SHORT_RUN = 7


def _segment_rows(graph):
    """The graph's sorted destinations, padding rows included, with the
    row offsets of its plan."""
    _, dst, _, _, v = _GRAPHS[graph]()
    plan = make_plan(dst, v, device="cpu")
    return dst, v, plan


@functools.lru_cache(maxsize=None)
def _pallas_segment_reduce(graph, reduce):
    dst, v, _ = _segment_rows(graph)
    x = np.random.default_rng(21).standard_normal((dst.size, 9)).astype(
        np.float32)
    return x, _np(segment_reduce_pallas(jnp.asarray(x), jnp.asarray(dst), v,
                                        reduce, config=JCFG, interpret=True))


@pytest.mark.parametrize("graph", list(_GRAPHS))
@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
@pytest.mark.parametrize("run", [tsrd.RUN_ROWS, SHORT_RUN])
def test_blocked_segment_reduce_matches_plain_and_pallas(graph, reduce, run):
    dst, v, plan = _segment_rows(graph)
    rp = plan.row_ptr.numpy()
    if graph == "hub":      # the hub spans several runs
        assert rp[41] // run - rp[40] // run >= 2
    x, want_pallas = _pallas_segment_reduce(graph, reduce)
    xt, it = _t(x), _t(dst)
    want = kops.segment_reduce(xt, it, v, reduce, impl="ref")
    if run == tsrd.RUN_ROWS:    # through the wrapper, with the plan and without
        gots = [kops.segment_reduce(xt, it, v, reduce, plan=p, impl="blocked")
                for p in (plan, None)]
    else:
        gots = [tsrd.segment_reduce_blocked(xt, it, v, reduce, plan.row_ptr,
                                            run)]
    for got in gots:
        assert got.dtype == torch.float32 and got.shape == (v, 9)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(got), want_pallas, **_tol("float32"))
    if reduce == "max":
        empty = rp[1:] == rp[:-1]
        assert empty.any() and bool(torch.isneginf(gots[0][empty]).all())


@functools.lru_cache(maxsize=None)
def _pallas_softmax(graph, heads):
    dst, v, _ = _segment_rows(graph)
    shape = (dst.size,) if heads is None else (dst.size, heads)
    x = (np.random.default_rng(22).standard_normal(shape) * 5).astype(
        np.float32)
    return x, _np(jops.segment_softmax(_j(x), _j(dst), v, "pallas", JCFG))


@pytest.mark.parametrize("graph", list(_GRAPHS))
@pytest.mark.parametrize("heads", [None, 1, 2, 4])
@pytest.mark.parametrize("run", [tssm.RUN_ROWS, SHORT_RUN])
def test_blocked_segment_softmax_matches_plain_and_pallas(graph, heads, run):
    dst, v, plan = _segment_rows(graph)
    x, want_pallas = _pallas_softmax(graph, heads)
    xt, it = _t(x), _t(dst)
    want = kops.segment_softmax(xt, it, v, impl="ref")
    if run == tssm.RUN_ROWS:
        gots = [kops.segment_softmax(xt, it, v, plan=p, impl="blocked")
                for p in (plan, None)]
    else:
        gots = [tssm.segment_softmax_blocked(xt, it, v, plan.row_ptr, run)]
    dropped = dst >= v
    assert dropped.sum() > 0
    for got in gots:
        assert got.dtype == torch.float32 and got.shape == x.shape
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_np(got), want_pallas, **_tol("float32"))
        assert bool((got[torch.from_numpy(dropped)] == 0).all())


@pytest.mark.parametrize("run", [tssm.RUN_ROWS, SHORT_RUN])
def test_blocked_segment_softmax_all_neg_inf_segment_is_zero(run):
    """A segment whose logits are all -inf comes out 0, the plain version's
    and the JAX impl="ref" rule (a max that is not finite counts as 0), also
    where the segment spans several runs beside finite ones."""
    dst, v, plan = _segment_rows("hub")
    x = torch.from_numpy(np.random.default_rng(23).standard_normal(
        (dst.size, 2)).astype(np.float32))
    it = _t(dst)
    x[it == 40] = float("-inf")                 # the hub
    x[it == int(dst[0])] = float("-inf")        # a short one
    got = tssm.segment_softmax_blocked(x, it, v, plan.row_ptr, run)
    assert bool((got[it == 40] == 0).all()) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, kops.segment_softmax(x, it, v, impl="ref"),
                               rtol=1e-5, atol=1e-6)
    real = int((dst < v).sum())             # the padding rows are last
    want_jax = jops.segment_softmax(_j(x.numpy()[:real]), _j(dst[:real]), v,
                                    "ref")
    np.testing.assert_allclose(_np(got)[:real], _np(want_jax),
                               **_tol("float32"))


@pytest.mark.parametrize("kernel, module", [("segment_reduce", tsrd),
                                            ("segment_softmax", tssm)])
def test_row_run_length_matches_kernel_source(kernel, module):
    """Each row-run kernel's wrapper sizes its scratch and the blocked
    mirror cuts its runs with the module's RUN_ROWS: it must be the kernel's
    own constant."""
    import inspect
    src = (ROOT / f"src/repro_torch/kernels/csrc/{kernel}.cu").read_text()
    assert re.findall(r"constexpr int RUN = (\d+);", src) == [
        str(module.RUN_ROWS)]
    blocked = getattr(module, f"{kernel}_blocked")
    assert inspect.signature(blocked).parameters["run_rows"].default == \
        module.RUN_ROWS


# ---------------------------------------------------------------------------
# backend rules, the Hopper gate, and the package boundary
# ---------------------------------------------------------------------------

def test_fusable_rejects_over_budget():
    cfg = default_config(64)
    assert fusable(32, 64, torch.float32, cfg)
    assert fusable(64, 64, torch.bfloat16, cfg)
    assert not fusable(4096, 4096, torch.float32, cfg)
    assert not fusable(64, 64, torch.float32, TConfig("SR", 2048, 128, 64, 1))
    # the order rule: fused only with the kernel and a fitting footprint
    assert tmp.choose_order(32, 64, allow_fused=True) == "fused"
    assert tmp.choose_order(4096, 8192, allow_fused=True) == "aggregate_first"
    assert tmp.choose_order(32, 64) == "aggregate_first"
    assert tmp.choose_order(64, 16) == "transform_first"
    assert tmp.resolve_order("max", "auto", 32, 64,
                             allow_fused=True) == "transform_first"
    with pytest.raises(ValueError, match="CUDA"):
        tmp.resolve_order("sum", "fused", 32, 64)


def _cuda_calls():
    src, dst, x, w, v = _graph()
    h, s, d = _t(x), _t(src), _t(dst)
    wm = torch.ones(12, 4)
    return {
        "gather_segment_reduce":
            lambda: kops.gather_segment_reduce(h, s, d, v, impl="cuda"),
        "segment_softmax":
            lambda: kops.segment_softmax(_t(w), d, v, impl="cuda"),
        "fused_transform_reduce":
            lambda: kops.fused_transform_reduce(h, wm, s, d, v, impl="cuda"),
        "mp_transform":
            lambda: tmp.mp_transform(h, wm, torch.stack([s, d]), v,
                                     impl="cuda"),
        "gather_segment_reduce_cuda":
            lambda: gather_segment_reduce_cuda(h, s, d, v, None, "sum", d),
        "segment_softmax_cuda":
            lambda: segment_softmax_cuda(_t(w), d, v,
                                         torch.zeros(v + 1, dtype=torch.int64)),
        "fused_transform_reduce_cuda":
            lambda: fused_transform_reduce_cuda(h, wm, s, d, v, None, "sum",
                                                d, d, default_config(12)),
    }


@pytest.mark.parametrize("call", list(_cuda_calls()))
def test_impl_cuda_on_cpu_tensors_raises(call):
    before = kops.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        _cuda_calls()[call]()
    assert kops.launch_counts() == before


def test_blocked_is_not_offered_by_the_fused_kernel():
    """The fused kernel still walks ownership windows: it has no row-run
    schedule to mirror."""
    src, dst, x, w, v = _graph()
    with pytest.raises(ValueError, match="unknown impl 'blocked'"):
        kops.fused_transform_reduce(_t(x), torch.ones(12, 4), _t(src),
                                    _t(dst), v, impl="blocked")


def test_cpu_default_is_plain_and_counts_no_launch():
    src, dst, x, w, v = _graph()
    before = kops.launch_counts()
    with kops.fusion_scope() as fusion:
        kops.gather_segment_reduce(_t(x), _t(src), _t(dst), v)
    assert dict(fusion) == {"unfused:gather_segment_reduce:ref": 1}
    assert kops.launch_counts() == before
    with pytest.raises(ValueError, match="unknown impl"):
        kops.gather_segment_reduce(_t(x), _t(src), _t(dst), v, impl="pallas")


def test_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import repro_torch, repro_torch.serve, repro_torch.models.params, "
            "repro_torch.kernels.ops, repro_torch.hetero_inference; "
            "assert not any(m == 'repro' or m.startswith(('repro.', 'jax')) "
            "for m in sys.modules if sys.modules[m] is not None); print('ok')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


_FORBIDDEN = re.compile(r"^\s*(?:from|import)\s+(?:jax|repro)(?:[.\s,]|$)",
                        re.MULTILINE)


def test_source_scan_no_jax_or_reference_imports():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        hits = _FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)} imports {hits}"

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
from repro_torch.core.config_space import (  # noqa: E402
    DEFAULT_M_B, DEFAULT_S_B, RUN_LENGTHS, TILE_SIZES, default_config)
from repro_torch.core.plan import make_plan  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import fused_transform_reduce as tftr  # noqa: E402
from repro_torch.kernels.fused_transform_reduce import (  # noqa: E402
    fusable, fused_transform_reduce_cuda)
from repro_torch.kernels import gather_segment_reduce as tgsr  # noqa: E402
from repro_torch.kernels import sddmm as tsdd  # noqa: E402
from repro_torch.kernels import segment_reduce as tsrd  # noqa: E402
from repro_torch.kernels import segment_softmax as tssm  # noqa: E402
from repro_torch.kernels.gather_segment_reduce import (  # noqa: E402
    gather_segment_reduce_cuda)
from repro_torch.kernels import segment_matmul as tsmm  # noqa: E402
from repro_torch.kernels.segment_softmax import segment_softmax_cuda  # noqa: E402
from repro.kernels.segment_matmul import segment_matmul_pallas  # noqa: E402
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
    src, dst, x, w, v = _OWNER_GRAPHS[graph]()
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
    """Through the wrapper the schedule runs runs of the config's m_b rows
    (the tiling's: short ones cut more segments at this small size), as
    it does called directly."""
    src, dst, x, w, v = _GRAPHS[graph]()
    cfg = TConfig("SR", tiling[0], 128, tiling[1], 1)
    run = cfg.m_b
    plan = make_plan(dst, v, config=cfg, device="cpu")
    rp = plan.row_ptr.numpy()
    assert plan.row_ptr.dtype == torch.int64
    np.testing.assert_array_equal(
        rp, np.searchsorted(dst, np.arange(v + 1), side="left"))
    if graph == "windowed" and cfg.s_b == 32:
        assert rp[64] == rp[32], "segments 32..63 must own no rows"
    if graph == "hub":      # the hub is cut by a run end, or spans several
        assert rp[41] // DEFAULT_M_B > rp[40] // DEFAULT_M_B
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
    """The run lengths the config space offers (M_b) are the instances the
    row-run kernels build, and the gather's launch dispatches on them."""
    import inspect
    hdr = (ROOT / "src/repro_torch/kernels/csrc/row_runs.cuh").read_text()
    (line,) = re.findall(r"#define FOR_RUN_LENGTHS\(X\) (.*)", hdr)
    assert tuple(int(v) for v in re.findall(r"X\((\d+)\)", line)) == \
        RUN_LENGTHS
    src = (ROOT / "src/repro_torch/kernels/csrc/gather_segment_reduce.cu"
           ).read_text()
    assert "FOR_RUN_LENGTHS(GSR_RUN)" in src
    assert "constexpr int RUN" not in src
    blocked = tgsr.gather_segment_reduce_blocked
    assert inspect.signature(blocked).parameters["run_rows"].default == \
        DEFAULT_M_B


# the two kernels that share the row-run schedule: segment_reduce (the
# gather's runs with an identity gather) and segment_softmax (runs of
# (max, sum-exp) pairs); the short run lengths cut more segments at this
# small size
SHORT_RUN = 7


def _segment_rows(graph):
    """The graph's sorted destinations, padding rows included, with the
    row offsets of its plan."""
    _, dst, _, _, v = _GRAPHS[graph]()
    plan = make_plan(dst, v, config=default_config(9), device="cpu")
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
@pytest.mark.parametrize("run", [DEFAULT_M_B, SHORT_RUN])
def test_blocked_segment_reduce_matches_plain_and_pallas(graph, reduce, run):
    dst, v, plan = _segment_rows(graph)
    rp = plan.row_ptr.numpy()
    if graph == "hub":      # the hub spans several runs
        assert rp[41] // run - rp[40] // run >= 2
    x, want_pallas = _pallas_segment_reduce(graph, reduce)
    xt, it = _t(x), _t(dst)
    want = kops.segment_reduce(xt, it, v, reduce, impl="ref")
    if run == DEFAULT_M_B:    # through the wrapper, with the plan and without
        gots = [kops.segment_reduce(xt, it, v, reduce, plan=p,
                                    config=default_config(9), impl="blocked")
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


# the fused kernel's tiles: TILE segments over the plan's row offsets, one
# run of rows per lane group, cut segments folded in run order


def _gapped_graph():
    """S % 64 != 0, no destination in [40, 200): with tiles of 64 the tile
    [64, 128) has no rows (so do tiles of 16 in the stretch), a hub of 120
    rows into segment 230, and 9 padding rows."""
    rng = np.random.default_rng(31)
    v = 300
    dst = rng.integers(0, v, 700)
    dst = np.sort(np.concatenate([dst[(dst < 40) | (dst >= 200)],
                                  np.full(120, 230)]))
    dst = np.concatenate([dst, np.full(9, v)]).astype(np.int32)
    src = rng.integers(0, v, dst.size).astype(np.int32)
    x = rng.standard_normal((v, 9)).astype(np.float32)
    w = rng.standard_normal(dst.size).astype(np.float32)
    return src, dst, x, w, v


_FUSED_GRAPHS = dict(_GRAPHS, gapped=_gapped_graph)
_FUSED_D_OUT = 20
SHORT_TILE = 16


def _fused_inputs(graph):
    src, dst, x, w, v = _FUSED_GRAPHS[graph]()
    wm = (np.random.default_rng(32).standard_normal((x.shape[1], _FUSED_D_OUT))
          / 3).astype(np.float32)
    return src, dst, x, w, v, wm


@functools.lru_cache(maxsize=None)
def _pallas_fused(graph, reduce, weighted, dtype):
    """The reference's fused Pallas kernel (interpret mode) on the same
    inputs."""
    src, dst, x, w, v, wm = _fused_inputs(graph)
    return _np(jops.fused_transform_reduce(
        _j(x, dtype), _j(wm, dtype), _j(src), _j(w, dtype) if weighted else None,
        _j(dst), v, reduce, "pallas", JCFG))


@pytest.mark.parametrize("graph", list(_FUSED_GRAPHS))
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("tile", [DEFAULT_S_B, SHORT_TILE])
@pytest.mark.parametrize("dtype", DTYPES)
def test_blocked_fused_transform_reduce_matches_plain_and_pallas(
        graph, reduce, weighted, tile, dtype):
    """The kernel's tile schedule against the plain version and the
    reference's Pallas kernel: fp32 within rtol 1e-5, atol 1e-5·max|plain|;
    bf16 within 2e-2 the same way, also against the fp32 cast-then-reduce
    oracle. The atol scales with the output because the schedule sums a
    segment in runs folded in run order, another order than index_add_'s:
    at the 120- and 300-row hubs the sums reach ~20 and their fp32 rounding
    ~2e-5, which the product with W carries into the output."""
    src, dst, x, w, v, wm = _fused_inputs(graph)
    plan = make_plan(dst, v, config=default_config(x.shape[1]), device="cpu")
    rp = plan.row_ptr.numpy()
    tiles = [(lo, min(lo + tile, v)) for lo in range(0, v, tile)]
    if graph == "gapped":       # S % T != 0 and a tile with no rows
        assert v % tile != 0
        assert any(rp[lo] == rp[hi] for lo, hi in tiles)
    if graph == "hub":          # the hub is cut by several runs of its tile
        lo = 40 // tile * tile
        runs = tftr.THREADS // tftr.lanes_per_row(x.shape[1],
                                                  T_DTYPE[dtype])
        chunk = -(-(rp[min(lo + tile, v)] - rp[lo]) // runs)
        assert (rp[41] - 1 - rp[lo]) // chunk - (rp[40] - rp[lo]) // chunk >= 2
    xt, wmt = _t(x, dtype), _t(wm, dtype)
    wt = _t(w, dtype) if weighted else None
    want = kops.fused_transform_reduce(xt, wmt, _t(src), _t(dst), v, wt,
                                       reduce, impl="ref")
    if tile == DEFAULT_S_B:      # the wrapper, with the plan and without
        gots = [kops.fused_transform_reduce(xt, wmt, _t(src), _t(dst), v, wt,
                                            reduce, plan=p,
                                            config=plan.config,
                                            impl="blocked")
                for p in (plan, None)]
    else:
        gots = [tftr.fused_transform_reduce_blocked(
            xt, wmt, _t(src), _t(dst), v, wt, reduce, plan.row_ptr, tile)]
    oracle = kops.fused_transform_reduce(
        xt.float(), wmt.float(), _t(src), _t(dst), v,
        None if wt is None else wt.float(), reduce, impl="ref")
    rtol = _tol(dtype)["rtol"]
    tol = dict(rtol=rtol, atol=rtol * max(1.0, float(want.float().abs().max())))
    for got in gots:
        assert got.dtype == T_DTYPE[dtype] and got.shape == (v, _FUSED_D_OUT)
        assert bool(torch.isfinite(got).all()), "an element was never written"
        np.testing.assert_allclose(_np(got), _np(want), **tol)
        np.testing.assert_allclose(
            _np(got), _pallas_fused(graph, reduce, weighted, dtype), **tol)
        if dtype == "bfloat16":
            np.testing.assert_allclose(_np(got), _np(oracle), **tol)
    empty = rp[1:] == rp[:-1]
    assert empty.any() and bool((gots[0][torch.from_numpy(empty)] == 0).all())


def test_blocked_fused_transform_reduce_empty_graph():
    none = torch.zeros(0, dtype=torch.int32)
    got = kops.fused_transform_reduce(torch.randn(70, 12), torch.randn(12, 5),
                                      none, none, 70, impl="blocked")
    assert got.shape == (70, 5) and bool((got == 0).all())


def test_fused_tile_matches_kernel_source():
    """The wrapper's tiles (the S_b the config space offers, the kernel's
    built instances), block and pass widths, and with them the shared
    memory that fusable checks, must be the kernel's own."""
    import inspect
    src = (ROOT / "src/repro_torch/kernels/csrc/fused_transform_reduce.cu"
           ).read_text()
    for name, value in (("THREADS", tftr.THREADS), ("BN", tftr.BN)):
        assert re.findall(rf"constexpr int {name} = (\d+);", src) == [
            str(value)], name
    (line,) = re.findall(r"#define FOR_TILES\(X\) (.*)", src)
    assert tuple(int(v) for v in re.findall(r"X\((\d+)\)", line)) == \
        TILE_SIZES == tftr.TILE_SIZES
    blocked = tftr.fused_transform_reduce_blocked
    assert inspect.signature(blocked).parameters["tile"].default == \
        DEFAULT_S_B
    # the footprints the kernel's header note quotes
    assert tftr.smem_bytes(32, 64, torch.float32) == 37_904
    assert tftr.smem_bytes(32, 64, torch.bfloat16) == 35_856
    assert "37,904 B" in src and "35,856 B" in src


@pytest.mark.parametrize("kernel, module", [("segment_reduce", tsrd),
                                            ("segment_softmax", tssm)])
def test_row_run_length_matches_kernel_source(kernel, module):
    """Each row-run kernel's wrapper sizes its scratch and the blocked
    mirror cuts its runs by the kernel's own run length: the softmax's
    constant RUN_ROWS; segment_reduce's run-time M_b, whose launch
    dispatches on the built lengths."""
    import inspect
    src = (ROOT / f"src/repro_torch/kernels/csrc/{kernel}.cu").read_text()
    blocked = getattr(module, f"{kernel}_blocked")
    default = inspect.signature(blocked).parameters["run_rows"].default
    if kernel == "segment_reduce":
        assert "FOR_RUN_LENGTHS(SRD_RUN)" in src
        assert "constexpr int RUN" not in src and default == DEFAULT_M_B
        return
    assert re.findall(r"constexpr int RUN = (\d+);", src) == [
        str(module.RUN_ROWS)]
    assert default == module.RUN_ROWS


@pytest.mark.parametrize("kernel", ["gather_segment_reduce", "segment_reduce",
                                    "segment_softmax", "segment_matmul",
                                    "fused_transform_reduce", "sddmm"])
def test_sweep_lines_match_kernel_source(kernel):
    """Every source line the sweep module rewrites stands once in the
    kernel's source, at one of the values it sweeps; a variant is named
    CONST=value. segment_reduce has no line left to rewrite: its run
    length is a run-time axis of the config, as the gather's is; the
    gather's lines are its owner path's, whose variants build no run
    length."""
    from repro_torch import kernel_variants as kv
    src = (ROOT / f"src/repro_torch/kernels/csrc/{kernel}.cu").read_text()
    if kernel == "segment_reduce":
        assert kernel not in kv.VARIANTS and "FOR_RUN_LENGTHS" in src
        return
    if kernel == "gather_segment_reduce":
        assert "FOR_RUN_LENGTHS" in src
        assert kv.PREAMBLE[kernel] == "#define FOR_RUN_LENGTHS(X)\n"
    keys = []
    for line, values in kv.VARIANTS[kernel]:
        assert sum(src.count(line.format(v)) for v in values) == 1, line
        keys += [f"{line.split()[2]}={v}" for v in values]
    assert kv.variant_keys(kernel) == keys
    assert (ROOT / "src/repro_torch/kernels/csrc/probes/row_reads.cu"
            ).is_file()


# ---------------------------------------------------------------------------
# the gather's and sddmm's two paths: their shape rules, and the owner
# schedule against the reference's gather
# ---------------------------------------------------------------------------

# (rows, the path): the MoE combine at a decode step of 8 tokens (64 rows,
# chip_smoke.py 3h) and of the batcher's 4 slots (32), the crossing, the
# combine at 4096 tokens (3h) and at a training step's 2048 (3i, 16,384
# rows), ogbn-arxiv's real and bucketed edges
_GSR_PATHS = {"empty": (0, "owner"), "decode_batcher": (32, "owner"),
              "decode_3h": (64, "owner"),
              "at_threshold": (tgsr.OWNER_MAX_ROWS, "owner"),
              "past_threshold": (tgsr.OWNER_MAX_ROWS + 1, "runs"),
              "train_3i": (16_384, "runs"), "prefill_3h": (32_768, "runs"),
              "arxiv": (1_166_243, "runs"), "arxiv_bucket": (2_097_152, "runs")}


@pytest.mark.parametrize("case", list(_GSR_PATHS))
def test_gather_path_rule(case):
    """The owner path for inputs of at most OWNER_MAX_ROWS rows, the runs
    path above, from the row count alone."""
    rows, want = _GSR_PATHS[case]
    assert tgsr.path(rows) == want


# (row width, dtype, bytes the data is aligned to, the runs path's column
# schedule): SAGE's class rows (Reddit2 41, ogbn-products 47, PPI 121),
# odd bf16 widths, 8-byte vectors of either dtype, the widest whole rows of
# each vector and the first past them; the rows the 16-byte vector covers
# (the GNN's 64, the test's 40 and 300, the MoE's 2048 bf16), the rows one
# tile already spans (3, 32 fp32, 66 fp32 at 8-byte vectors) and an
# aligned F = 64 against one read at 4 and 8 bytes
_SCHEDULES = {
    "reddit2_41": (41, torch.float32, 16, "whole_row"),
    "products_47": (47, torch.float32, 16, "whole_row"),
    "ppi_121": (121, torch.float32, 16, "whole_row"),
    "bf16_33": (33, torch.bfloat16, 16, "whole_row"),
    "bf16_41": (41, torch.bfloat16, 16, "whole_row"),
    "fp32_66": (66, torch.float32, 16, "whole_row"),
    "bf16_66": (66, torch.bfloat16, 16, "whole_row"),
    "bf16_132": (132, torch.bfloat16, 16, "whole_row"),
    "fp32_127": (127, torch.float32, 16, "whole_row"),
    "fp32_129": (129, torch.float32, 16, "tiled"),
    "fp32_126": (126, torch.float32, 16, "whole_row"),
    "fp32_130": (130, torch.float32, 16, "tiled"),
    "bf16_252": (252, torch.bfloat16, 16, "whole_row"),
    "bf16_260": (260, torch.bfloat16, 16, "tiled"),
    "gnn_64": (64, torch.float32, 16, "tiled"),
    "gat_head_256": (256, torch.float32, 16, "tiled"),
    "test_40": (40, torch.float32, 16, "tiled"),
    "test_300": (300, torch.float32, 16, "tiled"),
    "moe_2048": (2048, torch.bfloat16, 16, "tiled"),
    "moe_2048_fp32": (2048, torch.float32, 16, "tiled"),
    "one_tile_3": (3, torch.float32, 16, "tiled"),
    "one_tile_32": (32, torch.float32, 4, "tiled"),
    "one_tile_fp32_62": (62, torch.float32, 16, "tiled"),
    "f64_at_4_bytes": (64, torch.float32, 4, "whole_row"),
    "f64_at_8_bytes": (64, torch.float32, 8, "tiled"),
    "f128_at_4_bytes": (128, torch.float32, 4, "whole_row"),
    "f2048_bf16_at_2_bytes": (2048, torch.bfloat16, 2, "tiled"),
}


@pytest.mark.parametrize("case", list(_SCHEDULES))
def test_row_run_schedule_rule(case):
    """Whole rows where the vector narrowed below 16 bytes and the column
    tiles would cut the row, up to what a lane group of 32 holds in
    WHOLE_WORDS registers a lane; the tiles elsewhere. The rule in words:
    the widest vector v that divides F and the alignment; whole_row iff
    v is below 16 bytes, F > 32 v, and F <= 32 v times the vectors a lane
    may hold."""
    feat, dtype, align, want = _SCHEDULES[case]
    assert tgsr.schedule(feat, dtype, align) == want
    es = dtype.itemsize
    v = 16 // es
    while v > 1 and (feat % v or align % (v * es)):
        v //= 2
    cmax = tgsr.WHOLE_WORDS // max(v * es // 4, 1)
    assert want == ("whole_row" if v * es < 16 and 32 * v < feat
                    <= 32 * v * cmax else "tiled")


def test_row_run_schedule_matches_kernel_source():
    """The rule's constants are the kernel header's, and the sweep of
    WHOLE_LPR builds the shipped pair among its variants."""
    from repro_torch import kernel_variants as kv
    hdr = (ROOT / "src/repro_torch/kernels/csrc/row_runs.cuh").read_text()
    (lpr,) = re.findall(r"#define WHOLE_LPR (\d+)", hdr)
    (words,) = re.findall(r"#define WHOLE_WORDS (\d+)", hdr)
    assert (int(lpr), int(words)) == (tgsr.WHOLE_LPR, tgsr.WHOLE_WORDS)
    assert (tgsr.WHOLE_LPR, tgsr.WHOLE_WORDS) in kv.WHOLE_SWEEP
    assert f"WHOLE_LPR = {tgsr.WHOLE_LPR} is the sweep's choice" in \
        " ".join(ln.lstrip("/ ") for ln in hdr.splitlines())
    src = (ROOT / "src/repro_torch/kernels/csrc/gather_segment_reduce.cu"
           ).read_text()
    assert 'extern "C" int gsr_tiled_launch(' in src


def test_alignment_of_row_data():
    """The bytes a launch may read a vector at: the largest power of two up
    to 16 dividing every address (a row slice moves the address)."""
    x = torch.zeros(10, 41)
    assert tgsr.alignment(x) == 16
    assert tgsr.alignment(x[1:]) == 4
    assert tgsr.alignment(x, x[2:]) == 8
    assert tgsr.alignment(torch.zeros(10, 8, dtype=torch.bfloat16)[1:]) == 16
    assert tgsr.alignment(torch.zeros(10, 3, dtype=torch.bfloat16)[1:]) == 2


def test_schedule_counter_and_its_obs_mirror():
    """The row-run kernels count their launches by schedule apart from
    their paths: a SAGE forward on the plain path counts nothing and its
    counts still sum to the kernels' runs-path launches; a counted launch
    bumps its op's schedule and the obs mirror; a reset zeroes every
    counter."""
    from repro_torch import obs
    from repro_torch.models import gnn
    kops.reset_launch_counts()
    model = gnn.init("sage", 8, 16, 41, device="cpu")
    src, dst, x, _, v = _graph(v=70, e=340, f=8)
    with torch.no_grad():
        out = gnn.forward(model, _t(x), torch.stack([_t(src), _t(dst)]), v)
    assert out.shape == (v, 41)

    def runs_launches():
        return (kops.path_launch_counts()["gather_segment_reduce"]["runs"],
                kops.launch_counts()["segment_reduce"])
    sched = kops.schedule_launch_counts()
    assert sched == {k: {"tiled": 0, "whole_row": 0}
                     for k in ("gather_segment_reduce", "segment_reduce")}
    assert tuple(sum(sched[k].values()) for k in sched) == runs_launches()
    kops.account("unfused", "probe")  # registers the launch mirrors
    assert obs.get_registry().schema()["kernel.schedule_launches"] == (
        "op", "schedule")
    mirror = obs.get_registry().get("kernel.schedule_launches")
    before = mirror.value(op="segment_reduce", schedule="whole_row")
    tgsr.count_schedule("segment_reduce", tsrd.schedule_launches,
                        "whole_row")
    assert kops.schedule_launch_counts()["segment_reduce"] == {
        "tiled": 0, "whole_row": 1}
    assert mirror.value(op="segment_reduce", schedule="whole_row") == \
        before + 1
    kops.reset_launch_counts()
    assert all(n == 0 for by in kops.schedule_launch_counts().values()
               for n in by.values())


# (row width, A's dtype, the path): the GNN's F = 64 (the arxiv pairs), the
# crossing at 384 bytes a row either side in both dtypes, the combine's
# router-weight gradient (3i, F = 2048) and an odd width
_SDDMM_PATHS = {"gnn_f64": (64, torch.float32, "runs"),
                "gnn_f64_bf16": (64, torch.bfloat16, "runs"),
                "fp32_border": (96, torch.float32, "runs"),
                "fp32_past": (97, torch.float32, "wide"),
                "bf16_border": (192, torch.bfloat16, "runs"),
                "bf16_past": (193, torch.bfloat16, "wide"),
                "train_3i": (2048, torch.float32, "wide"),
                "odd_2050": (2050, torch.bfloat16, "wide")}


@pytest.mark.parametrize("case", list(_SDDMM_PATHS))
def test_sddmm_path_rule(case):
    """The wide path for rows of more than WIDE_MIN_BYTES, the runs path
    for narrower ones: one rule on the width in A's dtype."""
    n, dtype, want = _SDDMM_PATHS[case]
    assert tsdd.path(n, dtype) == want
    assert tsdd.path(n, dtype) == (
        "wide" if n * dtype.itemsize > tsdd.WIDE_MIN_BYTES else "runs")


def _decode_graph():
    """The MoE combine at decode, narrowed: 64 rows into 8 segments of 8
    (tokens, sorted), gathered through a permutation (the expert order)."""
    rng = np.random.default_rng(17)
    dst = np.repeat(np.arange(8), 8).astype(np.int32)
    src = rng.permutation(64).astype(np.int32)
    x = rng.standard_normal((64, 24)).astype(np.float32)
    w = rng.random(64).astype(np.float32)
    return src, dst, x, w, 8


_OWNER_GRAPHS = {**_GRAPHS, "decode": _decode_graph}


@pytest.mark.parametrize("graph", list(_OWNER_GRAPHS))
@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_owner_schedule_matches_pallas(graph, reduce, weighted):
    """The owner path's schedule (each segment's rows found by the lower
    bounds of s and s + 1, walked in row order in fp32, no row offsets)
    against the reference's Pallas gather and the plain version: empty
    segments and dropped rows (windowed, hub), one hub segment of 300 rows
    (hub), the decode combine's eight rows a token (decode)."""
    src, dst, x, w, v = _OWNER_GRAPHS[graph]()
    wt = _t(w) if weighted else None
    for s in range(v + 1):
        assert tgsr.lower_bound(_t(dst), s) == int(
            np.searchsorted(dst, s, side="left"))
    got = tgsr.gather_segment_reduce_owner(_t(x), _t(src), _t(dst), v, wt,
                                           reduce)
    np.testing.assert_allclose(_np(got), _pallas_gather(graph, reduce,
                                                        weighted),
                               **_tol("float32"))
    want = kops.gather_segment_reduce(_t(x), _t(src), _t(dst), v, weight=wt,
                                      reduce=reduce, impl="ref")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    empty = np.searchsorted(dst, np.arange(v), "left") == np.searchsorted(
        dst, np.arange(v), "right")
    if empty.any():
        assert bool((got[empty] == (float("-inf") if reduce == "max" else 0)
                     ).all())


@pytest.mark.parametrize("rows", ["none", "all_dropped"])
@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
def test_owner_schedule_without_rows(rows, reduce):
    """No rows, or every row dropped (seg = num_segments): each segment is
    empty, 0 for a sum or mean and -inf for a max, as the plain version
    gives; a dropped row's H row is never read (here it lies out of
    range)."""
    v, f = 6, 5
    n = 0 if rows == "none" else 9
    dst = torch.full((n,), v, dtype=torch.int32)
    src = torch.full((n,), 10_000, dtype=torch.int32)
    x = torch.randn(4, f)
    got = tgsr.gather_segment_reduce_owner(x, src, dst, v, None, reduce)
    assert got.shape == (v, f)
    assert bool((got == (float("-inf") if reduce == "max" else 0)).all())
    assert torch.equal(got, kops.gather_segment_reduce(
        x, src.clamp_max(3), dst, v, reduce=reduce, impl="ref"))


# ---------------------------------------------------------------------------
# segment_matmul's wgmma path: its work items and path rule on the CPU
# ---------------------------------------------------------------------------

# small MoE-like shapes: (group sizes, rows past the groups, K, N)
_SMM_BLOCKED = {
    # G = 16 groups of 0-3 rows (the decode regime), rows past the groups
    "tiny_groups": (np.array([3, 0, 2, 1, 0, 3, 1, 2, 0, 0, 1, 3, 2, 1, 0, 1]),
                    11, 64, 48),
    # G = 8 with one group of 300 rows: three row tiles, the last partial
    "one_deep_group": (np.array([0, 5, 300, 0, 7, 1, 0, 2]), 4, 64, 48),
}


def _smm_inputs(case, w_transposed, integer):
    """x (M, K), the sizes, W as the call reads it ((G, K, N), or (G, N,
    K) transposed) and as (G, K, N). ``integer``: small integers, whose
    products and sums are exact in fp32, so any two orders of a sum give
    the same bits."""
    sizes, pad, k, n = _SMM_BLOCKED[case]
    m = int(sizes.sum()) + pad
    rng = np.random.default_rng(len(case) + 7 * w_transposed)
    if integer:
        x = rng.integers(-4, 5, (m, k)).astype(np.float32)
        w = rng.integers(-4, 5, (sizes.size, k, n)).astype(np.float32)
    else:
        x = rng.standard_normal((m, k)).astype(np.float32)
        w = (rng.standard_normal((sizes.size, k, n)) / np.sqrt(k)).astype(
            np.float32)
    w_call = np.ascontiguousarray(w.transpose(0, 2, 1)) if w_transposed \
        else w
    return x, sizes.astype(np.int32), w_call, w, m, n


@pytest.mark.parametrize("w_transposed", [False, True])
@pytest.mark.parametrize("case", list(_SMM_BLOCKED))
def test_segment_matmul_blocked_schedule(case, w_transposed):
    """The wgmma path's work items, as the kernel walks them: every row of
    [0, M) written by exactly one item of each column tile, the count within
    the static bound that sizes the grid, rows past the groups by items that
    read no W; the blocked result equal to the plain version's bits in fp32
    (exact integer inputs) and to the reference's Pallas kernel (interpret
    mode) within 1e-5, with W read as (G, K, N) or (G, N, K)."""
    x, sizes, w_call, w, m, n = _smm_inputs(case, w_transposed, True)
    g = sizes.size
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    items = tsmm.work_items(torch.from_numpy(offsets), m, n)
    assert len(items) <= tsmm.item_bound(m, n, g)
    writes = np.zeros((m, -(-n // tsmm.TC_BN)), np.int64)
    for seg, row0, rows, n0 in items:
        assert 0 < rows <= tsmm.TC_BM
        lo, hi = (offsets[seg], offsets[seg + 1]) if seg < g else (
            offsets[g], m)
        assert lo <= row0 and row0 + rows <= hi   # never straddles a group
        assert (row0 - lo) % tsmm.TC_BM == 0      # tiles start at its row
        writes[row0:row0 + rows, n0 // tsmm.TC_BN] += 1
    assert (writes == 1).all()
    assert [it[0] for it in items] == sorted(it[0] for it in items)
    past = [it for it in items if it[0] == g]
    assert sum(it[2] for it in past) == (m - offsets[g]) * writes.shape[1]

    xt, st, wt = (torch.from_numpy(a) for a in (x, sizes, w_call))
    got = kops.segment_matmul(xt, st, wt, impl="blocked",
                              w_transposed=w_transposed)
    want = kops.segment_matmul(xt, st, wt, impl="ref",
                               w_transposed=w_transposed)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert torch.equal(got, want)
    assert not bool(got[int(sizes.sum()):].any())

    x, sizes, w_call, w, m, n = _smm_inputs(case, w_transposed, False)
    got = tsmm.segment_matmul_blocked(torch.from_numpy(x),
                                      torch.from_numpy(sizes),
                                      torch.from_numpy(w_call), w_transposed)
    pallas = segment_matmul_pallas(jnp.asarray(x), jnp.asarray(sizes),
                                   jnp.asarray(w), m_b=16, n_b=128,
                                   interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas, np.float32),
                               rtol=1e-5, atol=1e-5)


def _card_smm_cases():
    """The card tests' SMM_CASES (tests/test_torch_cuda.py) as (K, N, G)."""
    from test_torch_cuda import SMM_CASES
    out = {}
    for name, c in SMM_CASES.items():
        sizes = c["sizes"](np.random.default_rng(len(name)))
        out[name] = (c["k"], c["n"], int(sizes.size),
                     int(sizes.sum()) + c["pad"])
    return out


# the path each card case takes in bf16 (fp32 always takes mma_sync); the
# four MoE products of qwen3-moe-30b-a3b at decode and at 16,384 rows
_SMM_PATHS = {
    "zipf": "wgmma", "padded": "wgmma", "single": "wgmma",
    # N below TC_MIN_N = 64: narrow outputs stay on mma_sync
    "all_empty": "mma_sync", "n16": "mma_sync", "n32": "mma_sync",
    "k1024": "mma_sync",
    "tiny_groups": "mma_sync",      # 2000 groups: above TC_MAX_GROUPS
    "odd_k": "mma_sync", "k1001": "mma_sync",   # K not a multiple of 8
    "deep_k": "wgmma", "k512": "wgmma",
    "moe_decode": "wgmma", "moe_down": "wgmma", "moe_16k": "wgmma",
    "dropless_tail": "wgmma", "one_row": "wgmma",
}
_MOE_SHAPES = {"up_decode": (64, 2048, 768, 128),
               "down_decode": (64, 768, 2048, 128),
               "up_16k": (16384, 2048, 768, 128),
               "down_16k": (16384, 768, 2048, 128)}


@pytest.mark.parametrize("case", list(_SMM_PATHS) + list(_MOE_SHAPES))
def test_segment_matmul_path_rule(case):
    """One rule, a pure function of dtype, shape and alignment, picks the
    kernel: the branch it names for every card case and the MoE shapes;
    fp32 and a misaligned base always take mma_sync."""
    if case in _MOE_SHAPES:
        m, k, n, g = _MOE_SHAPES[case]
        want = "wgmma"
    else:
        k, n, g, m = _card_smm_cases()[case]
        want = _SMM_PATHS[case]
    # more groups than shared memory keeps offsets for, or N below the
    # threshold: mma_sync whatever else the shape
    assert tsmm.path(torch.bfloat16, m, k, max(n, 64),
                     tsmm.TC_MAX_GROUPS + 1) == "mma_sync"
    assert tsmm.path(torch.bfloat16, m, k, tsmm.TC_MIN_N - 8, g) == \
        "mma_sync"
    assert tsmm.path(torch.bfloat16, m, k, n, g) == want
    assert tsmm.path(torch.float32, m, k, n, g) == "mma_sync"
    assert tsmm.path(torch.bfloat16, m, k, n, g, aligned=False) == \
        "mma_sync"
    # transposed W: the same rule on the product's K and N
    w = torch.empty(g, n, k, dtype=torch.bfloat16)
    x = torch.empty(m, k, dtype=torch.bfloat16)
    assert tsmm.path_of(x, w, w_transposed=True) == want


def test_segment_matmul_cards_cases_all_have_a_path():
    from test_torch_cuda import SMM_CASES
    assert set(SMM_CASES) == set(_SMM_PATHS)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_segment_matmul_offsets_alone_match_the_metadata(dtype):
    """The wgmma path's only metadata, the offsets, equal the row-block
    schedule's; the path counts reset with the launch counts."""
    sizes = torch.tensor([3, 0, 5, 1, 0], dtype=dtype)
    off = tsmm.group_offsets(sizes)
    assert off.dtype == torch.int32
    assert torch.equal(off, tsmm.group_metadata(sizes, 20, 64)[0])
    tsmm.path_launches["wgmma"] += 1
    kops.reset_launch_counts()
    assert kops.path_launch_counts()["segment_matmul"] == {"wgmma": 0,
                                                           "mma_sync": 0}


def test_segment_matmul_tile_matches_kernel_source():
    """The mirror's tile, the group limit and the item bound are the
    kernel's own."""
    src = (ROOT / "src/repro_torch/kernels/csrc/segment_matmul.cu"
           ).read_text()
    for name, value in (("TC_BM", tsmm.TC_BM), ("TC_BN", tsmm.TC_BN),
                        ("TC_MAX_GROUPS", tsmm.TC_MAX_GROUPS)):
        assert re.findall(rf"constexpr int {name} = (\d+);", src) == [
            str(value)], name
    assert "(num_rows + TC_BM - 1) / TC_BM + num_groups" in src
    assert tsmm.item_bound(1, 1, 1) == 2
    assert tsmm.item_bound(300, 48, 8, bm=128, bn=128) == 3 + 8


# ---------------------------------------------------------------------------
# backend rules, the Hopper gate, and the package boundary
# ---------------------------------------------------------------------------

def test_fusable_rejects_over_budget():
    cfg = default_config(64)
    assert fusable(32, 64, torch.float32, cfg)
    assert fusable(64, 64, torch.bfloat16, cfg)
    assert not fusable(4096, 4096, torch.float32, cfg)
    # W stays resident in shared memory: 512 x 256 fp32 is 512 KB (the
    # window kernel, which streamed W, took it)
    assert not fusable(512, 256, torch.float32, cfg)
    assert not fusable(512, 256, torch.bfloat16, cfg)
    # the config's tile sizes the block again, as the reference's does
    assert fusable(64, 64, torch.float32, TConfig("SR", 128, 128, 64, 1))
    assert not fusable(64, 64, torch.float32, TConfig("SR", 2048, 128, 64, 1))
    # the order rule, on the H100 model at ogbn-arxiv: fused only with the
    # kernel and a fitting footprint
    arxiv = dict(num_edges=1_166_243, num_nodes=169_343)
    assert tmp.choose_order(32, 64, allow_fused=True, **arxiv) == "fused"
    assert tmp.choose_order(4096, 8192, allow_fused=True,
                            **arxiv) == "aggregate_first"
    assert tmp.choose_order(32, 64, **arxiv) == "aggregate_first"
    assert tmp.choose_order(64, 16, **arxiv) == "transform_first"
    with pytest.raises(ValueError, match="plan or"):
        tmp.choose_order(32, 64)
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
            lambda: fused_transform_reduce_cuda(
                h, wm, s, d, v, None, "sum",
                torch.zeros(v + 1, dtype=torch.int64)),
    }


@pytest.mark.parametrize("call", list(_cuda_calls()))
def test_impl_cuda_on_cpu_tensors_raises(call):
    before = kops.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        _cuda_calls()[call]()
    assert kops.launch_counts() == before


def test_blocked_fused_transform_reduce_refuses_max():
    """The fused kernel is linear-only: its blocked mirror refuses max as
    the kernel does."""
    src, dst, x, w, v = _graph()
    with pytest.raises(ValueError, match="unknown reduce"):
        kops.fused_transform_reduce(_t(x), torch.ones(12, 4), _t(src),
                                    _t(dst), v, reduce="max", impl="blocked")


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
            "repro_torch.kernels.ops, repro_torch.hetero_inference, "
            "repro_torch.obs, repro_torch.obs.export, "
            "repro_torch.data.sampling, repro_torch.data.pipeline, "
            "repro_torch.train.providers, repro_torch.models.lm, "
            "repro_torch.models.moe, repro_torch.configs, "
            "repro_torch.configs.shapes, repro_torch.serve.lm, "
            "repro_torch.launch.serve, repro_torch.data.tokens; "
            "from repro_torch import configs; "
            "[configs.get_config(a) for a in configs.ARCH_NAMES]; "
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

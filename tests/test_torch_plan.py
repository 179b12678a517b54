"""The port's plans, graphs and bucket templates against the reference.

Everything here is integer or numpy data, so parity is exact: plan fields
and statistics, synthetic graphs, padding, batching and stamped bucket
plans must be bitwise identical to ``repro``'s; the plans' row offsets
(the port's only plan metadata) are the sorted index's segment starts.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import plan as jplan  # noqa: E402
from repro.core.config_space import KernelConfig as JConfig  # noqa: E402
from repro.data import graphs as jgraphs  # noqa: E402
from repro.serve.buckets import ShapeBucket as JBucket  # noqa: E402
from repro.serve.plan_cache import BucketEntry as JEntry  # noqa: E402

from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core.config_space import KernelConfig as TConfig  # noqa: E402
from repro_torch.data import graphs as tgraphs  # noqa: E402
from repro_torch.serve.buckets import ShapeBucket as TBucket  # noqa: E402
from repro_torch.serve.plan_cache import BucketEntry as TEntry  # noqa: E402

TILINGS = [(32, 64), (64, 64), (16, 8), (128, 256), (7, 5)]


def _index(kind: str):
    """(sorted idx, num_segments) for one index shape."""
    rng = np.random.default_rng(len(kind))
    if kind == "empty":
        return np.zeros(0, np.int32), 50
    if kind == "gapped":           # ids multiple of 5: many empty segments
        return np.sort(rng.integers(0, 60, 500) * 5).astype(np.int32), 300
    if kind == "ragged":           # num_segments % s_b != 0 for every tiling
        return np.sort(rng.integers(0, 1001, 4000)).astype(np.int32), 1001
    if kind == "skewed":           # one hub segment holding half the rows
        idx = np.concatenate([rng.integers(0, 97, 300), np.full(300, 40)])
        return np.sort(idx).astype(np.int32), 97
    raise ValueError(kind)


KINDS = ["empty", "gapped", "ragged", "skewed"]


def _assert_plans_equal(tp, jp, idx=None):
    """The port's plan against the reference's: sizes, statistics and
    config equal; row offsets the segment starts of ``idx`` (the padded
    index the reference's plan was built from, when given)."""
    assert (tp.num_rows, tp.num_segments) == (jp.num_rows, jp.num_segments)
    assert dataclasses.astuple(tp.stats) == dataclasses.astuple(jp.stats)
    assert tp.config.astuple() == jp.config.astuple()
    assert tp.row_ptr.dtype == torch.int64
    assert tp.row_ptr.shape == (tp.num_segments + 1,)
    if idx is not None:
        np.testing.assert_array_equal(
            tp.row_ptr.numpy(),
            np.searchsorted(np.asarray(idx), np.arange(tp.num_segments + 1),
                            side="left"))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("tiling", TILINGS)
def test_make_plan_matches_reference(kind, tiling):
    s_b, m_b = tiling
    idx, s = _index(kind)
    tp = tplan.make_plan(idx, s, config=TConfig("SR", s_b, 128, m_b, 1),
                         device="cpu")
    jp = jplan.make_plan(idx, s, config=JConfig("SR", s_b, 128, m_b, 1))
    _assert_plans_equal(tp, jp, idx)
    # a tensor index gives the same plan as a numpy one
    _assert_plans_equal(
        tplan.make_plan(torch.from_numpy(idx), s,
                        config=TConfig("SR", s_b, 128, m_b, 1),
                        device="cpu"), jp, idx)


@pytest.mark.parametrize("tiling", TILINGS[:3])
def test_make_graph_plan_matches_reference(tiling):
    s_b, m_b = tiling
    g = jgraphs.synth_graph("g", 333, 2000, feat=8, seed=3)
    tp = tplan.make_graph_plan(g.edge_index, g.num_nodes,
                               config=TConfig("SR", s_b, 128, m_b, 1),
                               device="cpu")
    jp = jplan.make_graph_plan(g.edge_index, g.num_nodes,
                               config=JConfig("SR", s_b, 128, m_b, 1))
    _assert_plans_equal(tp, jp, g.edge_index[1])


def test_plan_validation_and_misuse():
    idx, s = _index("ragged")
    p = tplan.make_plan(idx, s, config=TConfig("SR", 32, 128, 64, 1),
                        device="cpu")
    with pytest.raises(ValueError, match="rebuild the plan"):
        p.validate(idx.size + 1, s)
    with pytest.raises(ValueError, match="sorted"):
        tplan.make_plan(idx[::-1].copy(), s, device="cpu")
    assert p.to("cpu") is p


# ---------------------------------------------------------------------------
# graphs: bitwise identical to the reference for the same seed
# ---------------------------------------------------------------------------

def _assert_graphs_equal(tg, jg):
    for f in ("name", "num_nodes", "orig_num_nodes", "orig_num_edges"):
        assert getattr(tg, f) == getattr(jg, f), f
    for f in ("edge_index", "x", "labels", "deg_inv_sqrt", "node_ptr",
              "edge_ptr"):
        a, b = getattr(tg, f), getattr(jg, f)
        if b is None:
            assert a is None, f
            continue
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("v,e,seed", [(50, 170, 0), (1000, 9000, 3),
                                      (20, 0, 1), (8, 8, 5)])
def test_synth_graph_bitwise(v, e, seed):
    _assert_graphs_equal(tgraphs.synth_graph("g", v, e, feat=6, seed=seed),
                         jgraphs.synth_graph("g", v, e, feat=6, seed=seed))


@pytest.mark.parametrize("name", ["cora", "citeseer", "pubmed", "ogbn-arxiv"])
def test_dataset_bitwise(name):
    assert tgraphs.all_dataset_names() == jgraphs.all_dataset_names()
    _assert_graphs_equal(tgraphs.dataset(name, feat=8, scale=0.02, seed=1),
                         jgraphs.dataset(name, feat=8, scale=0.02, seed=1))


def test_pad_batch_unbatch_bitwise():
    parts = [(30, 90, 0), (45, 100, 1), (12, 0, 2)]
    tgs = [tgraphs.synth_graph(f"g{i}", v, e, feat=4, seed=s)
           for i, (v, e, s) in enumerate(parts)]
    jgs = [jgraphs.synth_graph(f"g{i}", v, e, feat=4, seed=s)
           for i, (v, e, s) in enumerate(parts)]
    tb, jb = tgraphs.batch_graphs(tgs), jgraphs.batch_graphs(jgs)
    _assert_graphs_equal(tb, jb)
    _assert_graphs_equal(tgraphs.batch_graphs(tgs[:1]),
                         jgraphs.batch_graphs(jgs[:1]))
    tp, jp = tgraphs.pad_graph(tb, 128, 256), jgraphs.pad_graph(jb, 128, 256)
    _assert_graphs_equal(tp, jp)
    _assert_graphs_equal(tgraphs.pad_graph(tp, 256, 512),
                         jgraphs.pad_graph(jp, 256, 512))
    _assert_graphs_equal(tgraphs.unpad_graph(tp), jgraphs.unpad_graph(jp))
    vals = np.arange(128 * 3).reshape(128, 3)
    evals = np.arange(256)
    for t, j in [(tgraphs.unbatch_nodes(tb, tgraphs.unpad_nodes(tp, vals)),
                  jgraphs.unbatch_nodes(jb, jgraphs.unpad_nodes(jp, vals))),
                 (tgraphs.unbatch_edges(tb, tgraphs.unpad_edges(tp, evals)),
                  jgraphs.unbatch_edges(jb, jgraphs.unpad_edges(jp, evals)))]:
        assert len(t) == len(j)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="shrink"):
        tgraphs.pad_graph(tb, 32, 256)
    with pytest.raises(ValueError, match="padded"):
        tgraphs.batch_graphs([tp, tgs[0]])


# ---------------------------------------------------------------------------
# bucket templates: a stamped plan is the reference's stamped plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bucket,v,e", [((128, 256), 100, 200),
                                        ((64, 64), 64, 64),
                                        ((256, 1024), 3, 0)])
@pytest.mark.parametrize("tiling", [(32, 64), (64, 64), (16, 8)])
def test_bucket_entry_stamp_matches_reference(bucket, v, e, tiling):
    s_b, m_b = tiling
    g = jgraphs.synth_graph("g", v, e, feat=4, seed=4)
    dst = jgraphs.pad_graph(g, *bucket).edge_index[1]
    te = TEntry(TBucket(*bucket), 16, TConfig("SR", s_b, 128, m_b, 1))
    je = JEntry(JBucket(*bucket), 16, JConfig("SR", s_b, 128, m_b, 1))
    _assert_plans_equal(te.template, je.template,
                        np.full(bucket[1], bucket[0], np.int32))
    _assert_plans_equal(te.stamp(dst), je.stamp(dst), dst)
    _assert_plans_equal(te.stamp(torch.from_numpy(dst)), je.stamp(dst), dst)
    with pytest.raises(ValueError, match="padded edges"):
        te.stamp(dst[:-1])


def test_config_space_matches_reference():
    from repro.core import config_space as jcs

    from repro_torch.core import config_space as tcs
    assert tcs.OP_KEYS == jcs.OP_KEYS and tcs.IO_DTYPES == jcs.IO_DTYPES
    for t, j in [(torch.float32, "float32"), (torch.bfloat16, "bfloat16"),
                 ("float16", "float16"), (np.float32, np.float32),
                 (np.dtype("int64"), np.dtype("int64"))]:
        assert tcs.io_dtype_bytes(t) == jcs.io_dtype_bytes(j)
        assert tcs.canonical_io_dtype(t) == jcs.canonical_io_dtype(j)
    assert TConfig("SR", 8, 128, 16, 99).astuple() == \
        JConfig("SR", 8, 128, 16, 99).astuple()
    cfg = tcs.default_config(64)
    assert (cfg.s_b, cfg.m_b, cfg.n_b) == (64, 64, 64)
    assert tcs.default_config(1000).n_b == 256

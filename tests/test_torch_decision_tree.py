"""The port's rule pipeline (paper §III-C) on the CPU: the numpy decision
tree, the Hopper PerfDB, codegen, the committed rules, the H100 cost
model's order rule, and parity with the reference package: the same
dataset statistics, and trees fitted on the same seeded records predict
the same."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import perfdb as jperfdb  # noqa: E402
from repro.core.decision_tree import MultiOutputDecisionTree as JTree  # noqa: E402

from repro_torch.core import codegen, costmodel, perfdb  # noqa: E402
from repro_torch.core import mp as tmp  # noqa: E402
from repro_torch.core.config_space import (RUN_LENGTHS, TILE_SIZES,  # noqa: E402
                                           KernelConfig, all_configs,
                                           default_config)
from repro_torch.core.decision_tree import MultiOutputDecisionTree  # noqa: E402
from repro_torch.core.features import InputFeatures  # noqa: E402


def test_tree_fits_separable_data():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (400, 3))
    y = np.stack([np.where(x[:, 0] > 0, 10.0, 2.0),
                  np.where(x[:, 1] > 0.5, 7.0, 1.0)], axis=1)
    tree = MultiOutputDecisionTree(max_depth=4, min_samples_leaf=4).fit(x, y)
    assert np.mean((tree.predict(x) - y) ** 2) < 0.5
    assert tree.depth() <= 4


def test_tree_multioutput_joint_selection():
    """Leaves carry the whole config vector jointly (the paper's
    multi-output regressor, not one tree a parameter)."""
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (300, 2))
    y = np.where(x[:, :1] > 0.5, np.array([[128.0, 256.0]]),
                 np.array([[32.0, 64.0]]))
    tree = MultiOutputDecisionTree(max_depth=3, min_samples_leaf=4).fit(x, y)
    p = tree.predict(np.array([0.9, 0.5]))
    assert p[0] > 64 and p[1] > 128


def test_perfdb_pipeline_small():
    datasets = perfdb.base_datasets(12)
    records = perfdb.build_perfdb(perfdb.augment(datasets, factor=2),
                                  feature_sizes=(1, 16, 64))
    assert len(records) > 500
    x, y = perfdb.top1_training_set(records, "SR")
    assert x.shape[0] == y.shape[0] > 0 and y.shape[1] == len(perfdb.AXES)
    assert set(y[:, 0]) <= set(TILE_SIZES) and set(y[:, 1]) <= set(RUN_LENGTHS)


def test_codegen_reproduces_tree_exactly():
    """The generated if/else rules return exactly the snapped tree leaves
    (paper Listing 3 analogue), at the width's fitting tile."""
    records = perfdb.build_perfdb(perfdb.augment(perfdb.base_datasets(10),
                                                 factor=2),
                                  feature_sizes=(1, 8, 64))
    x, y = perfdb.top1_training_set(records)
    tree = MultiOutputDecisionTree(max_depth=4).fit(x, y)
    src = codegen.generate_rules_source(tree, InputFeatures.names(), "test")
    ns: dict = {}
    exec(src, ns)  # noqa: S102 — our own codegen
    rng = np.random.default_rng(2)
    for _ in range(200):
        feats = rng.uniform([10, -4, 0], [25, 7, 7])
        got = ns["select"](*feats)
        want = perfdb.snap_config(tree.predict(feats))
        assert (got.m_b, got.s_b) == (want.m_b, want.s_b)
        assert got == ns["select_sr"](*feats)


def test_snap_config_valid():
    cfg = perfdb.snap_config(np.array([100.0, 999.0]))
    assert (cfg.s_b, cfg.m_b) == (128, 256)
    assert cfg.schedule == "SR" and cfg in all_configs()
    assert perfdb.snap_config(np.array([40.0, 70.0])) == KernelConfig(
        "SR", 32, 128, 64, 1)


def test_generated_rules_committed_and_loadable():
    """The committed rules give built values everywhere, and the shipped
    ones at the served ogbn-arxiv and reddit2 shapes and at AM (where
    a sweep on the card found them fastest)."""
    from repro_torch.core import _generated_rules as gr
    for feats in ((10.0, -2.0, 0.0), (20.0, 2.5, 5.0), (24.0, 7.0, 7.0)):
        cfg = gr.select(*feats)
        assert cfg.schedule == "SR"
        assert cfg.m_b in RUN_LENGTHS and cfg.s_b in TILE_SIZES
    for m, s, f in ((2_097_152, 262_144, 32), (2_097_152, 262_144, 64),
                    (33_554_432, 262_144, 32), (5_988_321, 1_666_764, 64)):
        cfg = gr.select(*InputFeatures(m, s, f).as_vector())
        assert (cfg.m_b, cfg.s_b) == (64, 64), (m, s, f)
    assert "analytical H100 cost model" in gr.__doc__


# ---------------------------------------------------------------------------
# parity with the reference package
# ---------------------------------------------------------------------------

def test_datasets_and_augmentation_match_reference():
    assert perfdb.TABLE_II == jperfdb.TABLE_II
    assert perfdb.FEATURE_SIZES == jperfdb.FEATURE_SIZES
    for a, b in zip(perfdb.augment(perfdb.base_datasets(), factor=3),
                    jperfdb.augment(jperfdb.base_datasets(), factor=3)):
        assert (a.name, a.num_nodes, a.num_edges) == \
            (b.name, b.num_nodes, b.num_edges)


@pytest.mark.parametrize("seed,depth,outputs", [(0, 5, 2), (1, 3, 4),
                                                (2, 6, 1)])
def test_tree_predicts_as_the_reference(seed, depth, outputs):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3, 3, (600, 3))
    y = np.stack([np.where(x[:, i % 3] > 0.3 * i, 2.0 ** (i + 5), 16.0)
                  + rng.normal(0, 1, 600) for i in range(outputs)], axis=1)
    ours = MultiOutputDecisionTree(max_depth=depth, min_samples_leaf=5).fit(
        x, y)
    ref = JTree(max_depth=depth, min_samples_leaf=5).fit(x, y)
    q = rng.uniform(-4, 4, (300, 3))
    np.testing.assert_array_equal(ours.predict(q), ref.predict(q))
    assert (ours.depth(), ours.num_leaves()) == (ref.depth(), ref.num_leaves())


# ---------------------------------------------------------------------------
# the H100 cost model and the order rule
# ---------------------------------------------------------------------------

def test_cost_model_is_the_kernels_schedule():
    """Fewer lane groups cost rate; longer runs write fewer partials; a
    larger fused tile loads W fewer times; fused saves the aggregate's
    round trip."""
    cfg = default_config(64)
    arxiv = (1_166_243, 169_343)
    narrow = [costmodel.spmm_cost(*arxiv, 32, KernelConfig(m_b=r)).total_s
              for r in RUN_LENGTHS]
    assert narrow[0] < narrow[-1]          # runs of 256: too few groups
    wide = [costmodel.spmm_cost(23_213_838, 232_965, 128,
                                KernelConfig(m_b=r)).memory_s
            for r in RUN_LENGTHS]
    assert wide[0] > wide[-1]              # fewer partials at full rate
    skewed = costmodel.spmm_cost(*arxiv, 64, cfg, skew=50.0)
    assert skewed.total_s >= costmodel.spmm_cost(*arxiv, 64, cfg).total_s
    fused = costmodel.fused_transform_reduce_cost(*arxiv, 32, 64, cfg)
    two = (costmodel.spmm_cost(*arxiv, 32, cfg).total_s
           + costmodel.dense_matmul_cost(arxiv[1], 32, 64).total_s)
    assert fused.total_s < two
    assert costmodel.lanes_per_row(64, 4) == 16
    assert costmodel.lanes_per_row(3, 4) == 4


def test_choose_order_tie_breaks_and_plan_skew():
    """Transform-first is the default, aggregate-first must win strictly,
    fused must beat both strictly; a plan brings |E|, |V| and its skew."""
    from repro_torch.core.plan import make_graph_plan
    from repro_torch.data.graphs import synth_graph
    kw = dict(num_edges=1_166_243, num_nodes=169_343)
    assert tmp.choose_order(64, 64, **kw) == "transform_first"
    assert tmp.choose_order(64, 64, allow_fused=True, **kw) == "fused"
    assert tmp.choose_order(16, 64, **kw) == "aggregate_first"
    g = synth_graph("g", 3000, 40_000, feat=8, seed=1)
    plan = make_graph_plan(g.edge_index, g.num_nodes, feat=64, device="cpu")
    assert plan.stats.skew > 1
    assert tmp.choose_order(64, 16, plan=plan) == tmp.choose_order(
        64, 16, num_edges=plan.stats.num_rows,
        num_nodes=plan.stats.num_segments, config=plan.config) == \
        "transform_first"

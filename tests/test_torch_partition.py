"""The port's partitioned graphs, partitioned plans and int8 compression on
the CPU, against the reference.

``partition_graph``'s arrays, ``node_ptr`` and ``HaloInfo`` must be bitwise
the reference's (``repro.data.partition``) on the same seeded graphs: the
partition is numpy on the host in both packages. Each shard's plan must be
``make_plan`` over that shard's padded destinations, and the compression
(``repro.optim.compression``) bitwise the reference's arithmetic.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.data import graphs as jgraphs  # noqa: E402
from repro.data import partition as jpartition  # noqa: E402
from repro.optim import compression as jcompression  # noqa: E402

from repro_torch.core.plan import make_plan, source_order  # noqa: E402
from repro_torch.data import graphs, partition  # noqa: E402
from repro_torch.optim import compression  # noqa: E402

ARRAYS = ("src_local", "dst_global", "edge_valid", "edge_gather",
          "node_gather", "node_valid", "deg")
STATIC = ("num_shards", "num_nodes", "num_edges", "nodes_per_shard",
          "edges_per_shard", "node_ptr")

# (graph name, |V|, |E|, shards): power-law in-degrees at 1-4 shards, an
# empty graph, a graph of mostly isolated nodes, and one shard a node
CASES = [("powerlaw", 300, 2400, s) for s in (1, 2, 3, 4)] + [
    ("empty", 12, 0, 1), ("empty", 12, 0, 3),
    ("isolated", 400, 60, 4), ("node_per_shard", 7, 30, 7)]


def _pair(name, v, e):
    return (graphs.synth_graph(name, v, e, feat=4, seed=5),
            jgraphs.synth_graph(name, v, e, feat=4, seed=5))


@pytest.mark.parametrize("name,v,e,shards", CASES)
def test_partition_is_bitwise_the_reference(name, v, e, shards):
    g, jg = _pair(name, v, e)
    pg = partition.partition_graph(g, shards, device="cpu")
    jpg = jpartition.partition_graph(jg, shards)
    for k in ARRAYS:
        got, want = getattr(pg, k).numpy(), np.asarray(getattr(jpg, k))
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    for k in STATIC:
        assert getattr(pg, k) == getattr(jpg, k), k
    assert pg.halo == partition.HaloInfo(*jpg.halo.__dict__.values())
    assert pg.halo.cut_fraction == jpg.halo.cut_fraction
    assert g.partition(shards, device="cpu").node_ptr == pg.node_ptr


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_round_trips_are_exact(shards):
    g, _ = _pair("rt", 120, 700)
    pg = partition.partition_graph(g, shards, device="cpu")
    x = torch.from_numpy(g.x)
    vals = torch.randn(g.num_edges, 3,
                       generator=torch.Generator().manual_seed(0))
    stacked_x, stacked_e = pg.shard_nodes(x), pg.shard_edges(vals)
    assert torch.equal(partition.unpartition_nodes(pg, stacked_x), x)
    assert torch.equal(partition.unpartition_edges(pg, stacked_e), vals)
    for r in range(shards):
        assert torch.equal(pg.shard_nodes(x, r), stacked_x[r])
        assert torch.equal(pg.shard_edges(vals, r), stacked_e[r])
        assert not stacked_e[r][~pg.edge_valid[r]].any()


@pytest.mark.parametrize("what", ["unsorted", "zero_shards", "too_many"])
def test_the_reference_errors(what):
    g, jg = _pair("err", 10, 40)
    if what == "unsorted":
        ei = g.edge_index[:, ::-1].copy()
        g = graphs.Graph(g.name, ei, g.num_nodes, g.x, g.labels,
                         g.deg_inv_sqrt)
        jg = jgraphs.Graph(jg.name, ei, jg.num_nodes, jg.x, jg.labels,
                           jg.deg_inv_sqrt)
    shards = {"unsorted": 2, "zero_shards": 0, "too_many": 11}[what]
    with pytest.raises(ValueError) as want:
        jpartition.partition_graph(jg, shards)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        partition.partition_graph(g, shards, device="cpu")


def test_padded_edges_are_dropped_not_cut():
    """A served bucket's padding edges (dst = V) stay with their source as
    edges the kernels drop: they count toward no degree and no cut."""
    g, _ = _pair("pad", 90, 500)
    padded = graphs.pad_graph(g, 128, 1024)
    pg = partition.partition_graph(padded, 3, device="cpu")
    deg = np.bincount(g.edge_index[1], minlength=128).astype(np.float32)
    np.testing.assert_array_equal(pg.deg.numpy(), deg)
    kept = pg.dst_global < 128
    assert int(kept.sum()) == g.num_edges
    assert pg.halo.total_cut <= g.num_edges


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_each_shard_plan_is_make_plan_over_its_padded_dst(shards):
    g, jg = _pair("plan", 200, 1500)
    pg = partition.partition_graph(g, shards, device="cpu")
    pplan = pg.make_plan(feat=32)
    jplan = jpartition.partition_graph(jg, shards).make_plan(feat=32)
    assert pplan.num_shards == shards and pplan.num_segments == g.num_nodes
    assert pplan.num_rows == pg.edges_per_shard
    # the stats of the global index: the reference's
    assert pplan.stats.__dict__ == jplan.stats.__dict__
    for s in range(shards):
        local = pplan.local_plan(s)
        want = make_plan(pg.dst_global[s], g.num_nodes, feat=32,
                         config=pplan.config, device="cpu")
        assert torch.equal(local.row_ptr, want.row_ptr)
        assert local.config == pplan.config
        assert (local.num_rows, local.num_segments) == (want.num_rows,
                                                        want.num_segments)
        order = source_order(pg.src_local[s], pg.dst_global[s], g.num_nodes,
                             pg.nodes_per_shard)
        for k in ("perm", "src", "dst", "row_ptr"):
            assert torch.equal(getattr(local.src_order, k),
                               getattr(order, k)), k
        assert local.src_order.num_real == int(pg.edge_valid[s].sum())
    with pytest.raises(ValueError, match="outside"):
        pplan.local_plan(shards)


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((5, 7)).astype(np.float32) * 3,
            "b": [rng.standard_normal(11).astype(np.float32),
                  rng.standard_normal((2, 3)).astype(np.float32)]}


def _as(tree, fn):
    if isinstance(tree, dict):
        return {k: _as(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as(v, fn) for v in tree]
    return fn(tree)


@pytest.mark.parametrize("what", ["compress", "decompress", "tree"])
def test_compression_is_bitwise_the_reference(what):
    x, ef = _arrays(1)["a"], _arrays(2)["a"] * 0.01
    c, new_ef = compression.compress(torch.from_numpy(x), torch.from_numpy(ef))
    jc, jnew_ef = jcompression.compress(jnp.asarray(x), jnp.asarray(ef))
    if what == "compress":
        assert c.q.dtype == torch.int8
        np.testing.assert_array_equal(c.q.numpy(), np.asarray(jc.q))
        np.testing.assert_array_equal(c.scale.numpy(), np.asarray(jc.scale))
        np.testing.assert_array_equal(new_ef.numpy(), np.asarray(jnew_ef))
    elif what == "decompress":
        np.testing.assert_array_equal(
            compression.decompress(c).numpy(),
            np.asarray(jcompression.decompress(jc)))
    else:
        grads = _arrays(3)
        tef = compression.init_error_feedback(_as(grads, torch.from_numpy))
        jef = jcompression.init_error_feedback(_as(grads, jnp.asarray))
        tc, tef = compression.compress_tree(_as(grads, torch.from_numpy), tef)
        jc, jef = jcompression.compress_tree(_as(grads, jnp.asarray), jef)
        got = compression.decompress_tree(tc)
        want = jcompression.decompress_tree(jc)
        for g, w in ((got["a"], want["a"]), (got["b"][1], want["b"][1]),
                     (tef["b"][0], jef["b"][0])):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert isinstance(tc["b"], list) and tc["b"][0].q.dtype == torch.int8

"""The port's neighbour sampler (``repro_torch.data.sampling``) on the CPU,
against the reference's (``repro.data.sampling``), following
``tests/test_sampling.py``.

The sampler is numpy on the host with the reference's expansion order and
generator calls, so batches are held to the reference **bitwise** (node
ids, edges, features, labels, normalisers) for in-memory and sharded
stores, fanouts with ``None``, exact mode and empty neighbourhoods; shard
directories written by either package read in the other. The exact-mode
parity property (a sampled forward equals the full-graph forward on the
seed rows) is checked on the port's models at fp32 rtol = atol = 1e-5
(the two forwards sum each segment over the same rows, cut differently).
"""
import dataclasses
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import sampling as jsampling  # noqa: E402
from repro.data.graphs import synth_graph as jsynth_graph  # noqa: E402

from repro_torch.core.plan import make_graph_plan  # noqa: E402
from repro_torch.data.graphs import synth_graph  # noqa: E402
from repro_torch.data.sampling import (InMemoryStore, NeighborSampler,  # noqa: E402
                                       ShardedGraphStore, Subgraph,
                                       save_graph_shards)
from repro_torch.models import gnn  # noqa: E402
from repro_torch.serve.buckets import pad_to_bucket  # noqa: E402
from repro_torch.serve.plan_cache import BucketEntry  # noqa: E402
from repro_torch.core.config_space import default_config  # noqa: E402

G = synth_graph("samp", 256, 1024, feat=16, num_classes=8, seed=3)
JG = jsynth_graph("samp", 256, 1024, feat=16, num_classes=8, seed=3)
STORE = InMemoryStore(G)

SUB_FIELDS = ("node_ids", "edge_index", "x", "labels", "deg_inv_sqrt")


def _same(got, want):
    """Bitwise: every array field, its dtype, and the seed count."""
    assert isinstance(got, Subgraph)
    assert got.num_seeds == want.num_seeds
    assert got.num_nodes == want.num_nodes
    for f in SUB_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_graphs_are_the_reference_graphs():
    for f in ("edge_index", "x", "labels", "deg_inv_sqrt"):
        np.testing.assert_array_equal(getattr(G, f), getattr(JG, f))


# ---------------------------------------------------------------------------
# stores
# ---------------------------------------------------------------------------

def test_inmemory_store_matches_reference_and_edge_list():
    jstore = jsampling.InMemoryStore(JG)
    np.testing.assert_array_equal(STORE.indptr, jstore.indptr)
    assert (STORE.num_nodes, STORE.num_edges, STORE.feat,
            STORE.num_classes) == (jstore.num_nodes, jstore.num_edges,
                                   jstore.feat, jstore.num_classes)
    for d in range(G.num_nodes):
        expect = G.edge_index[0][G.edge_index[1] == d]
        np.testing.assert_array_equal(STORE.in_edges(d), expect)
        assert STORE.in_degree(d) == expect.size
    ids = np.array([0, 7, 99, 128, 255])
    a, b = STORE.gather_nodes(ids), jstore.gather_nodes(ids)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])


def test_inmemory_store_rejects_unsorted():
    bad = synth_graph("bad", 8, 16, feat=4, seed=0)
    ei = bad.edge_index.copy()
    ei[1] = ei[1][::-1]
    with pytest.raises(ValueError, match="sorted"):
        InMemoryStore(dataclasses.replace(bad, edge_index=ei))


@pytest.mark.parametrize("num_shards", [1, 3, 4])
def test_sharded_store_round_trip(tmp_path, num_shards):
    path = save_graph_shards(G, str(tmp_path / f"s{num_shards}"), num_shards)
    sg = ShardedGraphStore(path, cache_shards=2)
    assert (sg.num_nodes, sg.num_edges) == (G.num_nodes, G.num_edges)
    for d in [0, 1, 100, 200, G.num_nodes - 1]:
        np.testing.assert_array_equal(sg.in_edges(d), STORE.in_edges(d))
    ids = np.array([0, 7, 99, 128, 255])
    a, b = STORE.gather_nodes(ids), sg.gather_nodes(ids)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_sharded_store_is_actually_out_of_core(tmp_path):
    path = save_graph_shards(G, str(tmp_path / "ooc"), 4)
    assert len([f for f in os.listdir(path) if f.endswith(".npz")]) == 4
    sg = ShardedGraphStore(path, cache_shards=1)
    for d in range(0, G.num_nodes, 16):
        sg.in_edges(d)
    assert len(sg._lru) == 1
    assert sg.loads >= 4


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_shards_cross_read(tmp_path, writer):
    """A shard directory written by either package reads in the other,
    and both packages' samplers over it give bitwise the reference's
    in-memory batches."""
    path = str(tmp_path / writer)
    if writer == "port":
        save_graph_shards(G, path, 3)
    else:
        jsampling.save_graph_shards(JG, path, 3)
    ours = NeighborSampler(ShardedGraphStore(path, cache_shards=2),
                           fanouts=(4, 3), batch_size=16, seed=7)
    theirs = jsampling.NeighborSampler(
        jsampling.ShardedGraphStore(path, cache_shards=2), fanouts=(4, 3),
        batch_size=16, seed=7)
    want = jsampling.NeighborSampler(JG, fanouts=(4, 3), batch_size=16,
                                     seed=7)
    for step in range(4):
        _same(ours.sample_batch(step), want.sample_batch(step))
        _same(ours.sample_batch(step), theirs.sample_batch(step))


# ---------------------------------------------------------------------------
# the sampler, bitwise against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fanouts,exact", [
    ((4, 3), False), ((None, 3), False), ((2,), False),
    ((15, 10, 5), False), ((4, 4), True)])
def test_sampler_bitwise_matches_reference(fanouts, exact):
    ours = NeighborSampler(G, fanouts=fanouts, batch_size=16, seed=7,
                           exact=exact)
    theirs = jsampling.NeighborSampler(JG, fanouts=fanouts, batch_size=16,
                                       seed=7, exact=exact)
    assert ours.fanouts == theirs.fanouts and ours.exact == theirs.exact
    assert len(ours) == len(theirs)
    assert ours.max_sampled_shape() == theirs.max_sampled_shape()
    for step in [0, 1, 5, 17]:
        np.testing.assert_array_equal(ours.seeds_for(step),
                                      theirs.seeds_for(step))
        _same(ours.sample_batch(step), theirs.sample_batch(step))


def test_sampler_seed_subset_matches_reference():
    """Seeds drawn from a subset (the nodes with in-edges), a batch larger
    than the subset clamps to it."""
    seeds = np.unique(G.edge_index[1])
    for bs in (32, seeds.size + 10):
        ours = NeighborSampler(G, fanouts=(3, 2), batch_size=bs, seed=1,
                               seed_nodes=seeds)
        theirs = jsampling.NeighborSampler(JG, fanouts=(3, 2), batch_size=bs,
                                           seed=1, seed_nodes=seeds)
        assert ours.batch_size == theirs.batch_size
        for step in (0, 3):
            _same(ours.sample_batch(step), theirs.sample_batch(step))


@pytest.mark.parametrize("num_shards", [2, 5])
def test_sharded_sampler_matches_reference(tmp_path, num_shards):
    path = save_graph_shards(G, str(tmp_path / "eq"), num_shards)
    ours = NeighborSampler(ShardedGraphStore(path, cache_shards=2),
                           fanouts=(4, None), batch_size=16, seed=7)
    theirs = jsampling.NeighborSampler(JG, fanouts=(4, None), batch_size=16,
                                       seed=7)
    for step in range(4):
        _same(ours.sample_batch(step), theirs.sample_batch(step))


def test_subgraph_structure():
    s = NeighborSampler(G, fanouts=(4, 3), batch_size=16, seed=7)
    sub = s.sample_batch(0)
    assert sub.num_seeds == 16
    assert np.all(np.diff(sub.edge_index[1]) >= 0)
    np.testing.assert_array_equal(sub.seed_nodes, sub.node_ids[:16])
    np.testing.assert_array_equal(sub.x, G.x[sub.node_ids])
    np.testing.assert_array_equal(sub.deg_inv_sqrt,
                                  G.deg_inv_sqrt[sub.node_ids])
    counts = np.bincount(sub.edge_index[1], minlength=sub.num_nodes)
    assert counts[:16].max() <= 4
    gsrc = sub.node_ids[sub.edge_index[0]]
    gdst = sub.node_ids[sub.edge_index[1]]
    parent = set(zip(G.edge_index[0].tolist(), G.edge_index[1].tolist()))
    assert all((int(a), int(b)) in parent for a, b in zip(gsrc, gdst))


def test_sampler_determinism_under_threads():
    """The batch stream is a pure function of (seed, step): producing the
    same steps from many threads, in scrambled order, gives bitwise the
    reference's batches."""
    s = NeighborSampler(G, fanouts=(4, 3), batch_size=16, seed=7)
    ref = jsampling.NeighborSampler(JG, fanouts=(4, 3), batch_size=16,
                                    seed=7)
    results: dict = {}
    errors: list = []

    def worker(steps):
        try:
            for st in steps:
                results[st] = s.sample_batch(st)
        except Exception as e:                      # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(list(range(8))[i::4],))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errors
    for step in range(8):
        _same(results[step], ref.sample_batch(step))


def test_seed_epoch_coverage():
    s = NeighborSampler(G, fanouts=(2,), batch_size=64, seed=1)
    seen = np.concatenate([s.seeds_for(st) for st in range(len(s))])
    assert np.unique(seen).size == seen.size
    assert not np.array_equal(s.seeds_for(0), s.seeds_for(len(s)))


def test_sampler_rejects_bad_args():
    with pytest.raises(ValueError, match="fanout"):
        NeighborSampler(G, fanouts=(0,))
    with pytest.raises(ValueError, match="at least one hop"):
        NeighborSampler(G, fanouts=())
    with pytest.raises(ValueError, match="non-empty"):
        NeighborSampler(G, fanouts=(2,), seed_nodes=np.zeros(0, np.int64))
    s = NeighborSampler(G, fanouts=(2,), batch_size=4)
    with pytest.raises(ValueError, match="unique"):
        s.sample(np.array([1, 1]))
    with pytest.raises(ValueError, match="out of range"):
        s.sample(np.array([G.num_nodes]))


# ---------------------------------------------------------------------------
# empty neighbourhoods
# ---------------------------------------------------------------------------

def _isolated_nodes():
    iso = np.where(STORE.indptr[1:] == STORE.indptr[:-1])[0]
    assert iso.size > 0, "power-law synth graph should have isolated nodes"
    return iso


def test_empty_neighbourhood_yields_the_reference_subgraph():
    iso = _isolated_nodes()
    s = NeighborSampler(G, fanouts=(4, 4), batch_size=4, seed=0)
    sub = s.sample(iso[:3])
    assert sub.num_edges == 0
    assert sub.edge_index.shape == (2, 0)
    assert sub.edge_index.dtype == np.int32
    assert sub.num_nodes == 3 and sub.num_seeds == 3
    ref = jsampling.NeighborSampler(JG, fanouts=(4, 4), batch_size=4,
                                    seed=0).sample(iso[:3])
    _same(sub, ref)


def test_empty_neighbourhood_through_pad_and_stamped_forward():
    """Isolated seeds survive sampler → bucket pad → stamped plan →
    forward, with the logits of the plain forward without a plan."""
    iso = _isolated_nodes()
    sub = NeighborSampler(G, fanouts=(4, 4), batch_size=4, seed=0).sample(
        iso[:3])
    padded, bucket = pad_to_bucket(sub)
    entry = BucketEntry(bucket, 32, default_config(32))
    plan = entry.stamp(padded.edge_index[1])
    model = gnn.init("gcn", 16, 32, 8, num_layers=2, device="cpu")
    args = (torch.from_numpy(padded.x), torch.from_numpy(padded.edge_index),
            padded.num_nodes, torch.from_numpy(padded.deg_inv_sqrt))
    with torch.no_grad():
        out = model(*args, plan=plan, impl="blocked")
        ref = model(*args, impl="ref")
    np.testing.assert_allclose(out[:3].numpy(), ref[:3].numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# exact-neighbourhood parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["gcn", "sage", "gat"])
@pytest.mark.parametrize("depth", [1, 2])
def test_exact_sampled_forward_matches_full_graph(model, depth):
    """An exact depth-L subgraph reproduces the depth-L model's seed
    logits: every aggregation a seed's receptive field needs is whole, and
    the parent's deg_inv_sqrt makes GCN's weights the same."""
    net = gnn.init(model, 16, 32, 8, num_layers=depth,
                   heads=2 if model == "gat" else 1, device="cpu")

    def run(g):
        plan = make_graph_plan(g.edge_index, g.num_nodes, 32, device="cpu")
        with torch.no_grad():
            return net(torch.from_numpy(g.x), torch.from_numpy(g.edge_index),
                       g.num_nodes, torch.from_numpy(g.deg_inv_sqrt),
                       plan=plan).numpy()

    full = run(G)
    for batch, step, seed in [(1, 0, 0), (8, 3, 11), (12, 17, 12345)]:
        s = NeighborSampler(G, fanouts=(None,) * depth, exact=True,
                            batch_size=batch, seed=seed)
        sub = s.sample_batch(step)
        np.testing.assert_allclose(run(sub)[:sub.num_seeds],
                                   full[sub.seed_nodes], atol=1e-5,
                                   rtol=1e-5)

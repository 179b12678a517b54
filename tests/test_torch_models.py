"""The port's 3-layer models and serving engine on the CPU.

Each family with weights carried across from ``repro.models.gnn.init``
must compute the reference's ``impl="ref"`` forward within 1e-4: the two
packages may pick different transform/aggregate orders, which reassociates
the fp32 sums. The CPU server must return the direct forward per request
and build one cache entry per bucket; its batcher follows the reference's
admission rules (``tests/test_serve.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data.graphs import dataset as jdataset  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402

from repro_torch.data.graphs import dataset, synth_graph  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.models.params import from_jax_params  # noqa: E402
from repro_torch.serve import (BucketPolicy, GNNServer, GraphBatcher,  # noqa: E402
                               GraphRequest)

MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _jax_layers(params):
    return [{k: np.asarray(p.value) for k, p in lay.items()} for lay in params]


def _inputs(g):
    return (torch.from_numpy(g.x), torch.from_numpy(g.edge_index),
            torch.from_numpy(g.deg_inv_sqrt))


@pytest.mark.parametrize("family", gnn.MODELS)
def test_forward_matches_reference_with_carried_weights(family):
    heads = 2 if family == "gat" else 1
    jg = jdataset("cora", feat=32, scale=0.05)
    params = jgnn.init(jax.random.PRNGKey(0), family, 32, 64, 16, heads=heads)
    want = jgnn.forward(params, family, jnp.asarray(jg.x),
                        jnp.asarray(jg.edge_index), jg.num_nodes,
                        jnp.asarray(jg.deg_inv_sqrt), impl="ref")
    model = from_jax_params(family, _jax_layers(params))
    assert model.dims == [32, 64, 64, 16]
    g = dataset("cora", feat=32, scale=0.05)
    x, ei, dis = _inputs(g)
    with torch.no_grad():
        got = gnn.forward(model, x, ei, g.num_nodes, dis)
    assert got.shape == (g.num_nodes, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_from_jax_params_rejects_bad_shapes():
    params = _jax_layers(jgnn.init(jax.random.PRNGKey(1), "gcn", 8, 16, 4))
    params[1]["b"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        from_jax_params("gcn", params)


def test_init_is_seeded_and_forward_only():
    a = gnn.init("gat", 8, 16, 4, heads=2, seed=3, device="cpu")
    b = gnn.init("gat", 8, 16, 4, heads=2, seed=3, device="cpu")
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    g = synth_graph("g", 40, 120, feat=8, seed=0)
    x, ei, dis = _inputs(g)
    y = a(x, ei, g.num_nodes, dis)
    # the ops are differentiable now: every parameter gets a gradient
    y.sum().backward()
    for name, p in a.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name


# ---------------------------------------------------------------------------
# serving on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", gnn.MODELS)
def test_server_matches_direct_forward(family):
    model = gnn.init(family, 8, 16, 4, heads=2 if family == "gat" else 1,
                     device="cpu")
    srv = GNNServer(model, family, device="cpu",
                    policy=BucketPolicy(min_nodes=32, min_edges=32),
                    max_batch_nodes=128, max_batch_graphs=3)
    rng = np.random.default_rng(0)
    graphs = [synth_graph(f"g{i}", int(rng.integers(16, 100)),
                          int(rng.integers(20, 250)), feat=8, seed=i)
              for i in range(6)]
    for g in graphs:
        srv.submit(g)
    srv.run_until_drained()
    s = srv.stats()
    assert s["requests"] == 6 and len(srv.results) == 6
    assert s["builds"] == s["buckets"] == s["cache"]["plan_builds"]
    assert s["cache"]["hits"] + s["cache"]["misses"] == 6
    for uid, g in enumerate(graphs):
        x, ei, dis = _inputs(g)
        with torch.no_grad():
            want = gnn.forward(model, x, ei, g.num_nodes, dis)
        res = srv.results[uid]
        assert res.logits.shape == (g.num_nodes, 4)
        np.testing.assert_allclose(res.logits, want.numpy(), rtol=1e-5,
                                   atol=1e-5)
        assert res.latency_s >= res.serve_s
        assert res.fusion and all(k.startswith("unfused:")
                                  for k in res.fusion)
        assert set(res.stages) == {"batch", "pad", "cache", "stamp", "copy",
                                   "forward", "fetch"}
        assert 0 <= sum(res.stages.values()) <= res.serve_s


def test_server_cache_hit_builds_nothing():
    model = gnn.init("gin", 8, 16, 4, device="cpu")
    srv = GNNServer(model, "gin", device="cpu",
                    policy=BucketPolicy(min_nodes=32, min_edges=32))
    srv.submit(synth_graph("a", 30, 60, feat=8, seed=0))
    (first,) = srv.step(flush=True)
    srv.submit(synth_graph("b", 25, 50, feat=8, seed=1))  # same bucket
    (second,) = srv.step(flush=True)
    assert first.built and not first.cache_hit
    assert second.cache_hit and not second.built
    assert srv.stats()["builds"] == 1 and srv.cache.stats.hits == 1


def test_server_warmup_reset_and_stats():
    srv = GNNServer(gnn.init("sage", 8, 16, 4, device="cpu"), "sage",
                    device="cpu",
                    policy=BucketPolicy(min_nodes=32, min_edges=32),
                    max_batch_graphs=1)
    assert srv.stats()["throughput_rps"] == 0.0
    assert srv.stats()["pad_node_overhead"] == 1.0
    from repro_torch.serve import ShapeBucket
    buckets = [ShapeBucket(32, 64), ShapeBucket(64, 256)]
    assert srv.warmup(buckets) == 2
    assert srv.warmup(buckets) == 0
    assert srv.cache.stats.misses == 0 and srv.cache.stats.prefills == 2
    srv.submit(synth_graph("g", 20, 40, feat=8, seed=0))
    (res,) = srv.step(flush=True)
    assert res.cache_hit and res.bucket == ShapeBucket(32, 64)
    srv.reset()
    assert srv.stats()["requests"] == 0 and len(srv.cache) == 2


def test_server_needs_a_card_unless_cpu_is_asked_for():
    model = gnn.init("gcn", 8, 16, 4, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        GNNServer(model, "gcn")
    with pytest.raises(ValueError, match="family"):
        GNNServer(model, "gat", device="cpu")
    srv = GNNServer(model, "gcn", device="cpu")
    with pytest.raises(ValueError, match="duplicate"):
        srv.submit(synth_graph("a", 8, 8, feat=8), uid=0)
        srv.submit(synth_graph("b", 8, 8, feat=8), uid=0)


# ---------------------------------------------------------------------------
# batcher: the admission rules of the reference (tests/test_serve.py)
# ---------------------------------------------------------------------------

def _req(uid, v, e, t=0.0):
    return GraphRequest(uid=uid, graph=synth_graph(f"r{uid}", v, e, feat=4,
                                                   seed=uid), t_submit=t)


def test_batcher_budget_and_fifo():
    b = GraphBatcher(max_batch_nodes=100, max_batch_graphs=8)
    for uid, v in enumerate([40, 40, 40, 10]):
        b.submit(_req(uid, v, 2 * v))
    assert [r.uid for r in b.next_batch(now=0.0)] == [0, 1]
    assert [r.uid for r in b.next_batch(now=0.0)] == [2, 3]
    assert b.next_batch(now=0.0) == []


def test_batcher_oversize_singleton():
    b = GraphBatcher(max_batch_nodes=50)
    b.submit(_req(0, 200, 300))
    assert [r.uid for r in b.next_batch(now=0.0)] == [0]


def test_batcher_edge_budget():
    b = GraphBatcher(max_batch_nodes=1000, max_batch_edges=100)
    b.submit(_req(0, 10, 80))
    b.submit(_req(1, 10, 80))
    assert [r.uid for r in b.next_batch(now=0.0)] == [0]


def test_batcher_deadline_holds_then_releases():
    b = GraphBatcher(max_batch_nodes=1000, max_batch_graphs=8,
                     max_wait_s=10.0)
    b.submit(_req(0, 10, 20, t=100.0))
    assert b.next_batch(now=100.1) == []
    assert len(b.queue) == 1
    assert [r.uid for r in b.next_batch(now=110.1)] == [0]
    b.submit(_req(1, 10, 20, t=200.0))
    assert [r.uid for r in b.next_batch(now=200.0, flush=True)] == [1]


def test_batcher_saturated_batch_releases_with_empty_queue():
    b = GraphBatcher(max_batch_nodes=1000, max_batch_graphs=2,
                     max_wait_s=60.0)
    b.submit(_req(0, 10, 20, t=0.0))
    b.submit(_req(1, 10, 20, t=0.0))
    assert [r.uid for r in b.next_batch(now=0.1)] == [0, 1]


def test_batcher_releases_when_budget_full():
    b = GraphBatcher(max_batch_nodes=50, max_wait_s=1e9)
    b.submit(_req(0, 40, 60, t=0.0))
    b.submit(_req(1, 40, 60, t=0.0))
    assert [r.uid for r in b.next_batch(now=0.0)] == [0]

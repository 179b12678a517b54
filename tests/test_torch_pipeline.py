"""The port's out-of-core pipeline on the CPU, against the reference's,
following ``tests/test_pipeline.py``: the producer's padded graph, label
mask and stamped plan; prefetch depth and thread invariance; the plan
cache under concurrent producers; sampled training through
``repro_torch.fit`` against ``repro.fit``; and ``GNNServer`` sampled
ingest against the reference's.

Tolerances: the batches are bitwise the reference's (numpy on the host).
A 5-step sampled gcn trajectory from one carried-over state: losses within
rtol 1e-4 (both sum in fp32 in their own orders, and five AdamW steps
amplify the last bits, as ``tests/test_torch_train.py``). Served logits:
atol 1e-5 against the reference's ``impl="ref"`` forward.
"""
import ctypes
import dataclasses
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro  # noqa: E402
from repro import train as jtrain  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.data import sampling as jsampling  # noqa: E402
from repro.data.graphs import synth_graph as jsynth_graph  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch import train  # noqa: E402
from repro_torch.core.config_space import default_config  # noqa: E402
from repro_torch.data.graphs import synth_graph  # noqa: E402
from repro_torch.data.pipeline import (PrefetchPipeline, SampledBatch,  # noqa: E402
                                       SampledBatchProducer)
from repro_torch.data.sampling import NeighborSampler  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.models.params import from_jax_params, from_jax_state  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve import GNNServer, PlanCache  # noqa: E402
from repro_torch.serve.buckets import ShapeBucket  # noqa: E402
from repro_torch.serve.plan_cache import BucketEntry  # noqa: E402

G = synth_graph("pipe", 256, 1024, feat=16, num_classes=8, seed=3)
JG = jsynth_graph("pipe", 256, 1024, feat=16, num_classes=8, seed=3)
KEY = jax.random.PRNGKey(0)
ARRAYS = ("x", "edge_index", "deg_inv_sqrt", "labels", "label_mask")


def _sampler(**kw):
    kw.setdefault("fanouts", (4, 3))
    kw.setdefault("batch_size", 16)
    kw.setdefault("seed", 7)
    return NeighborSampler(G, **kw)


def _jsampler(**kw):
    kw.setdefault("fanouts", (4, 3))
    kw.setdefault("batch_size", 16)
    kw.setdefault("seed", 7)
    return jsampling.NeighborSampler(JG, **kw)


def _producer(**kw):
    kw.setdefault("feat", 32)
    return SampledBatchProducer(_sampler(), device="cpu", **kw)


def _equal_batches(a, b):
    assert a.step == b.step and a.bucket == b.bucket
    assert a.num_seeds == b.num_seeds
    for k in ARRAYS:
        assert torch.equal(a.arrays[k], b.arrays[k]), k
    assert torch.equal(a.plan.row_ptr, b.plan.row_ptr)
    for f in ("perm", "src", "dst", "row_ptr"):
        assert torch.equal(getattr(a.plan.src_order, f),
                           getattr(b.plan.src_order, f)), f


# ---------------------------------------------------------------------------
# producer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 3])
def test_producer_batch_matches_reference_producer(step):
    """The padded graph, label mask, bucket and seeds are bitwise the
    reference producer's; the stamped plan's row offsets are those of its
    padded destinations; the source order is
    the stable sort of its real edges by source."""
    prod = _producer()
    b = prod.produce(step)
    want = jpipeline.SampledBatchProducer(_jsampler(), feat=32).produce(step)
    assert isinstance(b, SampledBatch)
    assert (b.bucket.num_nodes, b.bucket.num_edges) == (
        want.bucket.num_nodes, want.bucket.num_edges)
    assert b.num_seeds == want.num_seeds
    np.testing.assert_array_equal(b.seed_nodes, want.seed_nodes)
    for f in ("x", "edge_index", "deg_inv_sqrt", "labels"):
        np.testing.assert_array_equal(getattr(b.graph, f),
                                      getattr(want.graph, f), err_msg=f)
        np.testing.assert_array_equal(b.arrays[f].numpy(),
                                      np.asarray(want.arrays[f]), err_msg=f)
    assert b.arrays["labels"].dtype == torch.int64
    np.testing.assert_array_equal(b.arrays["label_mask"].numpy(),
                                  np.asarray(want.arrays["label_mask"]))
    v, e = b.bucket.num_nodes, b.bucket.num_edges
    dst = want.graph.edge_index[1]
    np.testing.assert_array_equal(
        b.plan.row_ptr.numpy(), np.searchsorted(dst, np.arange(v + 1)))
    assert b.plan.row_ptr.dtype == torch.int64 and b.plan.num_rows == e
    real = int(np.sum(dst < v))
    order = b.plan.src_order
    assert order.num_real == real == b.graph.orig_num_edges
    src = want.graph.edge_index[0]
    perm = np.argsort(np.where(dst < v, src, v), kind="stable")
    np.testing.assert_array_equal(order.perm.numpy(), perm)
    # the plan carries the bucket entry's static fields
    entry = prod.entry_for(b.bucket)
    assert b.entry is entry
    assert b.plan.config == entry.config
    assert b.plan.stats == entry.template.stats


def test_same_bucket_batches_share_one_entry():
    prod = _producer()
    batches = [prod.produce(s) for s in range(6)]
    by_bucket: dict = {}
    for b in batches:
        by_bucket.setdefault(b.bucket, []).append(b)
    assert any(len(v) > 1 for v in by_bucket.values())
    for group in by_bucket.values():
        assert all(b.entry is group[0].entry for b in group)
    assert prod.cache.stats.plan_builds == len(by_bucket)
    want = jpipeline.SampledBatchProducer(_jsampler(), feat=32)
    assert [(b.num_nodes, b.num_edges) for b in prod.buckets_for_warmup(6)] \
        == [(b.num_nodes, b.num_edges) for b in want.buckets_for_warmup(6)]


# ---------------------------------------------------------------------------
# prefetch pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth,threads", [(1, 1), (2, 2), (3, 4)])
def test_prefetch_equals_blocking(depth, threads):
    ref = [_producer().produce(s) for s in range(6)]
    with PrefetchPipeline(_producer(), depth=depth,
                          num_threads=threads) as pipe:
        for s in range(6):
            _equal_batches(pipe.batch(s), ref[s])
        stats = pipe.stats()
        assert stats["batches"] == 6
        assert stats["sync_falls"] == 1          # cold start only


def test_prefetch_random_access_falls_back():
    with PrefetchPipeline(_producer(), depth=2) as pipe:
        pipe.batch(0)
        b = pipe.batch(10)                       # out of window: sync
        assert b.step == 10
        assert pipe.sync_falls == 2
        _equal_batches(b, _producer().produce(10))


def test_pipeline_close_is_idempotent_and_final():
    pipe = PrefetchPipeline(_producer(), depth=2)
    pipe.batch(0)
    pipe.close()
    pipe.close()
    with pytest.raises(RuntimeError, match="closed"):
        pipe.batch(1)


def test_depth0_is_blocking():
    with PrefetchPipeline(_producer(), depth=0) as pipe:
        assert pipe._pool is None
        b = pipe.batch(0)
        assert b.wait_s >= b.produce_s * 0.5     # nothing hidden
        assert pipe.stats()["overlap"] <= 0.5
        assert b.event is None and b.ready() is b    # no streams on the CPU


# ---------------------------------------------------------------------------
# plan cache under concurrent producers
# ---------------------------------------------------------------------------

def _entry(b):
    return BucketEntry(b, 64, default_config(64))


def test_plan_cache_concurrent_get_or_build():
    """16 threads racing on 4 keys, with a short switch interval, build each
    entry once and lose no counter increment."""
    cache = PlanCache(capacity=32)
    buckets = [ShapeBucket(64 << i, 256 << i) for i in range(4)]
    built: dict = {}
    lock = threading.Lock()

    def hammer(tid):
        for i in range(40):
            b = buckets[(tid + i) % len(buckets)]
            e = cache.get_or_build(b, lambda b=b: _entry(b))
            with lock:
                prev = built.setdefault(b, e)
            assert prev is e, "two threads built the same key"

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=16) as pool:
            for fut in [pool.submit(hammer, t) for t in range(16)]:
                fut.result(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert cache.stats.plan_builds == len(buckets)
    assert cache.stats.misses == len(buckets)
    assert cache.stats.lookups == 16 * 40
    assert len(cache) == len(buckets)


def test_plan_cache_concurrent_eviction_consistency():
    cache = PlanCache(capacity=2)

    def hammer(tid):
        for i in range(60):
            cache.get_or_build((tid + i) % 5,
                               lambda: _entry(ShapeBucket(64, 256)))

    with ThreadPoolExecutor(max_workers=6) as pool:
        for fut in [pool.submit(hammer, t) for t in range(6)]:
            fut.result(timeout=120)
    assert len(cache) == 2
    s = cache.stats
    assert s.evictions == s.plan_builds - len(cache)
    assert s.hits + s.misses == 6 * 60


def test_kernel_library_loads_once_from_many_threads(monkeypatch):
    """A kernel's first use may now come from several threads: its library
    is built and loaded once."""
    calls = []

    class FakeLib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    def fake_build(names=(), only=None):
        calls.append(tuple(only))
        return {u: f"/nonexistent/{u[0]}.so" for u in only}

    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: FakeLib())
    with ThreadPoolExecutor(max_workers=8) as pool:
        libs = [f.result(timeout=60) for f in
                [pool.submit(_build.load, "sddmm") for _ in range(32)]]
    assert calls == [(("sddmm", None),)]
    assert all(lib is libs[0] for lib in libs)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _providers(steps=5, seed=5):
    kw = dict(fanouts=(4, 3), batch_size=32, plan_feat=64, depth=2,
              seed=seed)
    return (jtrain.SampledNodeProvider(JG, **kw),
            train.SampledNodeProvider(G, device="cpu", **kw))


def test_sampled_fit_trajectory_matches_reference():
    """5 sampled gcn steps through repro_torch.fit against repro.fit at
    impl='ref', from the reference's initial state carried over."""
    cfg = dict(steps=5, warmup_steps=2, seed=0)
    opt = dict(lr=1e-2, weight_decay=0.01)
    jd, td = _providers()
    with jd, td:
        jt = jtrain.Trainer(
            jtrain.NodeClassification.from_provider(jd, model="gcn",
                                                    hidden=32, impl="ref"),
            jd, jtrain.TrainerConfig(opt=jadamw.AdamWConfig(**opt), **cfg))
        tt = train.Trainer(
            train.NodeClassification.from_provider(td, model="gcn",
                                                   hidden=32, device="cpu"),
            td, train.TrainerConfig(opt=adamw.AdamWConfig(**opt), **cfg))
        jstate = jt.init_state()
        want = jt.fit(state=jstate)
        got = tt.fit(state=from_jax_state("gcn", jstate, device="cpu"))
        np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
        assert len(got.buckets) == len(want.buckets)
        assert all(s.sampled for s in got.buckets)
        stats = td.stats()
        assert stats["batches"] == 5
        assert stats["cache"]["plan_builds"] == len(got.buckets)
        assert tt.steps == 5 and np.all(np.isfinite(got.losses))


def test_sampled_loss_ignores_non_seed_rows():
    """The masked loss reads the seed rows only: perturbing a neighbour
    row's label changes neither the loss, nor the accuracy, nor the
    gradients."""
    task = train.NodeClassification(model="gcn", d_in=16, hidden=32,
                                    num_classes=8, num_layers=2,
                                    device="cpu")
    params = task.init(torch.Generator().manual_seed(0))
    b = _producer().produce(0)
    arrays, static = task.prepare(b)
    assert static.sampled
    loss1, m1 = task.loss(params, arrays, static)
    labels = arrays["labels"].clone()
    labels[b.num_seeds:] = (labels[b.num_seeds:] + 1) % 8
    loss2, m2 = task.loss(params, dict(arrays, labels=labels), static)
    assert float(loss1.detach()) == float(loss2.detach())
    assert float(m1["accuracy"]) == float(m2["accuracy"])
    g1 = torch.autograd.grad(loss1, list(params.values()))
    g2 = torch.autograd.grad(loss2, list(params.values()))
    assert all(torch.equal(a, c) for a, c in zip(g1, g2))
    # and it is the reference's masked loss on the same batch
    jtask = jtrain.NodeClassification(model="gcn", d_in=16, hidden=32,
                                      num_classes=8, num_layers=2,
                                      impl="ref")
    jparams = jtask.init(KEY)
    jb = jpipeline.SampledBatchProducer(_jsampler(), feat=32).produce(0)
    jarrays, jstatic = jtask.prepare(jb)
    model = from_jax_params("gcn", [{k: np.asarray(p.value)
                                     for k, p in lay.items()}
                                    for lay in jparams])
    tparams = {k: p.detach() for k, p in model.named_parameters()}
    got, gm = task.loss(tparams, arrays, static)
    want, wm = jtask.loss(jparams, jarrays, jstatic, KEY)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(gm["accuracy"]), float(wm["accuracy"]),
                               rtol=1e-6)


def test_sampled_rejects_typed_models_and_foreign_devices():
    b = _producer().produce(0)
    task = train.NodeClassification(model="rgcn", d_in=16, num_classes=8,
                                    device="cpu")
    with pytest.raises(ValueError, match="relational"):
        task.prepare(b)
    moved = dataclasses.replace(b, arrays=dict(b.arrays,
                                               x=b.arrays["x"].to("meta")))
    task = train.NodeClassification(model="gcn", d_in=16, num_classes=8,
                                    device="cpu")
    with pytest.raises(ValueError, match="lies on"):
        task.prepare(moved)


def test_sampled_entry_points_run_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        SampledBatchProducer(_sampler())
    with pytest.raises(RuntimeError, match="CUDA"):
        train.SampledNodeProvider(G)
    with pytest.raises(RuntimeError, match="CUDA"):
        GNNServer(gnn.init("gcn", 16, 32, 8, device="cpu"), "gcn")
    srv = GNNServer(gnn.init("gcn", 16, 32, 8, device="cpu"), "gcn",
                    device="cpu")
    with srv.sampled_pipeline(_sampler(), depth=0) as pipe:
        assert pipe.batch(0).arrays["x"].device.type == "cpu"


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _servers():
    jparams = jgnn.init(KEY, "gcn", 16, 32, 8, num_layers=2)
    model = from_jax_params("gcn", [{k: np.asarray(p.value)
                                     for k, p in lay.items()}
                                    for lay in jparams])
    return (repro.GNNServer(jparams, "gcn", impl="ref", feat=32),
            GNNServer(model, "gcn", device="cpu"))


def test_serve_sampled_matches_reference_and_builds_once_per_bucket():
    jsrv, srv = _servers()
    with jsrv.sampled_pipeline(_jsampler(), depth=2) as jpipe, \
            srv.sampled_pipeline(_sampler(), depth=2) as pipe:
        for step in range(6):
            b = pipe.batch(step)
            got = srv.serve_sampled(b)
            want = jsrv.serve_sampled(jpipe.batch(step))
            assert got.shape == (b.num_seeds, 8)
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert srv.stats()["builds"] == len(srv.cache) == srv.builds
    assert srv.stats()["batches"] == 6


def test_serve_sampled_foreign_batch_restamps():
    """A batch stamped against another cache's entry is re-stamped under
    the engine's, with no new build, and gives the same logits."""
    _, srv = _servers()
    with srv.sampled_pipeline(_sampler(), depth=0) as pipe:
        own = srv.serve_sampled(pipe.batch(0))
    builds = srv.builds
    foreign = _producer(feat=128).produce(0)
    rt.obs.reset_spans()
    got = srv.serve_sampled(foreign)
    assert srv.builds == builds
    root = rt.obs.spans("serve.step")[-1]
    assert root.find("serve.stamp").attrs == {"restamp": True}
    np.testing.assert_array_equal(got, own)

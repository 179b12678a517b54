"""The port's telemetry (``repro_torch.obs``) on the CPU, following
``tests/test_obs.py``: registry semantics, percentiles, snapshot/delta,
disabled mode, the JSON-lines and Prometheus formats, Chrome traces,
span trees (thread-isolated), build attribution, the launch mirror, the
engine's cold and reset stats, and the exported schema pinned exactly to
the table documented in ``repro_torch/obs/__init__.py`` — the reference's
schema under its renames."""
import json
import re
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch import train  # noqa: E402
from repro_torch.data.graphs import synth_graph  # noqa: E402
from repro_torch.data.pipeline import (PrefetchPipeline,  # noqa: E402
                                       SampledBatchProducer)
from repro_torch.data.sampling import NeighborSampler  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.obs.registry import MetricsRegistry  # noqa: E402
from repro_torch.serve import GNNServer, bucket_for  # noqa: E402

SERVE_STAGES = {"serve.batch", "serve.pad", "serve.plan_cache", "serve.copy",
                "serve.stamp", "serve.execute", "serve.fetch"}


@pytest.fixture(autouse=True)
def clean_obs():
    """Every test starts enabled with a zeroed registry, span ring and
    event ring, and leaves the switch enabled for the next test."""
    obs.enable()
    obs.reset()
    yield
    obs.enable()


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_counter_gauge_labels_and_values():
    reg = MetricsRegistry()
    c = reg.counter("t.count", ("who",))
    c.inc(who="a")
    c.inc(2.5, who="a")
    c.inc(who="b")
    assert c.value(who="a") == 3.5
    assert c.value(who="b") == 1.0
    assert c.value(who="nobody") == 0.0
    g = reg.gauge("t.level", ())
    g.set(7)
    g.set(3)
    assert g.value() == 3.0


def test_registration_idempotent_and_mismatch_raises():
    reg = MetricsRegistry()
    a = reg.counter("t.c", ("x",))
    assert reg.counter("t.c", ("x",)) is a
    with pytest.raises(ValueError):
        reg.gauge("t.c", ("x",))
    with pytest.raises(ValueError):
        reg.counter("t.c", ("y",))
    with pytest.raises(ValueError):
        a.inc(y=1)


def test_histogram_exact_percentiles_and_buckets():
    reg = MetricsRegistry()
    h = reg.histogram("t.lat", (), buckets=(10.0, 50.0, 100.0))
    for v in range(1, 101):
        h.observe(float(v))
    assert h.count() == 100
    assert h.total() == sum(range(1, 101))
    assert h.percentile(50) == 50.0
    assert h.percentile(95) == 95.0
    assert h.percentile(99) == 99.0
    assert h.series().counts == [10, 40, 50, 0]


def test_snapshot_and_delta():
    reg = MetricsRegistry()
    c = reg.counter("t.c", ("k",))
    h = reg.histogram("t.h", ())
    c.inc(3, k="a")
    h.observe(1.0)
    snap = reg.snapshot()
    assert {r["name"] for r in snap} == {"t.c", "t.h"}
    hist_row = next(r for r in snap if r["name"] == "t.h")
    assert hist_row["count"] == 1 and "p95" in hist_row
    c.inc(2, k="a")
    h.observe(4.0)
    d = {r["name"]: r for r in reg.delta(snap)}
    assert d["t.c"]["value"] == 2.0
    assert d["t.h"]["count"] == 1 and d["t.h"]["sum"] == 4.0


def test_reset_keeps_instrument_handles():
    reg = MetricsRegistry()
    c = reg.counter("t.c", ())
    c.inc(5)
    reg.reset()
    assert c.value() == 0.0
    c.inc()
    assert c.value() == 1.0


def test_disabled_mode_vital_vs_optional():
    reg = MetricsRegistry()
    vital = reg.counter("t.vital", (), vital=True)
    opt = reg.counter("t.opt", ())
    obs.disable()
    try:
        vital.inc()
        opt.inc()
        with obs.span("t.stage") as s:
            s.set(ignored=True)
        obs.record_build("t.site", "t.cause")
        assert vital.value() == 1.0
        assert opt.value() == 0.0
        assert obs.spans("t.stage") == []
        assert obs.why_built() == []
    finally:
        obs.enable()


def test_port_registry_is_its_own():
    """The port keeps its own copy of the reference's obs: two registries,
    two switches."""
    assert obs.get_registry() is not repro.obs.get_registry()
    repro.obs.disable()
    try:
        assert obs.enabled()
    finally:
        repro.obs.enable()


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def test_jsonl_export_parses_and_stamps():
    reg = MetricsRegistry()
    reg.counter("t.c", ("k",)).inc(k="a")
    rows = [json.loads(ln) for ln in obs.to_jsonl(reg).splitlines()]
    kinds = [r["record"] for r in rows]
    assert "metric" in kinds and kinds[-1] == "meta"
    m = next(r for r in rows if r["record"] == "metric")
    assert m["name"] == "t.c" and m["labels"] == {"k": "a"}


def test_prometheus_export_format():
    reg = MetricsRegistry()
    reg.counter("serve.plan_cache.hits", ("cache",)).inc(5, cache="c0")
    reg.histogram("t.lat", (), buckets=(1.0, 2.0)).observe(1.5)
    text = obs.to_prometheus(reg)
    assert 'repro_serve_plan_cache_hits{cache="c0"} 5.0' in text
    assert "# TYPE repro_serve_plan_cache_hits counter" in text
    assert 'repro_t_lat_bucket{le="2.0"} 1' in text
    assert "repro_t_lat_count 1" in text
    # the reference's exporter writes the same text for the same series
    jreg = repro.obs.MetricsRegistry()
    jreg.counter("serve.plan_cache.hits", ("cache",)).inc(5, cache="c0")
    jreg.histogram("t.lat", (), buckets=(1.0, 2.0)).observe(1.5)
    assert text == repro.obs.to_prometheus(jreg)


def test_write_jsonl_atomic_and_flusher(tmp_path):
    path = str(tmp_path / "metrics.jsonl")
    obs.get_registry().counter("t.flush", (), vital=True).inc()
    obs.start_flusher(path, every_s=3600)
    obs.stop_flusher()
    rows = [json.loads(ln) for ln in open(path).read().splitlines()]
    assert any(r.get("name") == "t.flush" for r in rows)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def test_span_tree_nesting_and_ring():
    with obs.span("root", step=1) as r:
        with obs.span("child.a"):
            with obs.span("leaf"):
                pass
        with obs.span("child.b"):
            pass
    roots = obs.spans("root")
    assert len(roots) == 1 and roots[0] is r
    assert r.stages() == {"root", "child.a", "leaf", "child.b"}
    assert r.find("leaf").name == "leaf"
    assert [c.name for c in r.children] == ["child.a", "child.b"]
    assert r.dur_s >= r.children[0].dur_s >= 0.0
    assert r.attrs == {"step": 1}


def test_thread_span_trees_do_not_interleave():
    def worker():
        with obs.span("worker.root"):
            with obs.span("worker.leaf"):
                pass

    with obs.span("main.root"):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert obs.spans("main.root")[0].stages() == {"main.root"}
    assert obs.spans("worker.root")[0].stages() == {"worker.root",
                                                    "worker.leaf"}


def test_chrome_trace_export_valid():
    with obs.span("outer", bucket="V64xE128"):
        with obs.span("inner"):
            pass
    doc = obs.chrome_trace()
    json.dumps(doc)
    events = doc["traceEvents"]
    assert {e["name"] for e in events} == {"outer", "inner"}
    for e in events:
        assert e["ph"] == "X"
        assert isinstance(e["ts"], float) and isinstance(e["dur"], float)
    outer = next(e for e in events if e["name"] == "outer")
    assert outer["args"]["bucket"] == "V64xE128"


# ---------------------------------------------------------------------------
# attribution
# ---------------------------------------------------------------------------

def test_attribution_records_and_counters():
    obs.record_build("serve.forward", "bucket_miss", bucket="V64xE128")
    obs.record_build("train.step", "new_bucket", static="sig")
    obs.record_cache_event("cache9", "miss", key="k")
    obs.record_probe("pipeline.warmup_probe", "V64xE64", step=3)
    obs.record_tune("segment_reduce", cache_hit=False, timings=3, key="k")
    obs.record_tune("segment_reduce", cache_hit=True, key="k")
    builds = obs.why_built()
    assert [e["cause"] for e in builds] == ["bucket_miss", "new_bucket"]
    assert builds[0]["bucket"] == "V64xE128"
    assert obs.get_registry().get("build.events").value(
        site="serve.forward", cause="bucket_miss") == 1.0
    assert obs.attributions("cache")[0]["site"] == "plan_cache:cache9"
    assert obs.attributions("probe")[0]["step"] == 3
    tunes = obs.attributions("tune")
    assert [(e["cause"], e["timings"]) for e in tunes] == [("sweep", 3),
                                                          ("hit", 0)]
    assert obs.get_registry().get("autotune.tunes").value(
        op="segment_reduce", outcome="sweep") == 1.0
    assert not hasattr(obs, "record_compile")


# ---------------------------------------------------------------------------
# launch accounting: thread-safe, thread-scoped, mirrored
# ---------------------------------------------------------------------------

def test_fusion_account_concurrent_no_lost_updates():
    key = "fused:concurrency_test"
    before = kops.fusion_counts().get(key, 0)
    n_threads, per_thread = 8, 200

    def hammer():
        for _ in range(per_thread):
            kops.account("fused", "concurrency_test")

    threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert kops.fusion_counts()[key] - before == n_threads * per_thread
    assert obs.get_registry().get("kernel.launches").value(
        kind="fused", op="concurrency_test") == n_threads * per_thread


def test_fusion_scope_isolated_from_other_threads():
    """A scope opened in one thread never captures launches accounted from
    other threads (prefetch producers): they fold into the global."""
    before = kops.fusion_counts()
    started, release = threading.Event(), threading.Event()

    def producer():
        started.set()
        release.wait(timeout=5)
        kops.account("fused", "producer_op")

    t = threading.Thread(target=producer)
    t.start()
    started.wait(timeout=5)
    with kops.fusion_scope() as mine:
        kops.account("fused", "my_op")
        release.set()
        t.join(timeout=30)
        assert not t.is_alive()
        assert dict(mine) == {"fused:my_op": 1}
    after = kops.fusion_counts()
    for k in ("fused:producer_op", "fused:my_op"):
        assert after[k] - before.get(k, 0) == 1


def test_fusion_launches_mirrored_to_registry():
    reg = obs.get_registry()
    kops.account("fused", "mirror_test")
    assert reg.get("kernel.launches").value(kind="fused",
                                            op="mirror_test") == 1.0
    obs.disable()
    try:
        kops.account("fused", "mirror_test")   # the mirror is optional
    finally:
        obs.enable()
    assert reg.get("kernel.launches").value(kind="fused",
                                            op="mirror_test") == 1.0


def test_launch_mirror_equals_fusion_accounting_over_training():
    """Over a sampled training run (forward and backward, the backward's
    ops recorded in their forward's scope), the registry's kernel.launches
    equals the fusion accounting."""
    g = synth_graph("ooc", 128, 512, feat=8, num_classes=4)
    with train.SampledNodeProvider(g, fanouts=(4, 3), batch_size=8,
                                   plan_feat=16, device="cpu") as data:
        task = train.NodeClassification.from_provider(
            data, model="gat", hidden=16, heads=2, device="cpu")
        snap = obs.get_registry().snapshot()
        with kops.fusion_scope() as fusion:
            train.fit(task, data, train.TrainerConfig(steps=3))
    delta = {f"{r['labels']['kind']}:{r['labels']['op']}": r["value"]
             for r in obs.get_registry().delta(snap)
             if r["name"] == "kernel.launches" and r["value"]}
    assert delta == dict(fusion) and fusion


# ---------------------------------------------------------------------------
# the engine's stats on the registry
# ---------------------------------------------------------------------------

def _tiny_server(**kw):
    return GNNServer(gnn.init("gcn", 8, 16, 4, device="cpu"), "gcn",
                     device="cpu", **kw)


def test_server_cold_stats_well_defined():
    st = _tiny_server().stats()
    assert st["requests"] == 0 and st["batches"] == 0
    assert st["builds"] == 0 and st["buckets"] == 0
    assert st["mean_batch_size"] == 0.0
    assert st["throughput_rps"] == 0.0
    assert st["latency_mean_s"] == 0.0 and st["latency_p95_s"] == 0.0
    assert st["pad_node_overhead"] == 1.0
    assert st["pad_edge_overhead"] == 1.0
    assert st["cache"]["hit_rate"] == 0.0
    for v in st.values():
        if isinstance(v, float):
            assert np.isfinite(v)


def test_server_reset_returns_to_cold_window():
    srv = _tiny_server(max_batch_graphs=4)
    for i in range(4):
        srv.submit(synth_graph(f"g{i}", 16, 48, feat=8))
    srv.run_until_drained()
    busy = srv.stats()
    assert busy["requests"] == 4 and busy["batches"] >= 1
    assert busy["builds"] >= 1
    kept = busy["buckets"]
    srv.reset()
    st = srv.stats()
    assert st["requests"] == 0 and st["batches"] == 0
    assert st["builds"] == 0 and st["throughput_rps"] == 0.0
    assert st["latency_mean_s"] == 0.0
    assert st["pad_node_overhead"] == 1.0
    assert st["buckets"] == kept
    assert srv.results == {}
    # the kept entries serve the same batch again without a build
    for i in range(4):
        srv.submit(synth_graph(f"again{i}", 16, 48, feat=8))
    served = srv.step(flush=True)
    assert len(served) == 4 and all(r.cache_hit for r in served)
    assert srv.stats()["builds"] == 0


def test_server_stats_count_with_obs_disabled():
    srv = _tiny_server()
    obs.disable()
    try:
        srv.submit(synth_graph("g", 16, 48, feat=8))
        srv.run_until_drained()
        assert obs.spans("serve.step") == []
        st = srv.stats()
        assert st["requests"] == 1 and st["builds"] == 1
        assert st["cache"]["misses"] == 1
    finally:
        obs.enable()


# ---------------------------------------------------------------------------
# the schema, pinned
# ---------------------------------------------------------------------------

def _documented_table():
    """(port name -> labels, reference name -> port name or None, the port's
    own names) from the table in repro_torch.obs's docstring."""
    doc = obs.__doc__
    body = doc[doc.index("-----"):].split("\n\n")[0].splitlines()[1:]
    schema, renames, own = {}, {}, set()
    for line in body:
        cols = re.split(r"\s{2,}", line.strip())
        if cols[0] == "-":
            renames[cols[1]] = None
            continue
        name, labels, ref = cols
        schema[name] = tuple(x.strip() for x in labels.split(","))
        if ref == "-":
            own.add(name)
        else:
            renames[name if ref == "=" else ref] = name
    return schema, renames, own


def test_schema_is_the_documented_table_and_the_reference_renamed():
    schema, renames, own = _documented_table()
    assert schema == obs.OBS_SCHEMA
    ref = repro.obs.OBS_SCHEMA
    assert set(renames) == set(ref)
    assert own == {"kernel.schedule_launches"}
    assert {renames[k]: v for k, v in ref.items()
            if renames[k] is not None} == {
        k: v for k, v in obs.OBS_SCHEMA.items() if k not in own}
    assert {k for k, v in renames.items() if v is None} == {
        "serve.plan_cache.compiles", "serve.plan_cache.compile_s"}


def test_exported_schema_is_exactly_the_documented_set(tmp_path):
    """Exercise every instrumented part, then the registry's names and
    label sets are exactly OBS_SCHEMA."""
    srv = _tiny_server(max_batch_graphs=4)
    for i in range(3):
        srv.submit(synth_graph(f"s{i}", 16, 48, feat=8))
    srv.run_until_drained()
    big = synth_graph("ooc", 128, 512, feat=8, num_classes=4)
    producer = SampledBatchProducer(
        NeighborSampler(big, fanouts=(4,), batch_size=8, seed=0), feat=8,
        device="cpu")
    producer.buckets_for_warmup(probe_steps=2)
    with PrefetchPipeline(producer, depth=0) as pipe:
        pipe.batch(0)
    data = train.GraphEpochProvider(shapes=((32, 96),), graphs_per_shape=1,
                                    feat=8, num_classes=4)
    task = train.NodeClassification.from_provider(data, model="gcn",
                                                  hidden=8, device="cpu")
    train.fit(task, data, train.TrainerConfig(steps=1))
    from repro_torch.core import autotune
    autotune.tune("gather_segment_reduce", idx_size=300, num_segments=40,
                  feat=8, db=autotune.PerfDB(tmp_path), measure_fn=lambda c: 1.0)
    exported = {n: tuple(labels)
                for n, labels in obs.get_registry().schema().items()
                if not n.startswith("t.")}
    assert exported == obs.OBS_SCHEMA


def test_jsonl_dump_matches_schema(tmp_path):
    srv = _tiny_server(max_batch_graphs=2)
    srv.submit(synth_graph("g", 16, 48, feat=8))
    srv.run_until_drained()
    path = str(tmp_path / "m.jsonl")
    obs.write_jsonl(path)
    for ln in open(path).read().splitlines():
        row = json.loads(ln)
        if row["record"] != "metric":
            continue
        if row["name"].startswith("t."):
            continue
        assert row["name"] in obs.OBS_SCHEMA
        assert set(row["labels"]) == set(obs.OBS_SCHEMA[row["name"]])


# ---------------------------------------------------------------------------
# span trees through the real paths
# ---------------------------------------------------------------------------

def test_serving_request_span_tree_complete():
    srv = _tiny_server(max_batch_graphs=2)
    srv.submit(synth_graph("a", 16, 48, feat=8))
    srv.run_until_drained()                      # cold: the bucket's build
    srv.submit(synth_graph("b", 16, 48, feat=8))
    srv.run_until_drained()                      # warm: cache hit
    cold, warm = obs.spans("serve.step")
    assert SERVE_STAGES <= cold.stages() and SERVE_STAGES <= warm.stages()
    assert not any(n.endswith(".compile") for n in cold.stages())
    assert cold.find("serve.execute").attrs["new_bucket"] is True
    assert warm.find("serve.execute").attrs["new_bucket"] is False
    assert "bucket" in cold.attrs
    builds = obs.why_built()
    assert len(builds) == srv.builds == 1
    assert builds[0]["site"] == "serve.forward"
    assert builds[0]["cause"] == "bucket_miss"
    assert "bucket" in builds[0] and "engine" in builds[0]
    assert [e["cause"] for e in obs.attributions("cache")] == ["miss"]
    json.dumps(obs.chrome_trace([cold, warm]))


def test_warmup_builds_attributed_as_warmup():
    srv = _tiny_server()
    srv.warmup([bucket_for(16, 48, srv.policy)])
    assert [e["cause"] for e in obs.why_built()] == ["warmup"]
    assert srv.stats()["cache"]["prefills"] == 1


def test_training_step_span_tree_complete():
    data = train.GraphEpochProvider(shapes=((32, 96),), graphs_per_shape=1,
                                    feat=8, num_classes=4)
    task = train.NodeClassification.from_provider(data, model="gcn",
                                                  hidden=8, device="cpu")
    t = train.Trainer(task, data, train.TrainerConfig(steps=2))
    res = t.fit()
    assert len(res.buckets) == 1 and res.steps == t.steps == 2
    assert obs.get_registry().get("train.buckets").value(
        **t._labels) == 1.0
    first, second = obs.spans("train.step")
    assert {"train.sample", "train.prepare",
            "train.execute"} <= first.stages()
    assert first.find("train.execute").attrs["new_bucket"] is True
    assert second.find("train.execute").attrs["new_bucket"] is False
    builds = obs.why_built()
    assert [e["cause"] for e in builds] == ["new_bucket"]
    assert builds[0]["site"] == "train.step"
    json.dumps(obs.chrome_trace([first, second]))


def test_pipeline_produce_span_tree_complete():
    big = synth_graph("ooc", 128, 512, feat=8, num_classes=4)
    producer = SampledBatchProducer(
        NeighborSampler(big, fanouts=(4,), batch_size=8, seed=0), feat=8,
        device="cpu")
    with PrefetchPipeline(producer, depth=2) as pipe:
        pipe.batch(0)                            # made in this thread
        pipe.batch(1)                            # made by a producer thread
    roots = obs.spans("pipeline.produce")
    assert len(roots) >= 2
    for root in roots:
        assert {"pipeline.sample", "pipeline.pad", "pipeline.plan_cache",
                "pipeline.copy", "pipeline.stamp"} <= root.stages()
        assert "bucket" in root.attrs
    assert len({r.tid for r in roots}) >= 2      # both threads' own trees


def test_report_smoke():
    srv = _tiny_server(max_batch_graphs=2)
    srv.submit(synth_graph("g", 16, 48, feat=8))
    srv.run_until_drained()
    text = rt.obs.report()
    assert "serve.requests" in text and "serve.builds" in text
    assert "builds recorded" in text


# ---------------------------------------------------------------------------
# spans on the profiler's clock
# ---------------------------------------------------------------------------

def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _trace_events(prof, tmp_path) -> list:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X"]


def _ranges(events, prefixes=("t.", "gnn.", "mp.", "plan.")) -> list:
    """[(name, start, end, tid)] of the program's ``user_annotation``
    ranges in a trace."""
    return [(e["name"], e["ts"], e["ts"] + e["dur"], e["tid"])
            for e in events if e.get("cat") == "user_annotation"
            and e["name"].startswith(prefixes)]


def _range_edges(ranges) -> list:
    """Sorted (name, name of the innermost range holding it) pairs."""
    out = []
    for r in ranges:
        holders = [h for h in ranges if h is not r and h[3] == r[3]
                   and h[1] <= r[1] and r[2] <= h[2]]
        parent = min(holders, key=lambda h: h[2] - h[1], default=None)
        out.append((r[0], None if parent is None else parent[0]))
    return sorted(out, key=str)


def _span_edges(roots) -> list:
    out = []
    for root in roots:
        out.append((root.name, None))
        for s in root.walk():
            out += [(c.name, s.name) for c in s.children]
    return sorted(out, key=str)


def _inside(e, ranges) -> bool:
    return any(r[1] <= e["ts"] and e["ts"] + e["dur"] <= r[2]
               and r[3] == e["tid"] for r in ranges)


def _small_tree(fail: bool = False):
    with obs.span("t.root", step=1):
        with obs.span("t.child.a"):
            with obs.span("t.leaf"):
                if fail:
                    raise RuntimeError("inside t.leaf")
        with obs.span("t.child.b"):
            pass


@pytest.mark.parametrize("mode", ["profiler", "profiler_raises",
                                  "no_profiler", "disabled"])
def test_spans_mirror_into_a_recording_profiler(mode, monkeypatch, tmp_path):
    """Under a profiler a span tree is the same tree of ``user_annotation``
    ranges (also when a stage raises); without one no ``record_function``
    is entered; disabled, neither a span nor a range is recorded."""
    entered = []

    class Counting(torch.autograd.profiler.record_function):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    if mode == "disabled":
        obs.disable()
    events = []
    if mode == "no_profiler":
        _small_tree()
    else:
        with _profile() as prof:
            if mode == "profiler_raises":
                with pytest.raises(RuntimeError, match="inside t.leaf"):
                    _small_tree(fail=True)
            else:
                _small_tree()
        events = _trace_events(prof, tmp_path)
    roots = obs.spans("t.root")
    ranges = _ranges(events)
    if mode == "disabled":
        assert roots == [] and ranges == [] and entered == []
        return
    (root,) = roots
    assert root.as_dict()["thread"] == threading.current_thread().name
    if mode == "no_profiler":
        assert entered == [] and root.stages() == {
            "t.root", "t.child.a", "t.leaf", "t.child.b"}
        return
    assert _range_edges(ranges) == _span_edges(roots)
    assert entered == [s.name for s in root.walk()]
    assert obs.current_span() is None


SAGE_DIMS = [16, 8, 8, 4]


def _sage_forward_on_fake_cuda(monkeypatch):
    """One GraphSAGE forward with a plan through the CUDA path's custom
    ops, on fake CUDA tensors (their fakes give shapes; nothing is built
    or launched). A CPU build cannot index a fake CUDA tensor by an int
    in Python (``t[0]``), so that index runs as the ``select`` it is."""
    import dataclasses

    from torch._subclasses.fake_tensor import FakeTensorMode
    g = synth_graph("fake", 64, 256, feat=SAGE_DIMS[0])
    edge_index = torch.from_numpy(g.edge_index)
    plan = gnn.make_model_plan(edge_index, g.num_nodes, feat=max(SAGE_DIMS),
                               device="cpu")
    obs.reset()
    getitem = torch.Tensor.__getitem__

    def select_int(t, key):
        return t.select(0, key) if isinstance(key, int) else getitem(t, key)
    monkeypatch.setattr(torch.Tensor, "__getitem__", select_int)
    with torch.no_grad(), FakeTensorMode(allow_non_fake_inputs=True):
        def fake(t):
            return torch.empty(t.shape, dtype=t.dtype, device="cuda")
        so = plan.src_order
        plan = dataclasses.replace(
            plan, row_ptr=fake(plan.row_ptr),
            src_order=dataclasses.replace(
                so, perm=fake(so.perm), src=fake(so.src), dst=fake(so.dst),
                row_ptr=fake(so.row_ptr)))
        with torch.device("meta"):
            model = gnn.GNN("sage", SAGE_DIMS)
        model.load_state_dict({k: fake(v) for k, v in
                               model.state_dict().items()}, assign=True)
        out = model(fake(torch.from_numpy(g.x)), fake(edge_index),
                    g.num_nodes, plan=plan)
    assert out.shape == (g.num_nodes, SAGE_DIMS[-1])


def _sage_forward_on_cpu():
    g = synth_graph("cpu", 64, 256, feat=SAGE_DIMS[0])
    edge_index = torch.from_numpy(g.edge_index)
    plan = gnn.make_model_plan(edge_index, g.num_nodes, feat=max(SAGE_DIMS),
                               device="cpu")
    model = gnn.GNN("sage", SAGE_DIMS)
    obs.reset()
    with torch.no_grad():
        model(torch.from_numpy(g.x), edge_index, g.num_nodes, plan=plan)


@pytest.mark.parametrize("order", ["auto_cpu", "fused", "transform_first",
                                   "aggregate_first"])
def test_gnn_forward_spans_and_their_ranges(order, monkeypatch, tmp_path):
    """A GraphSAGE forward with a plan: ``gnn.forward`` ⊃ 3 × ``gnn.layer``
    ⊃ ``mp.order``, ``mp.aggregate``, as spans and as the profiler's
    ranges; every ``repro_torch::`` call lies inside ``mp.aggregate``,
    every dense product of a layer outside it (the CPU's plain versions,
    and each order of the CUDA path on fake tensors)."""
    from repro_torch.core import mp as mp_mod
    if order != "auto_cpu":
        monkeypatch.setattr(mp_mod, "choose_order", lambda *a, **k: order)
    with _profile() as prof:
        if order == "auto_cpu":
            _sage_forward_on_cpu()
        else:
            _sage_forward_on_fake_cuda(monkeypatch)
    (root,) = obs.spans("gnn.forward")
    assert root.attrs == {"family": "sage", "layers": 3}
    assert [c.name for c in root.children] == ["gnn.layer"] * 3
    for i, layer in enumerate(root.children):
        assert layer.attrs == {"index": i, "d_in": SAGE_DIMS[i],
                               "d_out": SAGE_DIMS[i + 1]}
        chosen, agg = layer.children
        assert (chosen.name, agg.name) == ("mp.order", "mp.aggregate")
        assert agg.attrs["reduce"] == "mean"
        assert agg.attrs["order"] == chosen.attrs["order"]
        if order != "auto_cpu":
            assert chosen.attrs["order"] == order
        width = SAGE_DIMS[i + (chosen.attrs["order"] == "transform_first")]
        assert agg.attrs["width"] == width
    events = _trace_events(prof, tmp_path)
    ranges = _ranges(events, ("gnn.", "mp."))    # the plan's apart
    assert _range_edges(ranges) == _span_edges([root])
    aggregate = [r for r in ranges if r[0] == "mp.aggregate"]
    calls = [e for e in events if e.get("cat") == "cpu_op"
             and e["name"].startswith("repro_torch::")]
    assert len(calls) == (0 if order == "auto_cpu" else 3)
    assert all(_inside(c, aggregate) for c in calls)
    dense = [e for e in events if e.get("cat") == "cpu_op"
             and e["name"] == "aten::mm"]
    assert dense and not any(_inside(d, aggregate) for d in dense)
    assert all(_inside(d, [r for r in ranges if r[0] == "gnn.layer"])
               for d in dense)


@pytest.mark.parametrize("kind", ["graph", "segment"])
def test_plan_build_is_one_root_span_with_its_stages(kind):
    g = synth_graph("plan", 64, 256, feat=8)
    if kind == "graph":
        from repro_torch.core.plan import make_graph_plan
        plan = make_graph_plan(torch.from_numpy(g.edge_index), g.num_nodes,
                               feat=8, device="cpu")
        stages = ["plan.host_index", "plan.stats", "plan.row_ptr",
                  "plan.source_order"]
    else:
        from repro_torch.core.plan import make_plan
        plan = make_plan(g.edge_index[1], g.num_nodes, feat=8, device="cpu")
        stages = ["plan.host_index", "plan.stats", "plan.row_ptr"]
    (root,) = obs.spans("plan.build")
    assert obs.spans() == [root]
    assert root.attrs == {"kind": kind, "rows": plan.num_rows,
                          "segments": g.num_nodes, "feat": 8}
    assert [c.name for c in root.children] == stages
    assert all(not c.children for c in root.children)
    assert root.dur_s >= sum(c.dur_s for c in root.children) > 0.0


SPAN_NAME = re.compile(r'(?:\bspan\(|_stage\([^,()]+,\s*"[^"]*",)\s*"([^"]+)"')


def test_span_names_of_the_port():
    """No span of the port is named like a benchmark's own range
    (``bench.*``) or a custom op (``repro_torch::*``), and each one on the
    GNN request and the plan build is opened where the trace module's
    table says."""
    from pathlib import Path

    from repro_torch.obs import trace
    src = Path(rt.__file__).parent
    names = {n for f in src.rglob("*.py")
             for n in SPAN_NAME.findall(f.read_text())}
    assert not {n for n in names if n.startswith(("bench.",
                                                  "repro_torch::"))}
    ours = {"gnn.forward", "gnn.layer", "mp.order", "mp.aggregate",
            "plan.build", "plan.host_index", "plan.stats", "plan.row_ptr",
            "plan.source_order"}
    assert ours <= names
    assert {"serve.step", "serve.fetch", "train.step",
            "pipeline.produce", "autotune.tune"} <= names
    table = trace.__doc__
    assert all(n in table for n in ours)

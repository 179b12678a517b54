"""The port's measured config selection on the CPU (paper §III-C): the
PerfDB autotuner with hermetic timers (``measure_fn``; there is no CPU
sweep), the selection precedence, the rule pipeline, and parity with the
reference package on the same numpy inputs:

* ``extract_features`` and ``perf_key`` equal the reference's, and a
  reference-written PerfDB file is read here;
* ``python -m repro_torch.core.train_rules`` reproduces the committed
  rules byte for byte;
* ``tune`` raises without a card and without ``measure_fn``; a run length
  or tile with no built kernel instance raises before any launch;
* the blocked mirrors of the gather, segment_reduce and the fused kernel
  at every built M_b and S_b equal the reference's Pallas kernels (in
  interpret mode) within fp32 1e-5;
* a 2-layer gcn served through ``GNNServer(tune=True)`` on a hermetic
  PerfDB runs the measured winners and equals the reference's forward
  within 1e-5.
"""
import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import autotune as jautotune  # noqa: E402
from repro.core import features as jfeatures  # noqa: E402
from repro.core import ops as jops  # noqa: E402
from repro.core.config_space import KernelConfig as JConfig  # noqa: E402
from repro.kernels.segment_reduce import segment_reduce_pallas  # noqa: E402

from repro_torch.core import autotune, features, heuristics, perfdb  # noqa: E402
from repro_torch.core.autotune import (PerfDB, config_projection,  # noqa: E402
                                       perf_key, quantize_features, tune)
from repro_torch.core.config_space import (OP_KEYS, RUN_LENGTHS,  # noqa: E402
                                           SMEM_BYTES, TILE_SIZES,
                                           KernelConfig, all_configs,
                                           default_config)
from repro_torch.core.features import InputFeatures  # noqa: E402
from repro_torch.kernels import fused_transform_reduce as tftr  # noqa: E402
from repro_torch.kernels import gather_segment_reduce as tgsr  # noqa: E402
from repro_torch.kernels import segment_reduce as tsrd  # noqa: E402
from repro_torch.kernels.gather_segment_reduce import row_offsets  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
M, S, F = 1000, 125, 16
BACKEND = "cuda:hermetic"


def _counting_measure(op: str, best: KernelConfig):
    """Fake timer: ``best``'s projection wins, every other is slower; it
    counts its calls."""
    calls = []

    def measure(cfg: KernelConfig) -> float:
        calls.append(cfg)
        if config_projection(op, cfg) == config_projection(op, best):
            return 10.0
        return 1000.0 + len(calls)

    return measure, calls


# ---------------------------------------------------------------------------
# sweeps (hermetic: a measure_fn stands in for the card)
# ---------------------------------------------------------------------------

def test_tuned_config_on_lattice_and_smem_feasible(tmp_path):
    measure, calls = _counting_measure("gather_segment_reduce",
                                       KernelConfig(m_b=256))
    res = tune("gather_segment_reduce", idx_size=256, num_segments=64,
               feat=8, db=PerfDB(tmp_path), measure_fn=measure)
    lattice = {c.astuple() for c in all_configs(8)}
    assert res.config.astuple() in lattice and res.config.m_b == 256
    assert tftr.smem_bytes(8, 8, "float32", res.config.s_b) <= SMEM_BYTES
    assert not res.cache_hit
    # one candidate a built run length: the projection dedupes the rest
    assert res.timings_performed == len(res.timings) == len(RUN_LENGTHS)
    assert res.time_of(res.config) == min(res.timings.values())


@pytest.mark.parametrize("op", OP_KEYS)
def test_new_op_keys_are_tunable(tmp_path, op):
    """Every op key sweeps and caches: the gather and segment_reduce keys
    one candidate a run length, the fused kernel one a tile, the kernels
    that read no axis one candidate (still timed and stored)."""
    measure, calls = _counting_measure(op, default_config(4))
    res = tune(op, idx_size=96, num_segments=24, feat=4, db=PerfDB(tmp_path),
               measure_fn=measure)
    want = {"m_b": len(RUN_LENGTHS), "s_b": len(TILE_SIZES)}.get(
        (config_projection(op, KernelConfig()) or (None,))[0], 1)
    assert res.timings_performed == len(res.timings) == len(calls) == want
    again = tune(op, idx_size=96, num_segments=24, feat=4,
                 db=PerfDB(tmp_path), measure_fn=measure)
    assert again.cache_hit and again.config == res.config
    assert len(calls) == want


def test_select_config_rejects_unregistered_op():
    with pytest.raises(ValueError):
        heuristics.select_config(100, 10, 8, op="nope")


def test_config_projection_reads_only_the_kernels_axis():
    a = KernelConfig("SR", 64, 128, 256, 1)
    b = KernelConfig("PR", 128, 512, 256, 16)
    for op in ("segment_reduce", "gather_segment_reduce",
               "gather_segment_reduce_mean", "gather_segment_reduce_max"):
        assert config_projection(op, a) == config_projection(op, b) == \
            ("m_b", 256)
    assert config_projection("fused_transform_reduce", a) == ("s_b", 64)
    for op in ("segment_softmax", "segment_matmul", "grouped_segment_matmul",
               "sddmm"):
        assert config_projection(op, a) == config_projection(op, b) == ()


# ---------------------------------------------------------------------------
# cache round-trip
# ---------------------------------------------------------------------------

def test_perfdb_roundtrip_second_tune_does_zero_timings(tmp_path):
    best = KernelConfig(m_b=128)
    measure, calls = _counting_measure("segment_reduce", best)
    r1 = tune("segment_reduce", idx_size=M, num_segments=S, feat=F,
              db=PerfDB(tmp_path), measure_fn=measure)
    assert not r1.cache_hit and r1.timings_performed == len(calls) > 0
    n_cold = len(calls)
    # a fresh PerfDB on the same directory: a new process's view
    r2 = tune("segment_reduce", idx_size=M, num_segments=S, feat=F,
              db=PerfDB(tmp_path), measure_fn=measure)
    assert r2.cache_hit and r2.timings_performed == 0
    assert len(calls) == n_cold
    assert r2.config.astuple() == r1.config.astuple()
    assert r2.timings == r1.timings
    # a nearby shape of the same quantized class: the same entry
    r3 = tune("segment_reduce", idx_size=M + 7, num_segments=S, feat=F,
              db=PerfDB(tmp_path), measure_fn=measure)
    assert r3.cache_hit and len(calls) == n_cold


def test_quantized_key_buckets_nearby_shapes():
    a = perf_key(BACKEND, "segment_reduce", InputFeatures(1000, 125, 16))
    b = perf_key(BACKEND, "segment_reduce", InputFeatures(1040, 130, 16))
    c = perf_key(BACKEND, "segment_reduce", InputFeatures(64_000, 125, 16))
    assert a == b and a != c
    neg = perf_key(BACKEND, "segment_reduce", InputFeatures(1000, 1100, 16))
    pos = perf_key(BACKEND, "segment_reduce", InputFeatures(1000, 950, 16))
    assert neg == pos and "-0," not in neg
    assert quantize_features(InputFeatures(1000, 125, 16)) == \
        quantize_features(InputFeatures(1040, 130, 16))


def test_perfdb_ignores_corrupt_file(tmp_path):
    (tmp_path / "perfdb.json").write_text("{not json")
    db = PerfDB(tmp_path)
    assert len(db) == 0
    db.put("k", {"op": "segment_reduce"})
    assert PerfDB(tmp_path).get("k") == {"op": "segment_reduce"}


# ---------------------------------------------------------------------------
# precedence: measured > generated rules > hand-crafted
# ---------------------------------------------------------------------------

def test_selection_precedence(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    rules_cfg = heuristics.select_config(M, S, F, tune=False)
    hand_cfg = heuristics.hand_crafted_config(M, S, F)
    # the lower tiers disagree here (the rules' small-graph tile)
    assert rules_cfg.astuple() != hand_cfg.astuple()
    measured = KernelConfig("SR", 64, 32, 256, 1)
    measure, _ = _counting_measure("segment_reduce", measured)
    db = PerfDB(tmp_path)
    monkeypatch.setattr(autotune, "current_backend", lambda: BACKEND)
    tune("segment_reduce", idx_size=M, num_segments=S, feat=F, db=db,
         measure_fn=measure)
    # tier 1: the measured winner when tuning is asked for
    assert heuristics.select_config(M, S, F, tune=True, db=db).m_b == 256
    # tier 2: without tuning (REPRO_AUTOTUNE unset), the rules
    assert heuristics.select_config(M, S, F, tune=False) == rules_cfg
    assert heuristics.select_config(M, S, F) == rules_cfg
    # the ops whose kernels read no axis take the shipped values
    assert heuristics.select_config(M, S, F, op="sddmm") == hand_cfg
    # tier 3: no generated rules, the hand-crafted values
    monkeypatch.setattr(heuristics, "_generated_rules", None)
    assert heuristics.select_config(M, S, F, tune=False) == default_config(F)


def test_failed_measurement_raises_not_falls_back(tmp_path, monkeypatch):
    """Unlike the reference, a sweep that fails (a kernel that does not
    build or launch) raises through the selection: no warning and no
    silent fall back to the rules."""
    monkeypatch.setattr(autotune, "current_backend", lambda: BACKEND)

    def broken(cfg):
        raise RuntimeError("gather_segment_reduce: CUDA error 98 at launch")

    monkeypatch.setattr(autotune, "tune", functools.partial(
        autotune.tune, measure_fn=broken))
    with pytest.raises(RuntimeError, match="CUDA error"):
        heuristics.select_config(M, S, F, op="gather_segment_reduce",
                                 tune=True, db=PerfDB(tmp_path))


def test_make_plan_tune_uses_perfdb_entry(tmp_path, monkeypatch):
    """make_plan(tune=True) takes M_b from the gather's measured winner and
    S_b from the fused kernel's (REPRO_PERFDB_PATH routes it to the DB the
    test seeded); without tune the rules decide."""
    from repro_torch.core.plan import make_plan
    monkeypatch.setenv("REPRO_PERFDB_PATH", str(tmp_path))
    monkeypatch.setattr(autotune, "current_backend", lambda: BACKEND)
    rng = np.random.default_rng(0)
    idx = np.sort(rng.integers(0, S, size=M)).astype(np.int32)
    live = int(np.unique(idx).size)
    counted = []
    for op, best in (("gather_segment_reduce", KernelConfig(m_b=256)),
                     ("fused_transform_reduce", KernelConfig(s_b=128))):
        measure, calls = _counting_measure(op, best)
        tune(op, idx_size=M, num_segments=live, feat=F, db=PerfDB(tmp_path),
             measure_fn=measure)
        counted.append(calls)
    n_cold = [len(c) for c in counted]
    plan = make_plan(idx, S, feat=F, tune=True, device="cpu")
    assert (plan.config.m_b, plan.config.s_b) == (256, 128)
    assert [len(c) for c in counted] == n_cold          # cache hits only
    plan_default = make_plan(idx, S, feat=F, device="cpu")
    assert plan_default.config == heuristics.select_config(M, live, F,
                                                           tune=False)


def test_tune_raises_without_a_card_or_measure_fn(tmp_path):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CPU sweep"):
        tune("gather_segment_reduce", idx_size=M, num_segments=S, feat=F,
             db=PerfDB(tmp_path))
    with pytest.raises(RuntimeError, match="no CPU sweep"):
        heuristics.select_plan_config(M, S, F, tune=True, db=PerfDB(tmp_path))
    # the measured lookup is a lookup: no card, no entry
    assert autotune.lookup("gather_segment_reduce", idx_size=M,
                           num_segments=S, feat=F,
                           db=PerfDB(tmp_path)) is None


@pytest.mark.parametrize("what", ["gather", "segment_reduce", "fused"])
def test_unbuilt_config_raises_before_launch(what):
    """A run length or tile with no built instance is refused in Python,
    before any tensor check or launch, never run as another instance."""
    h = torch.randn(10, 8)
    idx = torch.zeros(20, dtype=torch.int32)
    rp = row_offsets(idx, 10)
    with pytest.raises(ValueError, match="built"):
        if what == "gather":
            tgsr.gather_segment_reduce_cuda(h, idx, idx, 10, None, "sum", rp,
                                            run_rows=96)
        elif what == "segment_reduce":
            tsrd.segment_reduce_cuda(torch.randn(20, 8), idx, 10, "sum", rp,
                                     run_rows=32)
        else:
            tftr.fused_transform_reduce_cuda(h, torch.randn(8, 4), idx, idx,
                                             10, None, "sum", rp, tile=48)


# ---------------------------------------------------------------------------
# snap_config hardening
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("raw", [
    np.zeros(2),
    np.full(2, np.nan),
    np.array([np.inf, -5.0]),
    np.array([-1e30, 1e30]),
])
def test_snap_config_degenerate_predictions(raw):
    cfg = perfdb.snap_config(raw)
    assert cfg.astuple() in {c.astuple() for c in all_configs()}
    assert cfg.m_b in RUN_LENGTHS and cfg.s_b in TILE_SIZES


# ---------------------------------------------------------------------------
# measured retraining pipeline
# ---------------------------------------------------------------------------

def test_train_rules_from_perfdb(tmp_path):
    from repro_torch.core import train_rules
    db = PerfDB(tmp_path)
    swept = 0
    for m, s, f, op, best in [
            (1000, 125, 16, "gather_segment_reduce", KernelConfig(m_b=128)),
            (64_000, 125, 64, "gather_segment_reduce", KernelConfig(m_b=256)),
            (64_000, 125, 64, "fused_transform_reduce",
             KernelConfig(s_b=128)),
            (64_000, 125, 64, "sddmm", KernelConfig())]:
        measure, _ = _counting_measure(op, best)
        res = tune(op, idx_size=m, num_segments=s, feat=f, db=db,
                   measure_fn=measure)
        swept += res.timings_performed if op != "sddmm" else 0
    records = train_rules.records_from_perfdb(tmp_path)
    assert len(records) == swept > 0       # sddmm trains no axis
    assert {r.axes for r in records} == {("m_b",), ("s_b",)}
    x, y = perfdb.top1_training_set(records)
    got = {tuple(k): tuple(v) for k, v in zip(x, y)}
    assert got[tuple(InputFeatures(64_000, 125, 64).as_vector())] == \
        (128.0, 256.0)
    # a key no fused sweep measured keeps the shipped tile
    assert got[tuple(InputFeatures(1000, 125, 16).as_vector())] == \
        (64.0, 128.0)
    out = tmp_path / "rules.py"
    train_rules.train(out_path=out, records=records, verbose=False,
                      source="measured-test")
    ns: dict = {}
    exec(out.read_text(), ns)  # noqa: S102 — our own codegen
    cfg = ns["select"](*InputFeatures(1000, 125, 16).as_vector())
    assert cfg.m_b in RUN_LENGTHS and cfg.s_b in TILE_SIZES


def test_train_rules_cli_from_perfdb(tmp_path, monkeypatch):
    from repro_torch.core import train_rules
    measure, _ = _counting_measure("gather_segment_reduce",
                                   KernelConfig(m_b=128))
    monkeypatch.setattr(autotune, "current_backend", lambda: BACKEND)
    tune("gather_segment_reduce", idx_size=M, num_segments=S, feat=F,
         db=PerfDB(tmp_path), measure_fn=measure)
    out = tmp_path / "rules_cli.py"
    train_rules.main(["--from-perfdb", str(tmp_path), "--out", str(out)])
    text = out.read_text()
    assert "AUTO-GENERATED" in text and BACKEND in text
    assert "--from-perfdb DB" in text


def test_train_rules_cli_empty_perfdb_errors(tmp_path):
    from repro_torch.core import train_rules
    with pytest.raises(SystemExit):
        train_rules.main(["--from-perfdb", str(tmp_path / "empty"),
                          "--out", str(tmp_path / "x.py")])


# ---------------------------------------------------------------------------
# parity with the reference package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,s,f", [(0, 7, 3), (1, 1, 1), (999, 12, 64),
                                   (5000, 4000, 128)])
def test_extract_features_matches_reference(m, s, f):
    rng = np.random.default_rng(m)
    idx = np.sort(rng.integers(0, s, m)).astype(np.int32)
    want = jfeatures.extract_features(idx, f, 2)
    for given in (idx, torch.from_numpy(idx)):
        got = features.extract_features(given, f, 2)
        assert (got.idx_size, got.idx_max, got.feat, got.dtype_bytes) == \
            (want.idx_size, want.idx_max, want.feat, want.dtype_bytes)
        np.testing.assert_array_equal(got.as_vector(), want.as_vector())
    assert InputFeatures.names() == jfeatures.InputFeatures.names()


@pytest.mark.parametrize("dtype_bytes", [4, 2])
def test_perf_key_matches_reference(dtype_bytes):
    for m, s, f in [(1000, 125, 16), (1000, 1100, 16), (2_097_152, 262_144,
                                                        64), (9, 3, 1)]:
        t = InputFeatures(m, s, f, dtype_bytes)
        j = jfeatures.InputFeatures(m, s, f, dtype_bytes)
        for op in OP_KEYS:
            assert perf_key(BACKEND, op, t) == jautotune.perf_key(BACKEND,
                                                                  op, j)
        assert quantize_features(t) == jautotune.quantize_features(j)
    assert autotune.DB_VERSION == jautotune.DB_VERSION


def test_reference_perfdb_file_is_read(tmp_path, monkeypatch):
    """A PerfDB the reference wrote (its schema, key format and version)
    loads here, and its winner is what a lookup on its backend returns."""
    best = JConfig("SR", 64, 128, 256, 1)

    def measure(cfg):
        return 10.0 if cfg.m_b == best.m_b else 100.0

    res = jautotune.tune(op="segment_reduce", idx_size=M, num_segments=S,
                         feat=F, db=jautotune.PerfDB(tmp_path),
                         max_configs=6, measure_fn=measure)
    doc = json.loads((tmp_path / "perfdb.json").read_text())
    db = PerfDB(tmp_path)
    assert db.load() == doc["entries"] and len(db) == 1
    monkeypatch.setattr(autotune, "current_backend", lambda: res.backend)
    got = autotune.lookup("segment_reduce", idx_size=M, num_segments=S,
                          feat=F, db=db)
    assert got.astuple() == res.config.astuple()
    # the port's own entries merge in beside it
    measure2, _ = _counting_measure("sddmm", KernelConfig())
    tune("sddmm", idx_size=M, num_segments=S, feat=F, db=db,
         measure_fn=measure2)
    assert len(PerfDB(tmp_path)) == 2 and res.key in PerfDB(tmp_path).keys()


def test_generated_rules_reproduced_byte_for_byte(tmp_path):
    out = tmp_path / "rules.py"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.train_rules", "--out",
         str(out)], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    committed = ROOT / "src/repro_torch/core/_generated_rules.py"
    assert out.read_bytes() == committed.read_bytes()


# ---------------------------------------------------------------------------
# every built instance's schedule on the CPU against the reference's Pallas
# ---------------------------------------------------------------------------

def _hub_graph():
    """700 destinations, 4000 rows: runs of every built length cut
    segments, a 900-row hub spans several runs of each, empty segments
    and padding rows (dst = num_segments) included."""
    rng = np.random.default_rng(31)
    v = 700
    dst = np.concatenate([rng.integers(0, v, 3100), np.full(900, 333),
                          np.full(17, v)])
    dst = np.sort(dst[dst != 500]).astype(np.int32)
    src = rng.integers(0, v, dst.size).astype(np.int32)
    x = rng.standard_normal((v, 12)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, dst.size).astype(np.float32)
    return src, dst, x, w, v


JCFG = JConfig("SR", 64, 128, 64, 1)
TOL = dict(rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _pallas(kind, reduce):
    src, dst, x, w, v = _hub_graph()
    j = jnp.asarray
    if kind == "gather":
        out = jops.index_weight_segment_reduce(j(x), j(src), j(w), j(dst), v,
                                               reduce, "pallas", JCFG)
    elif kind == "segment_reduce":
        xr = np.random.default_rng(32).standard_normal(
            (dst.size, 12)).astype(np.float32)
        out = segment_reduce_pallas(j(xr), j(dst), v, reduce, config=JCFG,
                                    interpret=True)
    else:
        wm = (np.random.default_rng(33).standard_normal((12, 20))
              / 4).astype(np.float32)
        out = jops.fused_transform_reduce(j(x), j(wm), j(src), j(w), j(dst),
                                          v, reduce, "pallas", JCFG)
    return np.asarray(out)


@pytest.mark.parametrize("m_b", RUN_LENGTHS)
@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
def test_blocked_gather_every_run_length_matches_pallas(m_b, reduce):
    from repro_torch.kernels import ops as kops
    src, dst, x, w, v = _hub_graph()
    rp = np.searchsorted(dst, np.arange(v + 1))
    assert rp[334] // m_b - rp[333] // m_b >= 2      # the hub spans runs
    got = kops.gather_segment_reduce(
        torch.from_numpy(x), torch.from_numpy(src), torch.from_numpy(dst), v,
        torch.from_numpy(w), reduce, config=KernelConfig(m_b=m_b),
        impl="blocked")
    np.testing.assert_allclose(got.numpy(), _pallas("gather", reduce), **TOL)


@pytest.mark.parametrize("m_b", RUN_LENGTHS)
@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
def test_blocked_segment_reduce_every_run_length_matches_pallas(m_b, reduce):
    from repro_torch.core.plan import make_plan
    from repro_torch.kernels import ops as kops
    _, dst, _, _, v = _hub_graph()
    xr = np.random.default_rng(32).standard_normal(
        (dst.size, 12)).astype(np.float32)
    plan = make_plan(dst, v, config=KernelConfig(m_b=m_b), device="cpu")
    got = kops.segment_reduce(torch.from_numpy(xr), torch.from_numpy(dst), v,
                              reduce, plan=plan, impl="blocked")
    np.testing.assert_allclose(got.numpy(), _pallas("segment_reduce",
                                                    reduce), **TOL)


@pytest.mark.parametrize("s_b", TILE_SIZES)
@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_blocked_fused_every_tile_matches_pallas(s_b, reduce):
    from repro_torch.kernels import ops as kops
    src, dst, x, w, v = _hub_graph()
    assert v % s_b != 0                               # a ragged last tile
    wm = (np.random.default_rng(33).standard_normal((12, 20))
          / 4).astype(np.float32)
    got = kops.fused_transform_reduce(
        torch.from_numpy(x), torch.from_numpy(wm), torch.from_numpy(src),
        torch.from_numpy(dst), v, torch.from_numpy(w), reduce,
        config=KernelConfig(s_b=s_b), impl="blocked")
    want = _pallas("fused", reduce)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


# ---------------------------------------------------------------------------
# the tuned engine
# ---------------------------------------------------------------------------

def test_tuned_server_runs_measured_winners_and_matches_reference(
        tmp_path, monkeypatch):
    from repro.data.graphs import dataset as jdataset
    from repro.models import gnn as jgnn

    from repro_torch.data.graphs import dataset
    from repro_torch.models.params import from_jax_params
    from repro_torch.serve import GNNServer
    winners = {"gather_segment_reduce": KernelConfig(m_b=256),
               "fused_transform_reduce": KernelConfig(s_b=32)}
    timed = []

    def measure_for(op):
        def measure(cfg):
            timed.append(op)
            won = config_projection(op, cfg) == config_projection(
                op, winners[op])
            return 5.0 if won else 50.0
        return measure

    real_tune = autotune.tune
    monkeypatch.setattr(autotune, "current_backend", lambda: BACKEND)
    monkeypatch.setattr(autotune, "tune", lambda op, **kw: real_tune(
        op, measure_fn=measure_for(op), **kw))
    params = jgnn.init(jax.random.PRNGKey(0), "gcn", 32, 64, 16,
                       num_layers=2)
    layers = [{k: np.asarray(p.value) for k, p in lay.items()}
              for lay in params]
    model = from_jax_params("gcn", layers)
    db = PerfDB(tmp_path)
    srv = GNNServer(model, "gcn", device="cpu", tune=True, perfdb=db)
    g = dataset("cora", feat=32, scale=0.1)
    srv.submit(g)
    (res,) = srv.step(flush=True)
    (entry,) = [e for _, e in srv.cache.entries()]
    assert (entry.config.m_b, entry.config.s_b) == (256, 32)
    assert sorted(set(timed)) == sorted(winners)
    n_timed = len(timed)
    # a second engine on the same DB looks the winners up: no timing
    srv2 = GNNServer(model, "gcn", device="cpu", tune=True, perfdb=db)
    srv2.submit(g)
    srv2.step(flush=True)
    assert len(timed) == n_timed
    assert [e.config for _, e in srv2.cache.entries()] == [entry.config]
    jg = jdataset("cora", feat=32, scale=0.1)
    want = jgnn.forward(params, "gcn", jnp.asarray(jg.x),
                        jnp.asarray(jg.edge_index), jg.num_nodes,
                        jnp.asarray(jg.deg_inv_sqrt), impl="ref")
    np.testing.assert_allclose(res.logits, np.asarray(want), **TOL)


def test_build_units_one_library_a_value(tmp_path, monkeypatch):
    """Each built run length and tile is a library of its own, compiled
    from a wrapper that narrows the source's instance list to that value;
    the other kernels are one library each."""
    from repro_torch.kernels import _build
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    units = _build.units()
    assert len(units) == 3 + 2 * len(RUN_LENGTHS) + len(TILE_SIZES)
    assert ("fused_transform_reduce", 128) in units and ("sddmm", None) in units
    paths = {u: _build._library_path(u) for u in units}
    assert len(set(paths.values())) == len(units)
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    cmd = _build._compile_cmd(("segment_reduce", 256), tmp_path / "x.so")
    wrapper = Path(cmd[-1]).read_text()
    assert wrapper.startswith("#define FOR_RUN_LENGTHS(X) X(256)\n")
    assert str(_build.CSRC / "segment_reduce.cu") in wrapper
    assert _build._compile_cmd(("sddmm", None), tmp_path / "y.so")[-1] == \
        str(_build.CSRC / "sddmm.cu")
    with pytest.raises(ValueError, match="no instance"):
        _build.load("gather_segment_reduce", 96)

"""The readers of the program's spans (``mp_ms``, ``plan_s``) and the
breakdown's names for idle gaps, on a small canned profiler trace with
program ranges of its own (CPU)."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402
from bench import trace as tr  # noqa: E402

MS = 1000.0          # trace times are in µs
T0 = 7_000_000.0     # the window's start on the trace's clock
GSR = "void (anonymous namespace)::gsr_runs<float, 1, 32, false, 64, true>"
GEMM = "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x64x8"


def x(cat, name, ts_ms, dur_ms, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": T0 + ts_ms * MS,
            "dur": dur_ms * MS, "tid": tid, "pid": 1, "args": args}


def canned(aggregate: bool = True) -> dict:
    """Two requests of 10 ms, each a ``gnn.forward`` ⊃ ``gnn.layer`` ⊃
    ``mp.order``, ``mp.aggregate`` (the gather's op, whose kernel runs
    3 ms), then the layer's dense product (1 ms of device time, launched
    after ``mp.aggregate`` has closed). Device busy 2-6 ms of each
    request; the gaps lie inside ``mp.aggregate`` (0-2 ms) and inside
    ``gnn.layer`` (6-12 ms, 16-20 ms), with no op open."""
    ev = [x("user_annotation", tr.WINDOW, 0, 20),
          x("gpu_user_annotation", tr.WINDOW, 0, 20, tid=7)]
    corr = 0
    for u in (0, 10):
        ev += [x("user_annotation", "gnn.forward", u + 0.5, 9),
               x("user_annotation", "gnn.layer", u + 0.6, 8.8),
               x("user_annotation", "mp.order", u + 0.7, 0.2)]
        if aggregate:
            ev += [x("user_annotation", "mp.aggregate", u + 0.95, 1.05),
                   x("gpu_user_annotation", "mp.aggregate", u + 2, 3, tid=7)]
        corr += 1
        ev += [x("cpu_op", "repro_torch::gather_segment_reduce", u + 1.1,
                 0.8),
               x("cuda_runtime", "cudaLaunchKernel", u + 1.5, 0.01,
                 correlation=corr),
               x("kernel", GSR, u + 2, 3, tid=7, correlation=corr)]
        corr += 1
        ev += [x("cpu_op", "aten::mm", u + 2.2, 0.3),
               x("cuda_runtime", "cudaLaunchKernel", u + 2.4, 0.01,
                 correlation=corr),
               x("kernel", GEMM, u + 5, 1, tid=7, correlation=corr)]
    return {"traceEvents": ev}


def record(trace=None, units=2) -> harness.Record:
    view = tr.View(canned() if trace is None else trace)
    return harness.Record(setup_s=10.0, window_s=view.window_s, units=units,
                          view=view)


def read(name, rec):
    path = harness.BENCH / "metrics" / f"{name}.py"
    return harness.load_module(path).read(rec)


@pytest.mark.parametrize("units", [1, 2])
def test_mp_ms_counts_only_the_kernels_launched_inside_mp_aggregate(units):
    # the gather's 3 ms a request; the dense product's launch lies
    # outside the range, and the device-side copies of the ranges
    # (gpu_user_annotation) are no kernels
    assert read("mp_ms", record(units=units)) == pytest.approx(6.0 / units)


def test_mp_ms_reads_nothing_without_the_range():
    assert read("mp_ms", record(canned(aggregate=False))) is None
    assert read("mp_ms", harness.Record(setup_s=1.0, window_s=1.0,
                                        units=1)) is None


def _obs():
    from repro_torch import obs
    obs.enable()
    obs.reset()
    return obs


def test_plan_s_reads_the_newest_root_plan_build():
    obs = _obs()
    rec = record()
    assert read("plan_s", rec) is None            # no plan built yet
    for _ in range(2):
        with obs.span("plan.build", kind="graph") as newest:
            with obs.span("plan.host_index"):
                pass
    with obs.span("serve.step"):
        with obs.span("plan.build"):              # not a root
            pass
    assert read("plan_s", rec) == newest.dur_s > 0.0
    obs.reset()


def test_plan_s_reads_nothing_when_the_program_is_not_loaded(monkeypatch):
    obs = _obs()
    with obs.span("plan.build"):
        pass
    monkeypatch.delitem(sys.modules, "repro_torch.obs")
    assert read("plan_s", record()) is None
    obs.reset()


def test_breakdown_names_a_gap_inside_a_program_span_by_it():
    out = tr.breakdown(tr.View(canned()))
    assert [g[1] for g in out["idle_gaps"]] == pytest.approx(
        [0.006, 0.004, 0.002])
    assert [g[0] for g in out["idle_gaps"]] == [
        "gnn.layer", "gnn.layer", "mp.aggregate"]
    # without the program's ranges the same gaps have no name
    bare = {"traceEvents": [e for e in canned()["traceEvents"]
                            if e["cat"] != "user_annotation"
                            or e["name"] == tr.WINDOW]}
    assert {g[0] for g in tr.breakdown(tr.View(bare))["idle_gaps"]} == {
        "(no host op)"}

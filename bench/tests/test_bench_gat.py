"""The GAT cell on the CPU at a tiny size, the program's plain versions:
a clean run comes out correct and each planted fault of
``bench_faults_gat`` not; ``gat_infer``'s weights are the model's
parameters; ``attn_ms`` reads the kernels launched inside
``gat.attention`` on a canned profiler trace. The TF32 control runs on
the card alone (``test_bench_gat_chip.py``)."""
from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(Path(__file__).parent)]

import bench_faults_gat  # noqa: E402
from bench import harness  # noqa: E402
from bench import trace as tr  # noqa: E402
from bench.drivers import gat_infer  # noqa: E402

CPU = torch.device("cpu")
MS = 1000.0
T0 = 5_000_000.0


def gat_cell() -> harness.Cell:
    cell = harness.Cell.load("gat-reddit2.infer")
    cell.config.update(num_nodes=600, num_edges=9000, num_features=24,
                       hidden=8, num_classes=5)
    cell.traffic.update(sample=2, trace_units=2)
    return cell


def run(cell, trace=False):
    return harness.run_cell(torch, cell, 2 ** 31 + 77, 0.3, trace, CPU,
                            time.perf_counter())


def test_gat_clean_run_is_correct():
    out = run(gat_cell())
    assert out["correct"], out["checks"]
    assert out["checks"]["logit_err"]["value"] < 1e-5


def test_traced_run_reads_the_plan_build():
    """``gat_infer`` builds its plan under the root span ``plan.build``,
    so ``plan_s`` reads it on the GAT cell as on SAGE's."""
    out = run(gat_cell(), trace=True)
    assert out["correct"], out["checks"]
    assert 0 < out["metrics"]["plan_s.gnn_infer"]["value"] < 60


@pytest.mark.parametrize("fault", sorted(bench_faults_gat.GAT_FAULTS))
def test_gat_fault_is_caught(fault):
    with bench_faults_gat.GAT_FAULTS[fault]():
        out = run(gat_cell())
    assert not out["correct"], out["checks"]


def test_weights_are_the_models_parameters_at_the_cells_widths():
    from repro_torch.models import gnn
    config = harness.Cell.load("gat-reddit2.infer").config
    assert gat_infer.layer_dims(config) == [602, 1024, 1024, 41]
    assert gat_infer.head_widths(config) == [256, 256, 41]
    with torch.device("meta"):
        model = gnn.GNN("gat", gat_infer.layer_dims(config),
                        heads=config["heads"], concat=config["concat"],
                        bias=True, skip=True, activation="elu")
    want = {n: tuple(p.shape) for n, p in model.state_dict().items()}
    assert {n: s for n, s, _ in gat_infer.weight_specs(config)} == want


def test_flops_of_a_request():
    config = harness.Cell.load("gat-reddit2.infer").config
    v, rows = config["num_nodes"], config["num_edges"] + config["num_nodes"]
    dense = 2 * v * (602 * 2048 + 1024 * 2048 + 1024 * (246 + 41))
    flops = gat_infer.infer_flops(v, rows, config)
    # the dense products are most of a request's FLOPs, the weighted sums
    # the rest but for a few percent
    sums = 2 * rows * (1024 + 1024 + 246)
    assert dense < flops and 0.95 < (dense + sums) / flops < 1.0


def x(cat, name, ts_ms, dur_ms, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": T0 + ts_ms * MS,
            "dur": dur_ms * MS, "tid": tid, "pid": 1, "args": args}


def canned(attention: bool = True) -> dict:
    """Two requests of 10 ms: a ``gat.attention`` range whose two
    kernels (an index_select 1 ms, the softmax 2 ms) run on the card, then
    an ``mp.aggregate`` whose gather runs 4 ms, launched after the range
    closed."""
    ev = [x("user_annotation", tr.WINDOW, 0, 20)]
    corr = 0
    for u in (0, 10):
        if attention:
            ev.append(x("user_annotation", "gat.attention", u + 0.1, 1.0))
        for name, launch, start, dur in (("index_select", 0.2, 1.2, 1.0),
                                         ("ssm_runs", 0.6, 2.2, 2.0)):
            corr += 1
            ev += [x("cuda_runtime", "cudaLaunchKernel", u + launch, 0.01,
                     correlation=corr),
                   x("kernel", name, u + start, dur, tid=7,
                     correlation=corr)]
        corr += 1
        ev += [x("user_annotation", "mp.aggregate", u + 1.2, 0.5),
               x("cuda_runtime", "cudaLaunchKernel", u + 1.3, 0.01,
                 correlation=corr),
               x("kernel", "gsr_runs", u + 4.2, 4.0, tid=7,
                 correlation=corr)]
    return {"traceEvents": ev}


def read(name, trace, units=2):
    view = tr.View(trace)
    rec = harness.Record(setup_s=1.0, window_s=view.window_s, units=units,
                         view=view)
    return harness.load_module(harness.BENCH / "metrics"
                               / f"{name}.py").read(rec)


@pytest.mark.parametrize("units", [1, 2])
def test_attn_ms_counts_only_the_kernels_launched_inside_gat_attention(
        units):
    assert read("attn_ms", canned(), units) == pytest.approx(6.0 / units)
    assert read("mp_ms", canned(), units) == pytest.approx(8.0 / units)


def test_attn_ms_reads_nothing_without_the_range():
    assert read("attn_ms", canned(attention=False)) is None
    assert harness.load_module(harness.BENCH / "metrics" / "attn_ms.py").read(
        harness.Record(setup_s=1.0, window_s=1.0, units=1)) is None

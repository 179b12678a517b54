"""Each metric reader on a small canned profiler trace whose readings are
worked out by hand (CPU)."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness, roofline  # noqa: E402
from bench import trace as tr  # noqa: E402

MS = 1000.0          # trace times are in µs
T0 = 5_000_000.0     # the window's start on the trace's clock
GSR = ("void (anonymous namespace)::gsr_runs<float, 4, 16, false, 64, "
       "true>(float const*)")
ADD = "void at::native::vectorized_elementwise_kernel<4>"


def x(cat, name, ts_ms, dur_ms, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": T0 + ts_ms * MS,
            "dur": dur_ms * MS, "tid": tid, "pid": 1, "args": args}


GSR_ARGS = {"Input Dims": [[1000, 64], [20000], [20000], [], [], [], [1001],
                           []],
            "Input type": ["float", "int", "int", "Scalar", "", "", "long int",
                           "Scalar"],
            "Concrete Inputs": ["", "", "", "1000", "", "", "", "64"]}


def canned() -> dict:
    """Two units of 10 ms: each a custom op (host 1-2 ms) launching the
    gather kernel (device 3 ms) and an add (1 ms, outside the op), and one
    sync; a harness sync at the end. Device busy 2 x 4 ms of 20."""
    ev = [x("user_annotation", tr.WINDOW, 0, 20),
          x("gpu_user_annotation", tr.WINDOW, 0, 20, tid=7)]
    corr = 0
    for u in (0, 10):
        ev.append(x("cpu_op", "repro_torch::gather_segment_reduce", u + 1,
                    1, **GSR_ARGS))
        corr += 1
        ev.append(x("cuda_runtime", "cudaLaunchKernel", u + 1.5, 0.01,
                    correlation=corr))
        ev.append(x("kernel", GSR, u + 2, 3, tid=7, correlation=corr))
        corr += 1
        ev.append(x("cpu_op", "aten::add", u + 2.5, 0.2))
        ev.append(x("cuda_runtime", "cudaLaunchKernel", u + 2.6, 0.01,
                    correlation=corr))
        ev.append(x("kernel", ADD, u + 5, 1, tid=7, correlation=corr))
        ev.append(x("cpu_op", "aten::copy_", u + 3, 4))
        ev.append(x("cuda_runtime", "cudaStreamSynchronize", u + 6, 0.5,
                    correlation=100 + u))
    ev.append(x("user_annotation", tr.SYNC, 19, 0.9))
    ev.append(x("cuda_runtime", "cudaDeviceSynchronize", 19.1, 0.5,
                correlation=999))
    return {"traceEvents": ev}


def record(**kw) -> harness.Record:
    view = tr.View(canned())
    calls = tr.custom_op_calls(canned())[:1]
    base = dict(setup_s=12.5, window_s=view.window_s, units=2, view=view,
                unit_s=0.008, op_calls=calls, flops_per_unit=1e9,
                peak_flops=roofline.FP32_FLOPS)
    base.update(kw)
    return harness.Record(**base)


def read(name, rec):
    path = harness.BENCH / "metrics" / f"{name}.py"
    return harness.load_module(path).read(rec)


def test_view_window_and_busy():
    view = tr.View(canned())
    assert view.window_s == pytest.approx(0.020)
    assert view.busy_s() == pytest.approx(0.008)
    assert len(view.kernels()) == 4


def test_device_idle_over_the_untraced_unit():
    # 8 ms busy over 2 units against 8 ms a unit untraced (the traced
    # window's 20 ms is stretched by the profiler)
    assert read("device_idle", record()) == pytest.approx(50.0)
    assert read("device_idle", record(unit_s=0.004)) == pytest.approx(0.0)


def test_launches():
    assert read("launches", record()) == pytest.approx(2.0)


def test_host_syncs_leave_the_harness_out():
    assert read("host_syncs", record()) == pytest.approx(1.0)


def test_kernel_roofline():
    nbytes = 1000 * 64 * 4 + 20000 * 4 * 2 + 1001 * 8 + 1000 * 64 * 4
    least = max(nbytes / roofline.HBM_BYTES_PER_S,
                20000 * 64 / roofline.FP32_FLOPS)
    # two calls' least time over the gather kernels' 2 x 3 ms (the add
    # launched outside the op is not counted)
    assert read("kernel_roofline", record()) == pytest.approx(
        100 * 2 * least / 0.006)


def _untied(e):
    e["args"]["correlation"] = -1


def _launched_outside_the_op(e):
    e["ts"] += 1.5 * MS


@pytest.mark.parametrize("breaks", [_untied, _launched_outside_the_op])
def test_kernel_roofline_reads_nothing_when_a_port_kernel_is_not_tied(
        breaks):
    """A gather kernel whose launch is not tied to a call of its op (no
    correlation id, or the launch after the op has closed)."""
    trace = canned()
    launch = next(e for e in trace["traceEvents"]
                  if e["cat"] == "cuda_runtime" and e["ts"] == T0 + 1.5 * MS)
    breaks(launch)
    assert read("kernel_roofline", record(view=tr.View(trace))) is None


def test_kernel_roofline_reads_nothing_when_calls_differ_a_unit():
    assert read("kernel_roofline", record(units=3)) is None


def test_mfu():
    assert read("mfu", record()) == pytest.approx(
        100 * 1e9 / 0.008 / roofline.FP32_FLOPS)


def test_end_to_end_readers():
    rec = harness.Record(setup_s=12.5, window_s=30.0, units=3000,
                         latencies_s=[0.01] * 94 + [0.02] * 6,
                         tokens_per_unit=8192)
    assert read("gnn_step_ms", rec) == pytest.approx(10.0)
    assert read("gnn_p95_ms", rec) == pytest.approx(20.0)
    assert read("lm_tok_s", rec) == pytest.approx(3000 * 8192 / 30)
    assert read("setup_s", rec) == pytest.approx(12.5)


def test_readers_find_nothing_without_a_trace():
    rec = harness.Record(setup_s=1.0, window_s=1.0, units=1)
    for name in ("device_idle", "launches", "host_syncs", "kernel_roofline",
                 "mfu"):
        assert read(name, rec) is None


def test_breakdown_names_gaps_by_the_host_op():
    out = tr.breakdown(tr.View(canned()))
    assert out["device_ops"][0][0].startswith("void (anonymous")
    assert out["device_ops"][0][1] == pytest.approx(0.006)
    assert len(out["idle_gaps"]) <= 10
    # the gaps: 0-2 ms (the first op open), 6-12 ms and 16-20 ms (none)
    assert [g[1] for g in out["idle_gaps"]] == pytest.approx(
        [0.006, 0.004, 0.002])
    assert out["idle_gaps"][0][0] == "(no host op)"
    assert out["idle_gaps"][2][0] == "repro_torch::gather_segment_reduce"

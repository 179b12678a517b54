"""The GAT cell's control and planted faults on the card: each must come
out not correct under the cell's limits, and the program correct. The
control is the program with its own TF32 path switched on (the
configuration states fp32 with TF32 off); the faults are
``bench_faults_gat``'s.

At a quarter of the graph:

    python -m pytest -q -m cuda bench/tests/test_bench_gat_chip.py

At the cell's own size, printing each run's readings as a JSON line (the
readings the limits in ``bench/limits/gat-reddit2.infer.json`` were set
from):

    python bench/tests/test_bench_gat_chip.py <mode> <seed>...

``mode``: ``program`` (nothing planted), ``control``, or a fault's name.
"""
from __future__ import annotations

import contextlib
import gc
import json
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(Path(__file__).parent), str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import bench_faults  # noqa: E402
import bench_faults_gat  # noqa: E402
from bench import harness  # noqa: E402

GAT = "gat-reddit2.infer"
SEEDS = (2_900_000_033, 3_300_000_049, 3_700_000_061)
MODES = {"program": contextlib.nullcontext, "control": bench_faults.tf32,
         **bench_faults_gat.GAT_FAULTS}


def _torch_on_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch


def _cell(full: bool) -> harness.Cell:
    cell = harness.Cell.load(GAT)
    if not full:
        cell.config.update(num_nodes=cell.config["num_nodes"] // 4,
                           num_edges=cell.config["num_edges"] // 4)
    return cell


def readings(torch, mode: str, seed: int, full: bool) -> dict:
    """One run's compared numbers, verdict and peak memory."""
    cell = _cell(full)
    dev = torch.device("cuda", 0)
    if torch.cuda.is_initialized():
        torch.cuda.reset_peak_memory_stats(dev)
    with MODES[mode]():
        out = harness.run_cell(torch, cell, seed, 2.0, False, dev,
                               time.perf_counter())
    gc.collect()
    torch.cuda.empty_cache()
    return {"cell": GAT, "mode": mode, "seed": seed, "full": full,
            "correct": out["correct"], "checks": out["checks"],
            "requests": out["attempted"],
            "gnn_step_ms": out["metrics"]["gnn_step_ms"]["value"],
            "memory_peak_bytes": out["device"]["memory_peak_bytes"],
            "card": torch.cuda.get_device_name(0)}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mode", ["control", *sorted(
    bench_faults_gat.GAT_FAULTS)])
def test_control_and_faults_fail(mode, seed):
    torch = _torch_on_card()
    out = readings(torch, mode, seed, full=False)
    assert not out["correct"], out


@pytest.mark.cuda
def test_program_passes_at_reduced_size():
    torch = _torch_on_card()
    out = readings(torch, "program", SEEDS[0], full=False)
    assert out["correct"], out


def main(argv) -> int:
    import runpy
    runpy.run_path(str(ROOT / "bench" / "run.py"),
                   run_name="bench_env")["environment"]()
    import torch
    mode, seeds = argv[0], [int(s) for s in argv[1:]]
    for seed in seeds:
        print(json.dumps(readings(torch, mode, seed, full=True)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

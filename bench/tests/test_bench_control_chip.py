"""The controls and the planted faults on the card: each must come out not
correct under the cells' limits.

* ``sage-reddit2.infer``: the control is the program with its own TF32 path
  switched on (the configuration states fp32 with TF32 off);
* ``qwen3-moe-30b-a3b-4l.train`` (parked, ``bench/parked.json``): the
  control is the reference put in the program's place at fp8 (e4m3
  operands, e5m2 output gradients; bf16 for the products the configuration
  runs in fp32), held to the fp32 reference; the faults of ``bench_faults``
  planted in the program. The program runs with its norms at the
  configuration's eps (``bench_faults.norm_eps``), which its ModelConfig
  does not set.

At reduced sizes (a quarter of the graph; one layer and 2 x 1024 tokens):

    python -m pytest -q -m cuda bench/tests/test_bench_control_chip.py

At the cells' own sizes, printing each run's readings as a JSON line (the
readings the limits in ``bench/limits`` were set from):

    python bench/tests/test_bench_control_chip.py <cell> <mode> <seed>...

``mode``: ``program`` (nothing planted), ``control``, or a fault's name;
for the LM also ``as_is``: the program at its own norm eps (``port_config``'s
refusal of it lifted), against the reference at the configuration's eps
(``checks``) and at the program's (``checks_at_program_eps``).
"""
from __future__ import annotations

import contextlib
import gc
import json
import sys
import time
from pathlib import Path
from unittest import mock

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(Path(__file__).parent), str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import bench_faults  # noqa: E402
from bench import harness  # noqa: E402

GNN, LM = "sage-reddit2.infer", "qwen3-moe-30b-a3b-4l.train"
SEEDS = (2_900_000_033, 3_300_000_049, 3_700_000_061)


def _torch_on_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch


def _cell(name: str, full: bool) -> harness.Cell:
    cell = harness.Cell.load(name, harness.parked_spec())
    if not full and name == GNN:
        cell.config.update(num_nodes=cell.config["num_nodes"] // 4,
                           num_edges=cell.config["num_edges"] // 4)
    if not full and name == LM:
        cell.config.update(num_hidden_layers=1)
        cell.traffic.update(batch=2, batches=4)
    return cell


def readings(torch, name: str, mode: str, seed: int, full: bool) -> dict:
    """One run's compared numbers and verdict."""
    from bench.drivers import lm_train
    from bench.reference import qwen3_moe
    cell = _cell(name, full)
    dev = torch.device("cuda", 0)
    if name == LM and mode == "control":
        config, traffic = cell.config, cell.traffic
        start = lm_train.weights(torch, config, seed, dev)
        pool = lm_train.batches(torch, config, traffic, seed, dev)
        steps = pool[:traffic["check_steps"]]
        want = qwen3_moe.train_steps(config, start, steps,
                                     traffic["optimizer"])
        got = qwen3_moe.train_steps(config, start, steps,
                                    traffic["optimizer"], precision="fp8")
        correct, checks = harness.judge(lm_train.compare(got, want),
                                        cell.limits)
        checks["loss_gap_by_step"] = lm_train.loss_gaps(got, want)
    elif name == LM and mode == "as_is":
        correct, checks = as_is(torch, cell, seed, dev)
    else:
        plant = {"program": contextlib.nullcontext,
                 "control": bench_faults.tf32}
        plant.update(bench_faults.GNN_FAULTS if name == GNN
                     else bench_faults.LM_FAULTS)
        eps = (bench_faults.norm_eps(cell.config["rms_norm_eps"])
               if name == LM else contextlib.nullcontext())
        with eps, plant[mode]():
            out = harness.run_cell(torch, cell, seed, 2.0, False, dev,
                                   time.perf_counter())
        correct, checks = out["correct"], out["checks"]
    gc.collect()
    torch.cuda.empty_cache()
    return {"cell": name, "mode": mode, "seed": seed, "full": full,
            "correct": correct, "checks": checks,
            "card": torch.cuda.get_device_name(0)}


def as_is(torch, cell, seed: int, dev) -> tuple:
    """The LM's checked steps by the program at its own norm eps, held to
    the reference at the configuration's eps and at the program's."""
    from bench.drivers import lm_train
    from bench.reference import qwen3_moe
    with mock.patch.object(lm_train, "program_norm_eps", lambda: {}):
        session = lm_train.setup(cell.config, cell.traffic, seed, dev)
    correct, checks = harness.judge(session.check(), cell.limits)
    own = lm_train.program_norm_eps()["models/layers.py apply_norm"]
    config = dict(cell.config, rms_norm_eps=own)
    start = lm_train.weights(torch, config, seed, dev)
    ref = qwen3_moe.train_steps(
        config, start, session.pool[:cell.traffic["check_steps"]],
        cell.traffic["optimizer"])
    checks["checks_at_program_eps"] = lm_train.compare(session.program, ref)
    checks["loss_gap_by_step_at_program_eps"] = lm_train.loss_gaps(
        session.program, ref)
    return correct, checks


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name, mode", [(GNN, "control"), (LM, "control"),
                                        (LM, "half_batch"),
                                        (LM, "loss_altered")])
def test_control_and_faults_fail(name, mode, seed):
    torch = _torch_on_card()
    out = readings(torch, name, mode, seed, full=False)
    assert not out["correct"], out


@pytest.mark.cuda
@pytest.mark.parametrize("name", [GNN, LM])
def test_program_passes_at_reduced_size(name):
    torch = _torch_on_card()
    out = readings(torch, name, "program", SEEDS[0], full=False)
    assert out["correct"], out


def main(argv) -> int:
    import runpy
    runpy.run_path(str(ROOT / "bench" / "run.py"),
                   run_name="bench_env")["environment"]()
    import torch
    name, mode, seeds = argv[0], argv[1], [int(s) for s in argv[2:]]
    for seed in seeds:
        print(json.dumps(readings(torch, name, mode, seed, full=True)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""A run of each cell with the timed path broken underneath comes out not
correct (CPU, tiny sizes, the program's plain versions; the harness's look
for a card skipped): the check catches each fault the cell can have. A run
with nothing broken comes out correct under the same limits."""
from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(Path(__file__).parent)]

import bench_faults  # noqa: E402
from bench import harness  # noqa: E402

CPU = torch.device("cpu")


def gnn_cell() -> harness.Cell:
    cell = harness.Cell.load("sage-reddit2.infer")
    cell.config.update(num_nodes=2000, num_edges=40000, num_features=24,
                       hidden=16, num_classes=5)
    cell.traffic.update(sample=2, trace_units=2)
    return cell


@pytest.fixture
def tiny_lm(monkeypatch) -> harness.Cell:
    """The LM cell (parked) at tiny widths in fp32 on the plain dropless
    path, the program's norms at the configuration's eps."""
    from repro_torch import configs
    cell = harness.Cell.load("qwen3-moe-30b-a3b-4l.train",
                             harness.parked_spec())
    port = dataclasses.replace(
        configs.get_config(cell.config["port"]), d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, num_experts=8, top_k=2, moe_d_ff=32,
        vocab_size=512, dtype="float32")
    monkeypatch.setattr(configs, "get_config", lambda name: port)
    cell.config.update(hidden_size=64, num_attention_heads=4,
                       num_key_value_heads=2, head_dim=16, num_experts=8,
                       num_experts_per_tok=2, moe_intermediate_size=32,
                       vocab_size=512, num_hidden_layers=2,
                       torch_dtype="float32")
    cell.traffic.update(batch=4, seq=16, batches=8, moe_impl="ragged")
    with bench_faults.norm_eps(cell.config["rms_norm_eps"]):
        yield cell


def run(cell):
    return harness.run_cell(torch, cell, 2 ** 31 + 99, 0.3, False, CPU,
                            time.perf_counter())


def test_gnn_clean_run_is_correct():
    out = run(gnn_cell())
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", sorted(bench_faults.GNN_FAULTS))
def test_gnn_fault_is_caught(fault):
    with bench_faults.GNN_FAULTS[fault]():
        out = run(gnn_cell())
    assert not out["correct"], out["checks"]


def test_lm_clean_run_is_correct(tiny_lm):
    out = run(tiny_lm)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", sorted(bench_faults.LM_FAULTS))
def test_lm_fault_is_caught(tiny_lm, fault):
    with bench_faults.LM_FAULTS[fault]():
        out = run(tiny_lm)
    assert not out["correct"], out["checks"]


def test_lm_driver_refuses_the_program_off_the_configured_eps(tiny_lm):
    """Set-up stops where the program's norms take another eps than the
    configuration states."""
    tiny_lm.config["rms_norm_eps"] = 1e-3
    with pytest.raises(ValueError, match="rms_norm_eps"):
        run(tiny_lm)


def test_traced_run_reports_the_same_check(tiny_lm):
    out = harness.run_cell(torch, tiny_lm, 2 ** 31 + 99, 0.3, True, CPU,
                           time.perf_counter())
    n = tiny_lm.traffic["trace_units"]
    assert out["correct"] and out["attempted"] == 3 * n + 1

"""The plain references against the program's plain paths at tiny sizes on
the CPU: the same inputs and weights give the same logits, loss,
gradients and AdamW step (fp32)."""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(Path(__file__).parent)]

import bench_faults  # noqa: E402
from bench import gen  # noqa: E402
from bench.drivers import gnn_infer, lm_train  # noqa: E402
from bench.reference import qwen3_moe, sage  # noqa: E402

CPU = torch.device("cpu")


def tiny_lm(layers: int = 2, dtype: str = "float32"):
    """(the configuration's dict, the program's ModelConfig) of a tiny
    Qwen3-MoE: the published file with its widths shrunk."""
    from repro_torch import configs
    cfg = json.loads((ROOT / "bench/configs/qwen3-moe-30b-a3b-4l.json")
                     .read_text())
    cfg.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
               head_dim=16, num_experts=8, num_experts_per_tok=2,
               moe_intermediate_size=32, vocab_size=512,
               num_hidden_layers=layers, torch_dtype=dtype)
    port = dataclasses.replace(
        configs.get_config(cfg["port"]), num_layers=layers, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, num_experts=8, top_k=2,
        moe_d_ff=32, vocab_size=512, dtype=dtype)
    return cfg, port


@pytest.fixture
def at_config_eps():
    """The program's norms at the configuration's eps, which its
    ModelConfig does not set (``bench_faults.norm_eps``)."""
    cfg, _ = tiny_lm()
    with bench_faults.norm_eps(cfg["rms_norm_eps"]):
        yield


def tiny_batch(cfg, seed: int, b: int = 2, s: int = 16):
    pool = lm_train.batches(torch, cfg, {"batches": 1, "batch": b, "seq": s,
                                         "token_zipf": 1.1}, seed, CPU)
    return pool[0]


def test_sage_matches_the_program_plain_forward():
    from repro_torch.models import gnn
    config = json.loads((ROOT / "bench/configs/sage-reddit2.json")
                        .read_text())
    config.update(num_nodes=500, num_edges=6000, num_features=24, hidden=16,
                  num_classes=5)
    data = gnn_infer.inputs(torch, config, 3, CPU)
    dims = gnn_infer.layer_dims(config)
    model = gnn.GNN("sage", dims)
    model.load_state_dict(data["weights"])
    ei = torch.stack([data["src"], data["dst"]])
    with torch.no_grad():
        got = model(data["x"], ei, config["num_nodes"], impl="ref")
    want = sage.forward(data["x"], data["src"], data["dst"],
                        config["num_nodes"], sage.layers_of(data["weights"], 3))
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5 * want.abs().max())
    # a node with no incoming edge takes 0 as its mean
    assert int((torch.bincount(data["dst"].long(), minlength=500) == 0)
               .sum()) > 0


def test_the_graph_recipe():
    deg = gen.in_degrees(torch, 2000, 50000, 1.3, 0.25,
                         torch.Generator().manual_seed(0), CPU)
    assert int(deg.sum()) == 50000 and int(deg.max()) <= 50000
    src, dst = gen.graph(torch, deg, torch.Generator().manual_seed(1), CPU)
    src2, dst2 = gen.graph(torch, deg, torch.Generator().manual_seed(2), CPU)
    assert bool((dst[1:] >= dst[:-1]).all())
    # another seed draws other sources for the same degrees
    assert torch.equal(dst, dst2) and not torch.equal(src, src2)
    assert torch.equal(torch.bincount(dst.long(), minlength=2000), deg)


def test_qwen3_moe_loss_and_gradients_match_the_program(at_config_eps):
    from repro_torch.models import lm
    cfg, port = tiny_lm()
    params = lm_train.weights(torch, cfg, 11, CPU)
    batch = tiny_batch(cfg, 11)
    leaves = {n: p.clone().requires_grad_() for n, p in params.items()}
    got, _ = lm.loss_fn(leaves, port, batch, remat_policy="none",
                        moe_impl="ragged",
                        aux_weight=cfg["router_aux_loss_coef"])
    g_got = torch.autograd.grad(got, list(leaves.values()))
    ref_leaves = {n: p.clone().requires_grad_() for n, p in params.items()}
    want = qwen3_moe.loss(ref_leaves, batch["tokens"], batch["labels"], cfg,
                          qwen3_moe.Products())
    g_want = torch.autograd.grad(want, list(ref_leaves.values()))
    assert float(got.detach()) == pytest.approx(float(want.detach()), rel=1e-5)
    for name, a, b in zip(leaves, g_got, g_want):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-5 * b.abs().max()), name


def test_qwen3_moe_steps_match_the_program_trainer(at_config_eps):
    """Three AdamW steps of the reference against the program's trainer on
    the same weights and batches: losses, first gradients, changes."""
    from repro_torch.optim import adamw
    from repro_torch.train import LMTask, TrainerConfig
    from repro_torch.train.trainer import Trainer, TrainState
    cfg, port = tiny_lm()
    traffic = json.loads((ROOT / "bench/traffic/tokens-8x1024-zipf.json")
                         .read_text())
    traffic.update(batches=3, batch=2, seq=16)
    opt = traffic["optimizer"]
    pool = lm_train.batches(torch, cfg, traffic, 5, CPU)
    params = {n: p.clone().requires_grad_()
              for n, p in lm_train.weights(torch, cfg, 5, CPU).items()}
    tcfg = TrainerConfig(steps=10, warmup_steps=0, lr_schedule="constant",
                         opt=adamw.AdamWConfig(
                             lr=opt["lr"], b1=opt["b1"], b2=opt["b2"],
                             eps=opt["eps"], weight_decay=opt["weight_decay"],
                             grad_clip=opt["grad_clip"]))
    task = LMTask(port, moe_impl="ragged",
                  aux_weight=cfg["router_aux_loss_coef"], device="cpu")
    trainer = Trainer(task, lm_train.Pool(pool), tcfg)
    state = TrainState(params, adamw.init(params, tcfg.opt), 0,
                       torch.Generator().manual_seed(0).get_state())
    losses = []
    for step in range(3):
        state, metrics = trainer.step(state, step)
        losses.append(float(metrics["loss"]))
        if step == 0:
            first = {n: lm_train.norm(torch, m) / (1 - opt["b1"])
                     for n, m in state.opt_state.mu.items()}
    start = lm_train.weights(torch, cfg, 5, CPU)
    change = {n: lm_train.norm(torch, p.detach() - start[n])
              for n, p in state.params.items()}
    ref = qwen3_moe.train_steps(cfg, start, pool, opt)
    assert losses == pytest.approx(ref["loss"], rel=1e-5)
    for n in first:
        assert first[n] == pytest.approx(ref["first_grad_norm"][n], rel=1e-4,
                                         abs=1e-6), n
        assert change[n] == pytest.approx(ref["change_norm"][n], rel=1e-4,
                                          abs=1e-6), n
    readings = lm_train.compare({"loss": losses, "first_grad_norm": first,
                                 "change_norm": change}, ref)
    assert max(readings.values()) < 1e-4


def test_the_fp8_control_moves_the_readings():
    cfg, _ = tiny_lm()
    start = lm_train.weights(torch, cfg, 5, CPU)
    pool = [tiny_batch(cfg, 5)]
    opt = json.loads((ROOT / "bench/traffic/tokens-8x1024-zipf.json")
                     .read_text())["optimizer"]
    a = qwen3_moe.train_steps(cfg, start, pool, opt)
    b = qwen3_moe.train_steps(cfg, start, pool, opt, precision="fp8")
    readings = lm_train.compare(b, a)
    assert readings["loss_gap"] > 1e-4 and readings["grad_gap"] > 1e-3

"""LM training steps: ``repro_torch.train.Trainer.step`` on ``LMTask`` with
AdamW, one step a unit of work.

Set-up builds one trainer and one state from the seed (the weights on the
card in two draws, one a dtype; the token batches), and runs the traffic's
``check_steps`` first steps through the same ``Trainer.step`` and feed as
the window: they are the warm-up (the first builds nothing but loads the
kernels and warms the allocator) and what the check follows. Their losses,
each parameter's first clipped gradient (read from the first moment after
step 1) and each parameter's change after the last of them (against the
initial weights, drawn again) are kept; the window then continues the same
state. The check frees the program's state and runs the plain fp32
reference (``bench/reference/qwen3_moe.py``) through the same steps on the
same weights and batches.

Config keys: Hugging Face's ``config.json`` names, and ``port`` (the
program's architecture name). Traffic keys: ``batch``, ``seq``,
``token_zipf``, ``batches`` (the pool the steps cycle through), ``moe_impl``,
``remat_policy``, ``optimizer``, ``check_steps``, ``trace_units``.
"""
from __future__ import annotations

import dataclasses
import math
import statistics

from bench import gen, harness, roofline
from bench.reference import qwen3_moe as reference

# the program's ModelConfig field for each key of the configuration's file
PORT_FIELDS = {
    "hidden_size": "d_model", "num_hidden_layers": "num_layers",
    "num_attention_heads": "num_heads", "num_key_value_heads": "num_kv_heads",
    "head_dim": "head_dim", "vocab_size": "vocab_size",
    "num_experts": "num_experts", "num_experts_per_tok": "top_k",
    "moe_intermediate_size": "moe_d_ff", "norm_topk_prob": "norm_topk",
    "rope_theta": "rope_theta", "hidden_act": "act",
    "attention_bias": "use_bias", "tie_word_embeddings": "tie_embeddings",
    "torch_dtype": "dtype",
}
# the share of the median leaf's first-gradient norm under which a leaf's
# gradient is rounding alone
NEGLIGIBLE_GRAD = 1e-3


def port_config(config: dict):
    """The program's ModelConfig of the configuration: its named
    architecture cut to the file's depth, every other field held equal to
    the file's."""
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get_config(config["port"]),
                              num_layers=config["num_hidden_layers"])
    for key, field in PORT_FIELDS.items():
        if getattr(cfg, field) != config[key]:
            raise ValueError(f"{config['name']}: {key} = {config[key]!r} "
                             f"but the program's {field} is "
                             f"{getattr(cfg, field)!r}")
    if not cfg.qk_norm or cfg.first_dense or cfg.moe_every != 1:
        raise ValueError(f"{config['name']}: the program's layers are not "
                         "Qwen3-MoE's (q/k norms, every layer an MoE layer)")
    for norm, eps in program_norm_eps().items():
        if eps != config["rms_norm_eps"]:
            raise ValueError(f"{config['name']}: rms_norm_eps = "
                             f"{config['rms_norm_eps']!r} but the program's "
                             f"{norm} takes {eps!r}, and no field of its "
                             "ModelConfig sets it")
    return cfg


def program_norm_eps() -> dict:
    """The eps of the program's RMSNorms, which its ModelConfig does not
    set: the defaults of ``models/layers.py`` ``apply_norm`` (the block
    and final norms) and ``simple_rms`` (the q/k norms)."""
    import inspect

    from repro_torch.models import layers
    return {f"models/layers.py {name}": inspect.signature(
                getattr(layers, name)).parameters["eps"].default
            for name in ("apply_norm", "simple_rms")}


def weights(torch, config: dict, seed: int, device) -> dict:
    """The initial parameters from the seed: one N(0, 1) draw for the bf16
    leaves and one for the fp32 ones (``reference.param_specs``), each leaf
    a view scaled in place; the norms are ones."""
    specs = reference.param_specs(config)
    g = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for dt in sorted({d for _, _, d, _ in specs}):
        out.update(gen.flat_normal(
            torch, [(n, s, std) for n, s, d, std in specs if d == dt],
            getattr(torch, dt), g, device))
    return {n: out[n] for n, _, _, _ in specs}


def batches(torch, config: dict, traffic: dict, seed: int, device) -> list:
    """The pool of token batches: Zipf ranks through a permutation of the
    vocabulary, both from the seed (a generator apart from the weights')."""
    g = torch.Generator(device=device).manual_seed(seed + 1)
    vocab = config["vocab_size"]
    perm = torch.randperm(vocab, generator=g, device=device)
    n, b, s = traffic["batches"], traffic["batch"], traffic["seq"]
    ids = gen.zipf_tokens(torch, vocab, traffic["token_zipf"],
                          (n, b, s + 1), perm, g, device)
    return [{"tokens": ids[i, :, :-1].contiguous(),
             "labels": ids[i, :, 1:].contiguous()} for i in range(n)]


class Pool:
    """The trainer's data: step ``i`` takes batch ``i`` of the pool,
    cycling."""

    def __init__(self, items):
        self.items = items

    def batch(self, step: int):
        return self.items[step % len(self.items)]


def norm(torch, x) -> float:
    return float(torch.linalg.vector_norm(x, dtype=torch.float64))


def loss_gaps(program: dict, ref: dict) -> list:
    """|program - reference| loss over the reference's, step by step."""
    if len(program["loss"]) != len(ref["loss"]):
        return [math.inf]
    return [harness.worst(0.0, abs(p - r) / abs(r))
            for p, r in zip(program["loss"], ref["loss"])]


def compare(program: dict, ref: dict) -> dict:
    """The numbers the check compares (see ``check``)."""
    g_ref = ref["first_grad_norm"]
    g_med = statistics.median(g_ref.values())
    live = [n for n, v in g_ref.items() if v >= NEGLIGIBLE_GRAD * g_med]

    def gap(prog, want):
        med = statistics.median(want[n] for n in live)
        out = 0.0
        for n in live:
            out = harness.worst(out, abs(prog[n] - want[n])
                                / max(want[n], med))
        return out
    return {"loss_gap": loss_gaps(program, ref)[0],
            "grad_gap": gap(program["first_grad_norm"], g_ref),
            "change_gap": gap(program["change_norm"], ref["change_norm"])}


class Session:
    def __init__(self, torch, config, traffic, seed, device):
        from repro_torch.models import lm
        from repro_torch.optim import adamw
        from repro_torch.train import LMTask, TrainerConfig
        from repro_torch.train.trainer import Trainer, TrainState
        self.torch, self.config, self.traffic = torch, config, traffic
        self.seed, self.device = seed, device
        self.cuda = torch.device(device).type == "cuda"
        phases = harness.Phases(self.sync)
        cfg = port_config(config)
        params = weights(torch, config, seed, device)
        skeleton = {n: (tuple(p.shape), p.dtype) for n, p in
                    lm.LM(cfg, device="meta", seed=None).named_parameters()}
        mine = {n: (tuple(p.shape), p.dtype) for n, p in params.items()}
        if skeleton != mine:
            diff = sorted(str(kv) for kv in set(skeleton.items())
                          ^ set(mine.items()))
            raise ValueError(f"{config['name']}: the parameters made here "
                             f"differ from the program's LM: {diff[:4]}")
        params = {n: p.requires_grad_() for n, p in params.items()}
        phases.end("weights")
        self.pool = batches(torch, config, traffic, seed, device)
        phases.end("batches")
        opt = traffic["optimizer"]
        if (opt["schedule"], opt["warmup_steps"], opt["state_dtype"]) != (
                "constant", 0, "float32"):
            raise ValueError("the reference follows AdamW at a constant lr "
                             "with fp32 moments")
        self.opt = opt
        tcfg = TrainerConfig(
            steps=10 ** 9, seed=seed, warmup_steps=opt["warmup_steps"],
            lr_schedule=opt["schedule"],
            opt=adamw.AdamWConfig(
                lr=opt["lr"], b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
                weight_decay=opt["weight_decay"], grad_clip=opt["grad_clip"],
                state_dtype=opt["state_dtype"]))
        task = LMTask(cfg, remat_policy=traffic["remat_policy"],
                      moe_impl=traffic["moe_impl"],
                      aux_weight=config["router_aux_loss_coef"],
                      device=device)
        self.trainer = Trainer(task, Pool(self.pool), tcfg)
        rng = torch.Generator().manual_seed(seed).get_state()
        self.state = TrainState(params, adamw.init(params, tcfg.opt), 0, rng)
        phases.end("program")
        # the checked steps: the window's own call and feed
        losses = []
        for step in range(traffic["check_steps"]):
            self.state, metrics = self.trainer.step(self.state, step)
            losses.append(metrics["loss"])
            if step == 0:
                first = {n: norm(torch, m) / (1.0 - opt["b1"])
                         for n, m in self.state.opt_state.mu.items()}
        phases.end("checked steps")
        start = weights(torch, config, seed, device)
        change = {n: norm(torch, p.detach().float() - start[n].float())
                  for n, p in self.state.params.items()}
        del start
        self.program = {"loss": [float(v) for v in losses],
                        "first_grad_norm": first, "change_norm": change}
        phases.end("checked steps' readings")
        self.step = traffic["check_steps"]
        self.window_losses = []
        self.tokens_per_unit = traffic["batch"] * traffic["seq"]
        self.flops_per_unit = self.tokens_per_unit * \
            roofline.qwen3_moe_train_flops_per_token(config, traffic["seq"])
        self.peak_flops = roofline.BF16_FLOPS

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def unit(self):
        self.state, metrics = self.trainer.step(self.state, self.step)
        self.window_losses.append(metrics["loss"])
        self.step += 1

    def latencies(self):
        return None

    def failed(self) -> int:
        """Steps of the window whose loss is not finite."""
        return sum(1 for v in self.window_losses
                   if not math.isfinite(float(v)))

    def check(self) -> dict:
        """Frees the program's trainer and state, follows the checked steps
        with the reference and compares: ``loss_gap``, the first step's
        |program - reference| loss over the reference's (the later steps'
        are printed, not compared: Adam's first update, ≈ lr·sign(g),
        turns the rounding of gradients near 0 into whole steps, and their
        losses part by seed); ``grad_gap`` and ``change_gap``, by the worst
        leaf, the gap between
        the program's and the reference's norms of a leaf's first clipped
        gradient and of its change over the steps, over the larger of the
        reference's norm of that leaf and of the median leaf. Leaves whose
        reference gradient is under NEGLIGIBLE_GRAD of the median leaf's
        (rounding alone moves them under Adam) are left out of both."""
        torch = self.torch
        program = self.program
        del self.state, self.trainer, self.window_losses
        if self.cuda:
            torch.cuda.empty_cache()
        start = weights(torch, self.config, self.seed, self.device)
        ref = reference.train_steps(self.config, start,
                                    self.pool[:self.traffic["check_steps"]],
                                    self.opt)
        del start
        harness.say("loss gap by step (the first compared): " + ", ".join(
            f"{g:.3g}" for g in loss_gaps(program, ref)))
        return compare(program, ref)


def setup(config, traffic, seed, device):
    import torch
    return Session(torch, config, traffic, seed, device)

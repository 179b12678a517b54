"""End-to-end LM training driver, ported from ``repro.launch.train``: a
thin CLI over :func:`repro_torch.train.fit` (the trainer owns the step,
checkpoint/resume and the fault-tolerant loop; this file parses flags and
wires the provider/task/trainer trio).

  # ~100M-param LM for a few hundred steps, on the card:
  python -m repro_torch.launch.train --arch qwen3-8b --reduced --steps 300

  # the same on the CPU (the plain versions):
  python -m repro_torch.launch.train --arch qwen3-8b --reduced --device cpu

  # a 2×2 ("data", "model") mesh of 4 ranks (the sharded step):
  torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch qwen3-moe-30b-a3b --reduced --mesh host --steps 20

Weights come from the trainer's seed (``torch.Generator``s), token
batches from :class:`~repro_torch.train.providers.TokenProvider`. With
``--mesh host`` the launcher (``torchrun``) must have started the ranks:
each calls ``init_process_group`` from the launcher's environment (NCCL
with a card a rank, else gloo) and trains its shard of a
``make_host_mesh(2, 2)``; each keeps its checkpoints in
``<ckpt-dir>/rank<r>``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch import configs as cfglib
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core.device import resolve_device
from repro_torch.data.tokens import TokenDatasetConfig
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.train import LMTask, TokenProvider, TrainerConfig, fit


def reduced_100m(cfg):
    """~100M-param config of the same family (example driver scale)."""
    over = dict(num_layers=max(4, min(cfg.num_layers, 8)), d_model=512,
                num_heads=8, num_kv_heads=min(cfg.num_kv_heads, 4) or 4,
                head_dim=64, d_ff=2048, vocab_size=32768, max_seq=2048,
                dtype="float32")
    if cfg.num_experts:
        over.update(num_experts=8, top_k=2, moe_d_ff=512)
    if cfg.family == "hybrid":
        over.update(num_layers=8)
    return dataclasses.replace(cfg, **over)


def host_mesh(device):
    """The 2×2 ("data", "model") mesh of ``--mesh host`` over the ranks
    the launcher started; raises when there are none."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    if not dist.is_initialized():
        if "RANK" not in os.environ:
            raise RuntimeError(
                "--mesh host needs its 4 ranks started by a launcher: "
                "torchrun --nproc-per-node 4 -m repro_torch.launch.train "
                "--mesh host ...")
        backend = "nccl" if device.type == "cuda" and \
            torch.cuda.device_count() >= int(os.environ["WORLD_SIZE"]) \
            else "gloo"
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                                  % torch.cuda.device_count())
        dist.init_process_group(backend)
    return make_host_mesh(2, 2, device_type=device.type)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=cfglib.ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true",
                    help="~100M-param variant (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--mesh", choices=["none", "host"], default="none",
                    help="host: a 2x2 (data, model) mesh over 4 ranks "
                    "started by torchrun")
    ap.add_argument("--moe-impl", choices=["capacity", "ragged", "cuda"],
                    default="capacity",
                    help="cuda: the dropless path on the kernels (the card)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    device = resolve_device(args.device, "repro_torch.launch.train")
    cfg = cfglib.get_config(args.arch)
    if args.reduced:
        cfg = reduced_100m(cfg)
    if cfg.family == "audio":
        raise SystemExit("use examples/gnn_training.py-style drivers for "
                         "enc-dec")

    n_params = sum(p.numel() for p in
                   lm.LM(cfg, device="meta", seed=None).parameters())
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"vocab={cfg.padded_vocab} layers={cfg.num_layers}")

    task = LMTask(cfg, moe_impl=args.moe_impl, device=device)
    mesh = host_mesh(device) if args.mesh == "host" else None
    data = TokenProvider(TokenDatasetConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch))

    trainer_cfg = TrainerConfig(
        steps=args.steps, opt=adamw.AdamWConfig(lr=args.lr),
        warmup_steps=20, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, log_every=args.log_every)

    own_dir = args.ckpt_dir
    if mesh is not None and own_dir:       # the trainer's per-rank directory
        import torch.distributed as dist
        own_dir = os.path.join(own_dir, f"rank{dist.get_rank()}")
    start = ckpt.latest_step(own_dir) if own_dir else None
    if start:
        print(f"resuming from checkpoint step {start}")
    result = fit(task, data, trainer_cfg, mesh=mesh,
                 resume=bool(args.ckpt_dir))
    ckpt.wait_pending()
    print(f"final loss {result.losses[-1]:.4f} "
          f"(first {result.losses[0]:.4f})")
    return result.losses


if __name__ == "__main__":
    main()

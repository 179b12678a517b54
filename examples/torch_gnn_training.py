"""End-to-end GNN training through the port's ``repro_torch.train`` API:
DatasetProvider → Task → Trainer on the planned models, every op's
forward and backward on the card's kernels. The port of
``examples/gnn_training.py``.

The example *asserts the training contract itself*:

  * loss decreases for every trained family (gcn homogeneous + rgcn
    relational by default);
  * the step is built **exactly once per graph shape bucket** — the
    provider's plan memo plus the task's per-bucket plan canonicalization
    mean steps never re-plan (``len(FitResult.buckets)`` equals the
    provider's shapes; the port's counterpart of the reference's one
    trace a bucket);
  * a mid-run kill (``--kill-at``, exercised via a subprocess) followed
    by ``fit(resume=True)`` restores from the checkpoint to a loss
    trajectory identical (≤ 1e-6, in practice bitwise) to the
    uninterrupted run — providers are deterministic in the step index
    and the generator state rides the checkpointed TrainState.

Usage:
  PYTHONPATH=src python examples/torch_gnn_training.py      # full smoke
  PYTHONPATH=src python examples/torch_gnn_training.py --models gcn --steps 60
  PYTHONPATH=src python examples/torch_gnn_training.py --resume --ckpt-dir D
  ... --device cpu                                           # on the CPU
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

from repro_torch import fit  # noqa: F401 (the facade export)
from repro_torch import launch_counts, reset_launch_counts
from repro_torch.optim import adamw
from repro_torch.train import (GraphEpochProvider, NodeClassification,
                               Trainer, TrainerConfig)

SHAPES = ((96, 384), (128, 512))


def build(model: str, args, ckpt_dir=None):
    typed = model in ("rgcn", "rgat")
    data = GraphEpochProvider(
        shapes=SHAPES, graphs_per_shape=2, feat=args.feat,
        num_classes=args.classes, typed=typed, num_relations=4,
        seed=args.seed)
    task = NodeClassification.from_provider(
        data, model=model, hidden=args.hidden,
        impl=None if args.impl == "pallas" else args.impl,
        device=args.device)
    cfg = TrainerConfig(
        steps=args.steps, warmup_steps=4,
        opt=adamw.AdamWConfig(lr=args.lr, weight_decay=0.0),
        seed=args.seed, ckpt_dir=ckpt_dir, ckpt_every=args.ckpt_every)
    return task, data, cfg


def train_full(model: str, args):
    task, data, cfg = build(model, args)
    res = Trainer(task, data, cfg).fit()
    n_buckets = len(SHAPES)
    assert res.losses[-1] < res.losses[0], (
        f"{model}: loss did not decrease "
        f"({res.losses[0]:.4f} -> {res.losses[-1]:.4f})")
    assert len(res.buckets) == n_buckets, (
        f"{model}: expected one built step per shape bucket "
        f"({n_buckets}), got buckets={res.buckets}")
    print(f"[{model}] loss {res.losses[0]:.4f} -> {res.losses[-1]:.4f}  "
          f"buckets={len(res.buckets)}  OK")
    return res


def _common(args):
    return ["--steps", str(args.steps), "--lr", str(args.lr),
            "--seed", str(args.seed), "--hidden", str(args.hidden),
            "--impl", args.impl, "--ckpt-every", str(args.ckpt_every)] + \
        (["--device", args.device] if args.device else [])


def kill_and_resume(args):
    """Child process trains gcn and dies mid-run; we resume from its
    checkpoint and require the combined trajectory to match the
    uninterrupted run's to <= 1e-6."""
    full = train_full("gcn", args)
    kill_at = args.steps // 2 - 1
    with tempfile.TemporaryDirectory(prefix="repro_train_ckpt_") as d:
        cmd = [sys.executable, os.path.abspath(__file__), "--models", "gcn",
               "--ckpt-dir", d, "--kill-at", str(kill_at)] + _common(args)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr
        task, data, cfg = build("gcn", args, ckpt_dir=d)
        res = Trainer(task, data, cfg).fit(resume=True)
        expect_start = (kill_at // args.ckpt_every) * args.ckpt_every
        assert res.start_step == expect_start > 0, (
            res.start_step, expect_start)
        tail = full.losses[res.start_step:]
        assert len(tail) == len(res.losses)
        worst = max(abs(a - b) for a, b in zip(tail, res.losses))
        assert worst <= 1e-6, (
            f"resumed trajectory diverged: max |Δloss| = {worst:.2e}")
        print(f"[resume] killed at step {kill_at}, restored step "
              f"{res.start_step}, max |Δloss| vs uninterrupted run "
              f"{worst:.2e}  OK")


def run_killed(model: str, args):
    """The subprocess leg: train with checkpoints, hard-exit mid-run."""
    task, data, cfg = build(model, args, ckpt_dir=args.ckpt_dir)

    def cb(step, metrics, verdict):
        if step >= args.kill_at:
            # simulate a hard crash: no cleanup, no final checkpoint
            os._exit(0)

    Trainer(task, data, cfg).fit(metrics_cb=cb)
    raise SystemExit(f"kill at step {args.kill_at} never happened")


def run_resume(args):
    """Explicit --resume leg: continue a run from --ckpt-dir."""
    model = args.models.split(",")[0]
    task, data, cfg = build(model, args, ckpt_dir=args.ckpt_dir)
    res = Trainer(task, data, cfg).fit(resume=True)
    assert res.start_step > 0, "nothing to resume from"
    # the epoch cycles through several distinct graphs, so compare
    # epoch-mean losses, not raw endpoints (different graphs)
    n = len(data)
    assert len(res.losses) >= 2 * n, "resumed run too short to judge"
    first = sum(res.losses[:n]) / n
    last = sum(res.losses[-n:]) / n
    assert last < first, (first, last)
    print(f"[{model}] resumed from step {res.start_step}, "
          f"epoch-mean loss {first:.4f} -> {last:.4f}  OK")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", default="gcn,rgcn",
                    help="comma-separated: gcn gin sage gat rgcn rgat")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--feat", type=int, default=16)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--impl", default="pallas", choices=["ref", "pallas"],
                    help="pallas: the port's kernels (the plain versions "
                         "on the CPU); ref: the plain versions")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=8)
    ap.add_argument("--kill-at", type=int, default=None,
                    help="(internal) hard-exit at this step")
    ap.add_argument("--resume", action="store_true",
                    help="resume the first of --models from --ckpt-dir")
    ap.add_argument("--skip-kill-test", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    if args.kill_at is not None:
        run_killed(args.models.split(",")[0], args)
        return
    if args.resume:
        if not args.ckpt_dir:
            raise SystemExit("--resume needs --ckpt-dir")
        run_resume(args)
        return

    reset_launch_counts()
    models = [m for m in args.models.split(",") if m]
    for model in models:
        if model != "gcn" or args.skip_kill_test:
            train_full(model, args)
    if not args.skip_kill_test and "gcn" in models:
        kill_and_resume(args)
    print("kernel launches:", json.dumps(launch_counts()))
    print("all training checks passed")


if __name__ == "__main__":
    main()

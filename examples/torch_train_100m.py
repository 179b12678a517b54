"""End-to-end driver on the PyTorch port: train a ~100M-parameter LM for a
few hundred steps on the deterministic synthetic Markov language, with
checkpointing + the fault-tolerant loop. Loss decreases by several nats.
The port of ``examples/train_100m.py``.

    PYTHONPATH=src python examples/torch_train_100m.py [--steps 300] [--device cpu]
"""
import argparse
import json
import tempfile

from repro_torch import launch_counts, reset_launch_counts
from repro_torch.launch import train

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=300)
ap.add_argument("--arch", default="qwen3-8b")
ap.add_argument("--device", default=None,
                help="default: the card; 'cpu' runs the plain versions")
args = ap.parse_args()

reset_launch_counts()
with tempfile.TemporaryDirectory(prefix="repro_100m_") as ckpt_dir:
    losses = train.main([
        "--arch", args.arch, "--reduced",
        "--steps", str(args.steps), "--batch", "8", "--seq", "256",
        "--lr", "1e-3", "--ckpt-dir", ckpt_dir,
        "--ckpt-every", "100", "--log-every", "20"]
        + (["--device", args.device] if args.device else []))
print("kernel launches:", json.dumps(launch_counts()))
print(f"loss: {losses[0]:.3f} → {losses[-1]:.3f} over {args.steps} steps")

"""MoE training with GeoT dispatch/combine on the PyTorch port: a reduced
qwen3-moe-30b-a3b trains for a few dozen steps; the expert combine is the
paper's fused ``index_weight_segment_reduce`` (the gather kernel on the
card) and the dropless path runs the expert products as one grouped GEMM
over expert segments (segment_matmul). The port of
``examples/moe_training.py``.

    PYTHONPATH=src python examples/torch_moe_training.py [--steps 60]
        [--moe-impl capacity|ragged|cuda] [--device cpu]

``--moe-impl`` defaults to the dropless path: on the card its kernels
(``cuda``), on the CPU its plain version (``ragged``).
"""
import argparse
import json
import tempfile

from repro_torch import launch_counts, reset_launch_counts
from repro_torch.core.device import resolve_device
from repro_torch.launch import train

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=60)
ap.add_argument("--moe-impl", choices=["capacity", "ragged", "cuda"],
                default=None)
ap.add_argument("--device", default=None,
                help="default: the card; 'cpu' runs the plain versions")
args = ap.parse_args()
dev = resolve_device(args.device, "examples/torch_moe_training.py")
moe_impl = args.moe_impl or ("cuda" if dev.type == "cuda" else "ragged")

reset_launch_counts()
with tempfile.TemporaryDirectory(prefix="repro_moe_example_") as ckpt_dir:
    losses = train.main([
        "--arch", "qwen3-moe-30b-a3b", "--reduced",
        "--steps", str(args.steps), "--batch", "8", "--seq", "128",
        "--lr", "1e-3", "--moe-impl", moe_impl,
        "--ckpt-dir", ckpt_dir, "--log-every", "10",
        "--device", str(dev)])
print("kernel launches:", json.dumps(launch_counts()))
print(f"MoE ({moe_impl} dispatch) loss: "
      f"{losses[0]:.3f} → {losses[-1]:.3f}")

"""Batched LM serving on the PyTorch port: prefill a batch of prompts into
the KV cache, then decode greedily — the serve step that the decode_32k /
long_500k dry-run cells trace at production scale. The port of
``examples/lm_serving.py``.

    PYTHONPATH=src python examples/torch_lm_serving.py [--arch rwkv6-3b] [--device cpu]
"""
import argparse
import json

from repro_torch import launch_counts, reset_launch_counts
from repro_torch.launch import serve

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="qwen3-8b")
ap.add_argument("--batch", type=int, default=4)
ap.add_argument("--gen", type=int, default=16)
ap.add_argument("--device", default=None,
                help="default: the card; 'cpu' runs the plain versions")
args = ap.parse_args()

reset_launch_counts()
serve.main(["--arch", args.arch, "--reduced", "--batch", str(args.batch),
            "--prompt-len", "16", "--gen", str(args.gen)]
           + (["--device", args.device] if args.device else []))
print("kernel launches:", json.dumps(launch_counts()))

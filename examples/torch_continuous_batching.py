"""Continuous-batching LM serving on the PyTorch port: requests with
different prompt lengths and budgets stream through a fixed-size decode
batch; slots are reused the tick after a request finishes (vLLM-style
iteration-level scheduling on top of the per-slot decode_step). The port
of ``examples/continuous_batching.py``.

The GNN twin of this demo is ``examples/torch_gnn_serving.py``:
variable-shape *graphs* streaming through ``repro_torch.serve.GNNServer``.

    PYTHONPATH=src python examples/torch_continuous_batching.py [--arch qwen3-8b] [--device cpu]
"""
import argparse
import json
import time

import numpy as np

from repro_torch import configs as cfglib
from repro_torch import launch_counts, reset_launch_counts
from repro_torch.core.device import resolve_device
from repro_torch.models import lm
from repro_torch.serve.lm import ContinuousBatcher, Request

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="qwen3-8b", choices=cfglib.ARCH_NAMES)
ap.add_argument("--device", default=None,
                help="default: the card; 'cpu' runs the plain versions")
args = ap.parse_args()
dev = resolve_device(args.device, "examples/torch_continuous_batching.py")

cfg = cfglib.get_config(args.arch).reduced()
model = lm.LM(cfg, device=dev, seed=0)
rng = np.random.default_rng(0)

reset_launch_counts()
batcher = ContinuousBatcher(model, batch_size=4, max_len=64)
for uid in range(10):
    batcher.submit(Request(
        uid=uid,
        prompt=rng.integers(0, cfg.vocab_size,
                            rng.integers(3, 12)).astype(np.int32),
        max_new_tokens=int(rng.integers(4, 10)),
        on_token=lambda uid, tok: None,
    ))

t0 = time.perf_counter()
ticks = 0
while batcher.queue or any(not s.free for s in batcher.slots):
    n_active = batcher.tick()
    ticks += 1
dt = time.perf_counter() - t0

total_tokens = sum(len(v) for v in batcher.finished.values())
print("kernel launches:", json.dumps(launch_counts()))
print(f"served {len(batcher.finished)} requests in {ticks} ticks "
      f"({dt:.2f}s, {total_tokens} tokens, batch=4 slots)")
for uid in sorted(batcher.finished)[:4]:
    print(f"  req {uid}: {batcher.finished[uid]}")

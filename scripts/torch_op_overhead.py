"""Host cost of one kernel launch through the port's wrappers: the host
microseconds a call of a small gather (``gather_segment_reduce_cuda``,
the launcher, and ``kernels.ops.gather_segment_reduce``, the public
wrapper; 64 rows of F = 32 into 32 segments) takes, timed on the host
clock over 2,000 calls a round (the card runs each launch in a few
microseconds, so the loop is bound by the host), median of 5 rounds.

    python scripts/torch_op_overhead.py [--src DIR]

``--src`` points at another tree's ``src`` (an older commit unpacked
beside this one), so that two versions are timed in one call to the card.
Prints one JSON line with the card's name and power limit.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ap = argparse.ArgumentParser()
ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                      / "src"))
ap.add_argument("--calls", type=int, default=2000)
ap.add_argument("--rounds", type=int, default=5)
args = ap.parse_args()
sys.path.insert(0, args.src)

import torch  # noqa: E402

from repro_torch.kernels import gather_segment_reduce as gsr  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("no CUDA device; this script times launches on the card")
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
h = torch.randn(64, 32, generator=gen, device=dev)
seg = torch.sort(torch.randint(0, 32, (64,), generator=gen, device=dev)
                 )[0].to(torch.int32)
gidx = torch.randint(0, 64, (64,), generator=gen, device=dev,
                     dtype=torch.int32)
rp = gsr.row_offsets(seg, 32)


def host_us(fn) -> float:
    for _ in range(200):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(args.rounds):
        t0 = time.perf_counter()
        for _ in range(args.calls):
            fn()
        per.append((time.perf_counter() - t0) / args.calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per)


card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True,
                      text=True).stdout.strip().splitlines()[0]
print(json.dumps({
    "src": args.src, "card": card, "torch": torch.__version__,
    "custom_op": hasattr(torch.ops.repro_torch, "gather_segment_reduce"),
    "launcher_host_us": host_us(lambda: gsr.gather_segment_reduce_cuda(
        h, gidx, seg, 32, None, "sum", rp)),
    "wrapper_host_us": host_us(lambda: kops.gather_segment_reduce(
        h, gidx, seg, 32, impl="cuda")),
}))

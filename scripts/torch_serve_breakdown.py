#!/usr/bin/env python3
"""Where a served request's time goes in the PyTorch/CUDA port, on the card.

    python3 scripts/torch_serve_breakdown.py [--reps 3]

For each family (gcn, gin, sage, gat with 4 heads; feat 32, hidden 64,
16 classes, seeded random weights) a ``GNNServer`` on the card serves the
full ogbn-arxiv request once cold (entry built; the kernels are built with
nvcc before any request, so no request pays the build), then ``--reps`` warm times (gcn also
reddit2). For the warm requests it prints the engine's host-clock stages
(batch, pad, cache, stamp, copy, forward enqueue, fetch) and, for one more
warm request under ``torch.profiler``, the device-busy time (kernels and
copies, summed from the profiler's device events), the host wall time of that
request, and the device's idle share = 1 - busy / wall. Also the top device
operations by time. Numbers are printed with the card's name and power limit.
Needs one CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def device_busy_us(prof):
    """(total device µs, [(name, µs), ...] top 6) from a profiler run:
    the device-side events only (kernels and copies), so a CPU op's
    attributed device time is not counted a second time."""
    from torch.autograd import DeviceType
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0:
            rows.append((evt.key, float(us)))
    rows.sort(key=lambda r: -r[1])
    return sum(us for _, us in rows), rows[:6]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_serve_breakdown: needs a CUDA device")
    from repro_torch.data.graphs import dataset
    from repro_torch.kernels import _build
    from repro_torch.models import gnn
    from repro_torch.serve import GNNServer

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    t0 = time.perf_counter()
    _build.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    graphs = {"ogbn-arxiv": dataset("ogbn-arxiv", feat=32, seed=0),
              "reddit2": dataset("reddit2", feat=32, seed=0)}
    for family in gnn.MODELS:
        model = gnn.init(family, 32, 64, 16, heads=4 if family == "gat" else 1,
                         seed=0)
        srv = GNNServer(model, family, max_batch_nodes=1 << 22)
        names = ["ogbn-arxiv"] + (["reddit2"] if family == "gcn" else [])
        for name in names:
            g = graphs[name]
            srv.submit(g)
            (cold,) = srv.step(flush=True)
            warm = []
            for _ in range(args.reps):
                srv.submit(g)
                warm.extend(srv.step(flush=True))
            stages = {k: statistics.median(r.stages[k] for r in warm) * 1e3
                      for k in warm[0].stages}
            serve = statistics.median(r.serve_s for r in warm) * 1e3
            print(f"{family} {name}: cold serve_ms={cold.serve_s * 1e3:.3f} "
                  f"warm serve_ms={serve:.3f} (median of {args.reps}); warm "
                  "stages_ms " + " ".join(f"{k}={v:.3f}"
                                          for k, v in stages.items()))
            srv.submit(g)
            torch.cuda.synchronize()
            act = [torch.profiler.ProfilerActivity.CPU,
                   torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=act) as prof:
                t0 = time.perf_counter()
                srv.step(flush=True)
                wall_us = (time.perf_counter() - t0) * 1e6
            busy_us, top = device_busy_us(prof)
            if busy_us == 0:
                print(f"{family} {name}: device time not measured (the "
                      "profiler recorded no device events)")
                continue
            print(f"{family} {name}: profiled wall_ms={wall_us / 1e3:.3f} "
                  f"device_busy_ms={busy_us / 1e3:.3f} "
                  f"idle_share={1 - busy_us / wall_us:.3f}")
            for key, us in top:
                print(f"    {us / 1e3:9.3f} ms  {key[:90]}")
        del srv, model


if __name__ == "__main__":
    main()

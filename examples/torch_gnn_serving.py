"""GNN serving on the PyTorch port: a stream of random-shape graphs
through ``GNNServer`` — shape-bucketed padding + plan cache +
block-diagonal continuous batching over the kernels on the card. The port
of ``examples/gnn_serving.py``.

The demo asserts the engine's serving contract end to end:

  * **bounded builds** — the whole stream builds at most one cache line
    a shape bucket (``serve.builds``: a bucket entry's first run, the
    port's counterpart of the reference's one compile a bucket; per
    request the engine only stamps chunk metadata into the entry);
  * **hot cache** — after the bucket-ladder warmup, the plan-cache hit
    rate over the stream is >= 80% (default: 100%);
  * **exactness** — every served result matches a direct planned
    ``models/gnn.forward`` on the request's own (unpadded, individually
    planned) graph at 1e-5.

    PYTHONPATH=src python examples/torch_gnn_serving.py [--requests 200]
        [--min-nodes 64] [--max-nodes 4096] [--model gcn] [--heads 1]
        [--impl pallas] [--check all|sample|none] [--no-warmup]
        [--device cpu]

``--impl pallas`` (the default) is the port's kernels; the engine itself
runs them on the card and the plain versions on the CPU, and ``ref``
serves on the plain versions (a server on the CPU).
"""
import argparse
import json
import time

import numpy as np
import torch

import repro_torch as rt
from repro_torch.core.device import resolve_device
from repro_torch.models import gnn
from repro_torch.serve import BucketPolicy, GNNServer, bucket_for, bucket_rungs

ap = argparse.ArgumentParser()
ap.add_argument("--requests", type=int, default=200)
ap.add_argument("--min-nodes", type=int, default=64)
ap.add_argument("--max-nodes", type=int, default=4096)
ap.add_argument("--edge-factor", type=float, default=3.0,
                help="mean edges per node of the synthetic request graphs")
ap.add_argument("--feat", type=int, default=32)
ap.add_argument("--hidden", type=int, default=32)
ap.add_argument("--model", default="gcn", choices=list(gnn.MODELS))
ap.add_argument("--heads", type=int, default=1)
ap.add_argument("--impl", default="pallas",
                choices=["ref", "blocked", "pallas"])
ap.add_argument("--max-batch-nodes", type=int, default=4096,
                help="continuous-batching node budget per micro-batch")
ap.add_argument("--max-batch-graphs", type=int, default=8)
ap.add_argument("--check", default="all", choices=["all", "sample", "none"],
                help="verify served logits against a direct per-request "
                     "forward (sample: every 8th request)")
ap.add_argument("--no-warmup", action="store_true",
                help="skip the bucket-ladder warmup (first-touch batches "
                     "then build inline and count as misses)")
ap.add_argument("--seed", type=int, default=0)
ap.add_argument("--device", default=None,
                help="default: the card; 'cpu' runs the plain versions")
args = ap.parse_args()
# the engine picks the kernels on the card; "ref" asks for the plain
# versions, which only a server on the CPU runs
dev = resolve_device("cpu" if args.impl == "ref" else args.device,
                     "examples/torch_gnn_serving.py")
impl = None if args.impl == "pallas" else args.impl

rng = np.random.default_rng(args.seed)

# -- the request stream: log-uniform |V|, power-law degree graphs ----------
graphs = []
for i in range(args.requests):
    v = int(np.exp(rng.uniform(np.log(args.min_nodes),
                               np.log(args.max_nodes))))
    e = int(v * rng.uniform(args.edge_factor / 2, args.edge_factor * 2))
    graphs.append(rt.synth_graph(f"req{i}", v, e, feat=args.feat, seed=i))

params = gnn.init(args.model, args.feat, args.hidden, 16, heads=args.heads,
                  seed=0, device=dev)
policy = BucketPolicy(min_nodes=64, min_edges=64)

# -- warmup: the bucket ladder the stream + batcher can touch --------------
# Every micro-batch has V <= max(max_batch_nodes, largest single graph) and
# edge density E/V in [edge_factor/2, 2*edge_factor]; pow-2 rounding widens
# the bucket ratio by at most 2x each way, so E_b/V_b lands in
# [edge_factor/4, 4*edge_factor] — except where a floor dominates. Warming
# each reachable (V, E) rung builds ahead of traffic, so serving runs 100%
# hot and the build count equals len(ladder) exactly.
max_v = max(args.max_batch_nodes, max(g.num_nodes for g in graphs))
max_e = int(2 * args.edge_factor * max_v)


def _reachable(v, e):
    hi = max(policy.min_edges, 4 * args.edge_factor * v)
    lo = args.edge_factor * v / 4
    return e <= hi and (e >= lo or v == policy.min_nodes
                        or e == policy.min_edges)


ladder = sorted(
    bucket_for(v, e, policy)
    for v in bucket_rungs(max_v, policy.min_nodes, policy.growth)
    for e in bucket_rungs(max_e, policy.min_edges, policy.growth)
    if _reachable(v, e))

# the cache must hold the whole ladder: an evicted bucket would rebuild on
# its next touch — exactly the churn the build bound forbids
rt.reset_launch_counts()
server = GNNServer(params, args.model, device=dev, policy=policy,
                   max_batch_nodes=args.max_batch_nodes,
                   max_batch_graphs=args.max_batch_graphs,
                   cache_capacity=len(ladder) + 8)
if not args.no_warmup:
    t0 = time.perf_counter()
    n = server.warmup(ladder)
    print(f"warmup: built {n} bucket entries "
          f"({time.perf_counter() - t0:.1f}s)")

# -- serve the stream ------------------------------------------------------
t0 = time.perf_counter()
for g in graphs:
    server.submit(g)
server.run_until_drained()
serve_wall = time.perf_counter() - t0
s = server.stats()

print(f"served {s['requests']} requests in {s['batches']} micro-batches "
      f"({serve_wall:.1f}s, {s['requests'] / serve_wall:.1f} req/s)")
print(f"  buckets={s['buckets']}  builds={s['builds']}  "
      f"cache hit rate={s['cache']['hit_rate']:.1%}  "
      f"(hits={s['cache']['hits']} misses={s['cache']['misses']} "
      f"prefills={s['cache']['prefills']})")
print(f"  latency mean={s['latency_mean_s'] * 1e3:.1f}ms "
      f"p95={s['latency_p95_s'] * 1e3:.1f}ms  "
      f"pad overhead: nodes x{s['pad_node_overhead']:.2f} "
      f"edges x{s['pad_edge_overhead']:.2f}")

# -- the serving contract --------------------------------------------------
assert len(server.results) == args.requests, "requests dropped"
n_buckets = len(ladder) if not args.no_warmup else s["buckets"]
assert s["builds"] <= n_buckets, f"{s['builds']} builds > {n_buckets} buckets"
if not args.no_warmup:
    assert s["cache"]["hit_rate"] >= 0.8, \
        f"hit rate {s['cache']['hit_rate']:.1%} < 80%"

if args.check != "none":
    idxs = list(range(args.requests) if args.check == "all"
                else range(0, args.requests, 8))
    t0 = time.perf_counter()
    worst = 0.0
    for i in idxs:
        g = graphs[i]
        plan = g.make_plan(feat=args.hidden, device=dev)
        with torch.no_grad():
            direct = gnn.forward(
                params, torch.from_numpy(g.x).to(dev),
                torch.from_numpy(g.edge_index).to(dev), g.num_nodes,
                torch.from_numpy(g.deg_inv_sqrt).to(dev), impl=impl,
                plan=plan).cpu().numpy()
        served = server.results[i].logits
        np.testing.assert_allclose(served, direct, rtol=1e-5, atol=1e-5,
                                   err_msg=f"request {i} ({g.name}) diverged")
        worst = max(worst, float(np.max(np.abs(served - direct))))
    print(f"  parity: {len(idxs)} requests vs direct planned-{args.impl}"
          f" forward, max|Δ|={worst:.2e} "
          f"({time.perf_counter() - t0:.1f}s)")
print("kernel launches:", json.dumps(rt.launch_counts()))
print("serving contract holds: builds <= buckets, cache hot, "
      "served == direct")

"""End-to-end GNN inference (the paper's §V-F workload) on the PyTorch
port: 3-layer GCN / GIN / GraphSAGE / GAT node classification on
Table-II-scale graphs, every aggregation routed through ``core/mp.py``
(the gather, segment_softmax and fused kernels on the card). The port of
``examples/gnn_inference.py``.

A :class:`~repro_torch.core.plan.SegmentPlan` is built once per graph and
reused by every layer of every model: the schedule metadata is paid for a
single time, not per call.

With ``--shards N`` the models also run sharded over N ranks of
``torch.distributed`` (N processes spawned here, gloo on a ``FileStore``,
every rank on the one card or the CPU): the graph is partitioned
(:mod:`repro_torch.data.partition`), one per-shard plan drives the same
kernels on each rank, and halo contributions merge with collectives
(:mod:`repro_torch.core.dist_mp`). The sharded logits are checked against
the single-device run.

    PYTHONPATH=src python examples/torch_gnn_inference.py [--dataset ogbn-arxiv]
        [--impl ref|blocked|pallas] [--heads 4] [--scale 0.25] [--shards 4]
        [--device cpu]

``--impl pallas`` (the default) is the port's kernels (``impl=None``: the
CUDA kernels on the card, the plain versions on the CPU).
"""
import argparse
import datetime
import json
import os
import sys
import tempfile
import time

import torch

ap = argparse.ArgumentParser()
ap.add_argument("--dataset", default="flickr")
ap.add_argument("--hidden", type=int, default=64)
ap.add_argument("--impl", default="pallas", choices=["ref", "blocked", "pallas"],
                help="aggregation backend (pallas: the port's kernels)")
ap.add_argument("--models", default=None,
                help="comma-separated subset of the model families "
                     "(default: all)")
ap.add_argument("--heads", type=int, default=1,
                help="attention heads for the GAT model (multi-head "
                     "segment_softmax is one fused launch)")
ap.add_argument("--scale", type=float, default=1.0,
                help="scale the dataset's |V|,|E| down (smoke runs)")
ap.add_argument("--no-plan", action="store_true",
                help="skip the precomputed SegmentPlan (ablation)")
ap.add_argument("--tune", action="store_true",
                help="select the kernel config from a sweep measured on the "
                     "card (kept in the PerfDB) instead of the rules")
ap.add_argument("--shards", type=int, default=0,
                help="also run the models sharded over N ranks "
                     "(partitioned graph + per-shard kernels + collective "
                     "halo merge); 0 = single device")
ap.add_argument("--device", default=None,
                help="default: the card; 'cpu' runs the plain versions")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(args, rank: int = 0, world: int = 1):
    import repro_torch as rt
    from repro_torch.core.device import resolve_device
    from repro_torch.data.graphs import all_dataset_names, dataset
    from repro_torch.models import gnn

    def say(*a):
        if rank == 0:
            print(*a, flush=True)

    dev = resolve_device(args.device, "examples/torch_gnn_inference.py")
    impl = None if args.impl == "pallas" else args.impl
    if args.dataset not in all_dataset_names():
        sys.exit(f"unknown dataset {args.dataset!r}; "
                 f"choose from {', '.join(all_dataset_names())}")
    g = dataset(args.dataset, feat=32, scale=args.scale)
    say(f"{g.name}: |V|={g.num_nodes:,} |E|={g.num_edges:,}")
    x = torch.from_numpy(g.x).to(dev)
    ei = torch.from_numpy(g.edge_index).to(dev)
    dis = torch.from_numpy(g.deg_inv_sqrt).to(dev)

    plan = None
    if not args.no_plan:
        t0 = time.perf_counter()
        plan = g.make_plan(feat=args.hidden, device=dev,
                           tune=args.tune or None)
        _sync(dev)
        dt = time.perf_counter() - t0
        say(f"  plan: config={plan.config}  skew={plan.stats.skew:.1f}  "
            f"built in {dt * 1e3:.1f} ms")

    partition = pplan = mesh = None
    if world > 1:
        t0 = time.perf_counter()
        mesh = rt.make_shard_mesh(world, device=dev)
        partition = g.partition(world, device=dev)
        pplan = partition.make_plan(feat=args.hidden, tune=args.tune or None)
        _sync(dev)
        dt = time.perf_counter() - t0
        counts = [int(c) for c in partition.edge_valid.sum(1).tolist()]
        say(f"  partition: {world} shards  edges/shard={counts}  "
            f"cut edges={partition.halo.total_cut} "
            f"({100 * partition.halo.cut_fraction:.1f}%)  built in "
            f"{dt * 1e3:.1f} ms")

    rt.reset_launch_counts()
    results = []
    for model in (args.models or ",".join(gnn.MODELS)).split(","):
        heads = args.heads if model == "gat" else 1
        params = gnn.init(model, 32, args.hidden, 16, heads=heads, seed=0,
                          device=dev)

        def fwd(**kw):
            with torch.no_grad():
                return gnn.forward(params, x, ei, g.num_nodes, dis,
                                   impl=impl, **kw)
        out = fwd(plan=plan)                       # build + run
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(3):
            out = fwd(plan=plan)
        _sync(dev)
        dt = (time.perf_counter() - t0) / 3
        pred = out.argmax(-1)
        tag = f" heads={heads}" if model == "gat" and heads > 1 else ""
        say(f"  {model:5s}: logits {tuple(out.shape)}  {dt * 1e3:7.1f} "
            f"ms/inference ({args.impl}{tag})  classes used: "
            f"{len(torch.unique(pred))}")
        if partition is not None:
            out_sh = fwd(plan=pplan, mesh=mesh, partition=partition)
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(3):
                out_sh = fwd(plan=pplan, mesh=mesh, partition=partition)
            _sync(dev)
            dt_sh = (time.perf_counter() - t0) / 3
            err = float((out_sh - out).abs().max())
            assert err < 1e-4, f"sharded {model} diverged: max err {err}"
            say(f"         sharded x{world}: {dt_sh * 1e3:7.1f} "
                f"ms/inference  max|Δ| vs single device = {err:.2e}")
        results.append(model)
    say("kernel launches:", json.dumps(rt.launch_counts()))
    say(f"served {len(results)} models: {','.join(results)}")


def _rank(rank, world, store, args):
    import torch.distributed as dist
    if args.device != "cpu" and torch.cuda.is_available():
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        run(args, rank, world)
    finally:
        dist.destroy_process_group()


def main():
    args = ap.parse_args()
    run(args)
    if args.shards > 1:
        # one process a rank, as the sharded path runs SPMD
        import torch.multiprocessing as mp
        with tempfile.TemporaryDirectory(prefix="gnn_inference_") as d:
            mp.spawn(_rank, args=(args.shards, os.path.join(d, "store"),
                                  args), nprocs=args.shards, join=True)


if __name__ == "__main__":
    main()

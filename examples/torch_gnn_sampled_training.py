"""End-to-end out-of-core sampled GNN training on the PyTorch port:
neighbour sampling into bucketed subgraphs + asynchronous host→device
prefetch, over a graph the card never sees whole. The port of
``examples/gnn_sampled_training.py``.

The example *asserts the pipeline contract itself*:

  * **one build a bucket**: across a long sampled stream (200 batches by
    default) the trainer builds its step once per shape bucket, and the
    bucket set is known *in advance* by probing the deterministic sampler,
    so ``buckets == probed buckets`` is checked too;
  * **measured overlap**: with prefetch depth >= 2 the steady-state
    consumer wait is a small fraction of the host production cost the
    pipeline is hiding (the blocking depth-0 loader pays all of it);
  * **exact parity**: an exact-neighbourhood sampler reproduces the
    full-graph forward's logits on the seed nodes to 1e-5;
  * **out-of-core**: the same stream sampled from an on-disk sharded
    store (bounded shard LRU) is bitwise the in-memory stream;
  * **serving ingest**: ``GNNServer.serve_sampled`` serves the stream
    from the same shared plan cache, one build per bucket
    (``serve.builds``).

Usage:
  PYTHONPATH=src python examples/torch_gnn_sampled_training.py    # smoke
  PYTHONPATH=src python examples/torch_gnn_sampled_training.py --steps 500 --depth 3
  ... --device cpu                                                 # on the CPU
"""
from __future__ import annotations

import argparse
import json
import tempfile

import numpy as np
import torch

import repro_torch as rt
from repro_torch.core.device import resolve_device
from repro_torch.data.graphs import synth_graph
from repro_torch.data.pipeline import SampledBatchProducer
from repro_torch.data.sampling import (NeighborSampler, ShardedGraphStore,
                                       save_graph_shards)
from repro_torch.models import gnn
from repro_torch.optim import adamw
from repro_torch.serve import GNNServer
from repro_torch.train import SampledNodeProvider


def probe_buckets(graph, args):
    """The bucket set the stream will touch — sampling is deterministic,
    so probing the sampler host-side IS the schedule."""
    sampler = NeighborSampler(graph, fanouts=tuple(args.fanouts),
                              batch_size=args.batch_size, seed=args.seed)
    producer = SampledBatchProducer(sampler, feat=args.hidden,
                                    device=args.dev)
    return producer.buckets_for_warmup(probe_steps=args.steps)


def _forward_ref(params, g, dev):
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)  # noqa: E731
    with torch.no_grad():
        return gnn.forward(params, t(g.x), t(g.edge_index), g.num_nodes,
                           t(g.deg_inv_sqrt), impl="ref").cpu().numpy()


def train_sampled(graph, args):
    data = SampledNodeProvider(
        graph, fanouts=tuple(args.fanouts), batch_size=args.batch_size,
        plan_feat=max(args.hidden, graph.x.shape[1]), depth=args.depth,
        seed=args.seed, device=args.dev)
    task = rt.NodeClassification.from_provider(
        data, model="gcn", hidden=args.hidden, impl=args.impl_arg,
        device=args.dev)
    cfg = rt.TrainerConfig(
        steps=args.steps, warmup_steps=4,
        opt=adamw.AdamWConfig(lr=args.lr, weight_decay=0.0), seed=args.seed)
    with data:
        res = rt.fit(task, data, cfg)
        stats = data.stats()

    expected = probe_buckets(graph, args)
    assert len(res.buckets) == len(expected), (
        f"rebuild leak: buckets={len(res.buckets)} probed={len(expected)} "
        f"over {args.steps} batches")
    assert all(s.sampled for s in res.buckets)

    wait_med = stats["wait_s_median_steady"]
    prod_med = stats["produce_s_median_steady"]
    assert wait_med < 0.5 * prod_med, (
        f"prefetch depth={args.depth} hid too little: steady median wait "
        f"{wait_med * 1e3:.2f} ms vs produce {prod_med * 1e3:.2f} ms")

    # epoch-scale loss check: batches differ per step, so compare windowed
    # means across the stream's halves — and only on long streams
    assert np.all(np.isfinite(res.losses))
    half = len(res.losses) // 2
    first, last = np.mean(res.losses[:half]), np.mean(res.losses[half:])
    if args.steps >= 150:
        assert last < first, (
            f"loss did not decrease ({first:.4f} -> {last:.4f})")

    print(f"[train] {args.steps} batches, buckets={len(res.buckets)} "
          f"(probed {len(expected)}), loss {first:.4f} -> {last:.4f}")
    print(f"[prefetch] depth={args.depth} overlap={stats['overlap']:.2f}  "
          f"steady wait {wait_med * 1e3:.3f} ms vs produce "
          f"{prod_med * 1e3:.3f} ms  OK")


def check_exact_parity(graph, args):
    params = gnn.init("gcn", graph.x.shape[1], args.hidden, 8, num_layers=2,
                      seed=args.seed, device=args.dev)
    full = _forward_ref(params, graph, args.dev)
    sampler = NeighborSampler(graph, fanouts=(None, None), exact=True,
                              batch_size=8, seed=args.seed)
    worst = 0.0
    for step in range(4):
        sub = sampler.sample_batch(step)
        out = _forward_ref(params, sub, args.dev)
        worst = max(worst, float(np.abs(out[:sub.num_seeds]
                                        - full[sub.seed_nodes]).max()))
    assert worst < 1e-5, f"exact-neighbourhood parity broke: {worst:.2e}"
    print(f"[parity] exact 2-hop sampled forward == full-graph forward on "
          f"seeds, max |Δ| = {worst:.2e}  OK")


def check_out_of_core(graph, args):
    mem = NeighborSampler(graph, fanouts=tuple(args.fanouts),
                          batch_size=args.batch_size, seed=args.seed)
    with tempfile.TemporaryDirectory(prefix="repro_shards_") as d:
        save_graph_shards(graph, d, num_shards=8)
        store = ShardedGraphStore(d, cache_shards=2)
        ooc = NeighborSampler(store, fanouts=tuple(args.fanouts),
                              batch_size=args.batch_size, seed=args.seed)
        for step in range(6):
            a, b = mem.sample_batch(step), ooc.sample_batch(step)
            assert np.array_equal(a.node_ids, b.node_ids)
            assert np.array_equal(a.edge_index, b.edge_index)
            assert np.array_equal(a.x, b.x)
        assert len(store._lru) <= 2, "shard LRU exceeded its bound"
    print(f"[out-of-core] 8-shard store stream == in-memory stream "
          f"(shard loads: {store.loads}, resident <= 2)  OK")


def check_serving(graph, args):
    params = gnn.init("gcn", graph.x.shape[1], args.hidden, 8, num_layers=2,
                      seed=args.seed, device=args.dev)
    server = GNNServer(params, "gcn", device=args.dev)
    sampler = NeighborSampler(graph, fanouts=tuple(args.fanouts),
                              batch_size=args.batch_size, seed=args.seed)
    worst = 0.0
    with server.sampled_pipeline(sampler, depth=args.depth) as pipe:
        for step in range(12):
            b = pipe.batch(step)
            logits = server.serve_sampled(b)
            ref = _forward_ref(params, b.graph, args.dev)
            worst = max(worst, float(np.abs(logits
                                            - ref[:b.num_seeds]).max()))
    assert server.builds == len(server.cache), (
        f"sampled serving rebuilt: {server.builds} builds for "
        f"{len(server.cache)} buckets")
    assert worst < 1e-4, f"served logits diverged: {worst:.2e}"
    print(f"[serve] 12 sampled batches, builds={server.builds} == "
          f"buckets={len(server.cache)}, max |Δ| vs ref = {worst:.2e}  OK")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=4096)
    ap.add_argument("--edges", type=int, default=16384)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--fanouts", type=int, nargs="+", default=[8, 4])
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--feat", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--impl", default="pallas", choices=["ref", "pallas"],
                    help="pallas: the port's kernels (the plain versions "
                         "on the CPU); ref: the plain versions")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    assert args.depth >= 2, "the overlap check needs prefetch depth >= 2"
    args.dev = resolve_device(args.device,
                              "examples/torch_gnn_sampled_training.py")
    args.impl_arg = None if args.impl == "pallas" else args.impl

    # host-resident only: nothing below ever copies the full graph to the
    # device
    graph = synth_graph("ooc-demo", args.nodes, args.edges, feat=args.feat,
                        num_classes=8, seed=args.seed)
    print(f"[graph] |V|={graph.num_nodes} |E|={graph.num_edges} "
          f"(host-only; device sees {args.batch_size}-seed subgraphs)")

    rt.reset_launch_counts()
    check_exact_parity(graph, args)
    check_out_of_core(graph, args)
    train_sampled(graph, args)
    check_serving(graph, args)
    print("kernel launches:", json.dumps(rt.launch_counts()))
    print("all sampled-pipeline checks passed")


if __name__ == "__main__":
    main()

"""Relation-typed GNN inference: 3-layer RGCN and relational GAT node
classification, where every layer's per-relation transforms run as ONE
grouped ``segment_matmul`` launch (never a Python loop over relations).

A :class:`~repro_torch.data.graphs.TypedGraph` precomputes the (type, dst)
permutation triple once; the reduce plan and the relation plan are built
once per graph, on the device; both typed models consume them through the
uniform layer signature. The script asserts one grouped launch per layer
and checks the grouped transform against a per-relation loop.

    python -m repro_torch.hetero_inference [--nodes N --edges E]
        [--relations R] [--hidden H] [--heads K] [--device cuda|cpu]

The device defaults to the card (raising without one); ``--device cpu``
runs the plain versions. At the AM graph of the R-GCN paper:
``--nodes 1666764 --edges 5988321 --relations 133``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import ops as geot
from repro_torch.core.device import resolve_device
from repro_torch.data.graphs import synth_typed_graph
from repro_torch.kernels import ops as kops
from repro_torch.models import gnn

FEAT, CLASSES, LAYERS = 32, 16, 3


def _parse(argv):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.hetero_inference",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=2048)
    ap.add_argument("--edges", type=int, default=16384)
    ap.add_argument("--relations", type=int, default=8)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--heads", type=int, default=2,
                    help="attention heads of the RGAT model")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap.parse_args(argv)


def _elapsed_ms(dev, fn, reps: int = 3):
    """Mean wall time of ``fn`` over ``reps`` warm calls, ending in a
    device synchronise on the card."""
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    sync()
    return (time.perf_counter() - t0) / reps * 1e3, out


def main(argv=None) -> dict:
    """Run both typed families; returns {family: logits} on the host."""
    args = _parse(argv)
    dev = resolve_device(args.device, "hetero_inference")
    g = synth_typed_graph("hetero-demo", args.nodes, args.edges,
                          num_relations=args.relations, feat=FEAT, seed=0)
    print(f"{g.name}: |V|={g.num_nodes:,} |E|={g.num_edges:,} "
          f"R={g.num_relations} (largest relation "
          f"{int(g.type_counts.max()):,} rows, "
          f"{int((g.type_counts == 0).sum())} empty)")

    t0 = time.perf_counter()
    width = args.hidden * args.heads        # the widest layer output
    plan = g.make_plan(feat=width, device=dev)
    rplan = g.make_relation_plan(feat=width, device=dev)
    print(f"  plans built on {dev} in {(time.perf_counter() - t0) * 1e3:.1f}"
          f" ms: runs of {plan.config.m_b} rows, tiles of "
          f"{plan.config.s_b} segments, groups {rplan.max_groups} (of "
          f"{rplan.worst_case_groups})")

    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    x, ei = t(g.x), t(g.edge_index)
    typed = dict(edge_type=t(g.edge_type), type_perm=t(g.type_perm),
                 inv_type_perm=t(g.inv_type_perm),
                 type_counts=t(g.type_counts), rplan=rplan)

    results = {}
    for family in gnn.TYPED_MODELS:
        heads = args.heads if family == "rgat" else 1
        model = gnn.init(family, FEAT, args.hidden, CLASSES, LAYERS,
                         heads=heads, num_relations=g.num_relations, seed=0,
                         device=dev)
        kops.reset_launch_counts()
        with torch.inference_mode(), kops.fusion_scope() as fusion:
            out = gnn.forward(model, x, ei, g.num_nodes, plan=plan, **typed)
        grouped = (fusion.get("fused:segment_matmul", 0)
                   + fusion.get("unfused:segment_matmul:ref", 0))
        if grouped != LAYERS:
            raise RuntimeError(f"{family}: {grouped} grouped segment_matmul "
                               f"calls for {LAYERS} layers, expected one each")
        if dev.type == "cuda" and \
                kops.launch_counts()["segment_matmul"] != LAYERS:
            raise RuntimeError(f"{family}: segment_matmul launched "
                               f"{kops.launch_counts()['segment_matmul']} "
                               f"times for {LAYERS} layers")
        with torch.inference_mode():
            ms, out = _elapsed_ms(dev, lambda: gnn.forward(
                model, x, ei, g.num_nodes, plan=plan, **typed))
        if out.shape != (g.num_nodes, CLASSES) or \
                not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"{family}: logits {tuple(out.shape)} are "
                               "not finite (V, classes)")
        tag = f" heads={heads}" if heads > 1 else ""
        print(f"  {family:5s}: logits {tuple(out.shape)} {ms:9.2f} ms/"
              f"inference on {dev}{tag}; grouped launches {grouped} for "
              f"{LAYERS} layers; classes used "
              f"{int(out.argmax(-1).unique().numel())}")
        results[family] = out.float().cpu()

    # the grouped transform of the first layer against a per-relation loop
    w_rel = model.layers[0].w_rel.detach()
    typed_src = t(g.typed_src)
    with torch.inference_mode():
        got = geot.grouped_segment_matmul(x.index_select(0, typed_src.long()),
                                          typed["type_counts"], w_rel,
                                          plan=rplan)
        want = torch.empty_like(got)
        start = 0
        for r, n in enumerate(g.type_counts.tolist()):
            rows = typed_src[start:start + n].long()
            want[start:start + n] = x.index_select(0, rows) @ w_rel[r]
            start += n
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if err > 1e-4:
        raise RuntimeError(f"grouped vs per-relation loop diverged: {err}")
    print(f"  grouped vs per-relation loop: max|d| = {err:.2e}")
    return results


if __name__ == "__main__":
    main()

"""Heterogeneous GNN inference on a relation-typed graph (FASTEN's
workload) on the PyTorch port: 3-layer RGCN / relational-GAT node
classification where every layer's per-relation weight transforms run as
**one** grouped ``segment_matmul`` launch (never a Python loop over
types). The port of ``examples/hetero_inference.py``.

Everything goes through the public ``repro_torch`` API: a
:class:`~repro_torch.data.graphs.TypedGraph` precomputes the (type, dst)
permutation triple once; ``make_plan`` / ``make_relation_plan`` build the
fused-reduce and grouped-matmul schedules once per graph, on the device;
the typed models consume both through the uniform layer signature. The
grouped path is checked against a per-type Python-loop reference, and on
``--impl pallas`` (the port's kernels, the default) the fusion counters
verify exactly one ``segment_matmul`` launch per layer.

    PYTHONPATH=src python examples/torch_hetero_inference.py [--relations 8]
        [--impl ref|pallas] [--nodes N --edges E] [--device cpu]
"""
import argparse
import json
import time

import torch

import repro_torch as rt
from repro_torch.core.device import resolve_device
from repro_torch.kernels import ops as kops

ap = argparse.ArgumentParser()
ap.add_argument("--nodes", type=int, default=2048)
ap.add_argument("--edges", type=int, default=16384)
ap.add_argument("--relations", type=int, default=8)
ap.add_argument("--hidden", type=int, default=64)
ap.add_argument("--heads", type=int, default=2,
                help="attention heads for the RGAT model")
ap.add_argument("--impl", default="pallas", choices=["ref", "pallas"],
                help="aggregation backend (pallas: the port's kernels)")
ap.add_argument("--tune", action="store_true",
                help="pick kernel configs from a sweep measured on the card")
ap.add_argument("--device", default=None,
                help="default: the card; 'cpu' runs the plain versions")
args = ap.parse_args()
dev = resolve_device(args.device, "examples/torch_hetero_inference.py")
impl = None if args.impl == "pallas" else args.impl
sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

g = rt.synth_typed_graph("hetero-demo", args.nodes, args.edges,
                         num_relations=args.relations, feat=32, seed=0)
counts = ", ".join(str(int(c)) for c in g.type_counts)
print(f"{g.name}: |V|={g.num_nodes:,} |E|={g.num_edges:,} "
      f"R={g.num_relations} (rows per relation: {counts})")

t0 = time.perf_counter()
plan = g.make_plan(feat=args.hidden, device=dev, tune=args.tune or None)
rplan = g.make_relation_plan(feat=args.hidden, device=dev,
                             tune=args.tune or None)
sync()
print(f"  plans built in {(time.perf_counter() - t0) * 1e3:.1f} ms — "
      f"runs of {plan.config.m_b} rows, grouped grid {rplan.max_groups} "
      f"(of {rplan.worst_case_groups})")

t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
x, ei = t(g.x), t(g.edge_index)
typed_kw = dict(edge_type=t(g.edge_type), type_perm=t(g.type_perm),
                inv_type_perm=t(g.inv_type_perm),
                type_counts=t(g.type_counts), rplan=rplan)


def per_type_loop_messages(x, w_rel):
    """The first RGCN layer's typed transform, one matmul a relation: the
    thing the grouped launch replaces."""
    src = t(g.edge_index[0]).long()
    et = typed_kw["edge_type"]
    msg = torch.zeros((g.num_edges, w_rel.shape[-1]), dtype=x.dtype,
                      device=dev)
    for r in range(g.num_relations):
        sel = (et == r).nonzero()[:, 0]
        msg[sel] = x.index_select(0, src[sel]) @ w_rel[r]
    return msg


rt.reset_launch_counts()
for model in rt.TYPED_MODELS:
    heads = args.heads if model == "rgat" else 1
    params = rt.gnn_init(model, 32, args.hidden, 16,
                         num_relations=g.num_relations, heads=heads, seed=0,
                         device=dev)
    layers = len(params.layers)
    with torch.inference_mode(), kops.fusion_scope() as fused:
        out = rt.gnn_forward(params, x, ei, g.num_nodes, impl=impl,
                             plan=plan, **typed_kw)
    launches = fused.get("fused:segment_matmul", 0)
    if args.impl == "pallas" and dev.type == "cuda":
        assert launches == layers, (
            f"expected one grouped launch per layer, got {launches}")
    with torch.inference_mode():
        sync()
        t0 = time.perf_counter()
        for _ in range(3):
            out = rt.gnn_forward(params, x, ei, g.num_nodes, impl=impl,
                                 plan=plan, **typed_kw)
        sync()
    dt = (time.perf_counter() - t0) / 3
    tag = f" heads={heads}" if model == "rgat" and heads > 1 else ""
    print(f"  {model:5s}: logits {tuple(out.shape)}  {dt * 1e3:7.1f} "
          f"ms/inference ({args.impl}{tag})  grouped launches: {launches} "
          f"for {layers} layers  classes used: "
          f"{len(torch.unique(out.argmax(-1)))}")

# cross-check the grouped transform against the per-type loop
w_rel = params.layers[0].w_rel.detach()
with torch.inference_mode():
    got = rt.grouped_segment_matmul(x.index_select(0, t(g.typed_src).long()),
                                    typed_kw["type_counts"], w_rel, impl)
    want = per_type_loop_messages(x, w_rel)[t(g.type_perm).long()]
err = float((got - want).abs().max())
assert err < 1e-4, f"grouped vs per-type loop diverged: {err}"
print("kernel launches:", json.dumps(rt.launch_counts()))
print(f"  grouped vs per-type-loop parity: max|Δ| = {err:.2e}")

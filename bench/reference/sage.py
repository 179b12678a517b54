"""Plain GraphSAGE (mean aggregator) over a whole graph, fp32, TF32 off:

    h' = h · W_self + mean_{(s, d) ∈ E} h_s · W_neigh + b,

ReLU between layers, a node with no incoming edge taking 0 as its mean.
The mean commutes with W_neigh, so each layer transforms first and
aggregates at d_out (``index_add_`` over chunks of edges). Imports nothing
of the program."""
from __future__ import annotations

import torch

from . import full_fp32

EDGE_CHUNK = 1 << 22


def layers_of(weights: dict, num_layers: int) -> list:
    """[(w_self, w_neigh, b)] a layer from ``layers.{i}.*`` weights."""
    return [(weights[f"layers.{i}.w_self"], weights[f"layers.{i}.w_neigh"],
             weights[f"layers.{i}.b"]) for i in range(num_layers)]


def mean_aggregate(h, src, dst, num_nodes: int):
    """(V, F): the mean of h over each node's incoming edges (0 for
    none)."""
    out = torch.zeros(num_nodes, h.shape[1], dtype=torch.float32,
                      device=h.device)
    for lo in range(0, src.numel(), EDGE_CHUNK):
        s = src[lo:lo + EDGE_CHUNK].long()
        d = dst[lo:lo + EDGE_CHUNK].long()
        out.index_add_(0, d, h.index_select(0, s))
    deg = torch.bincount(dst.long(), minlength=num_nodes).clamp_(min=1)
    return out / deg[:, None].to(torch.float32)


def forward(x, src, dst, num_nodes: int, layers):
    """Logits (V, C) of a GraphSAGE stack on one graph."""
    with torch.no_grad(), full_fp32():
        h = x.float()
        for i, (w_self, w_neigh, b) in enumerate(layers):
            neigh = mean_aggregate(h @ w_neigh.float(), src, dst, num_nodes)
            h = h @ w_self.float() + neigh + b.float()
            if i < len(layers) - 1:
                h = torch.relu(h)
        return h

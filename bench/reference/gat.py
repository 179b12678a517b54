"""Plain GAT (Veličković et al., ICLR 2018, §3.3's inductive model) over a
whole graph, fp32, TF32 off. For a layer with input x (V, d_in), K heads
of width F and ``concat`` c:

    h        = x W                                          (V, K, F)
    s_src    = <h[v,k], a_src[k]>,  s_dst = <h[v,k], a_dst[k]>   (V, K)
    e[j→i,k] = LeakyReLU(s_src[j,k] + s_dst[i,k])   over every edge
    α[j→i,k] = softmax of e over the incoming edges of i, per head
    o[i,k]   = Σ_j α[j→i,k] h[j,k]
    conv     = concat_k o[i,k] + b   if c  else  mean_k o[i,k] + b
    y        = conv + x W_skip + b_skip

ELU between layers; the last layer's y is the logits. Self-loops, one
(i, i) a node, are added here to the edges it is given. The softmax is a
``scatter_reduce`` max, ``exp`` and an ``index_add_`` sum; the weighted
sums run over chunks of edges (one (E, 1024) message tensor of Reddit2
would take 96 GB). Imports nothing of the program."""
from __future__ import annotations

import torch

from . import full_fp32

EDGE_CHUNK = 1 << 19


def layers_of(weights: dict, config: dict) -> list:
    """[dict(w, a_src, a_dst, b, w_skip, b_skip, concat)] a layer from
    ``layers.{i}.*`` weights; ``concat`` from the configuration."""
    return [{**{k: weights[f"layers.{i}.{k}"]
                for k in ("w", "a_src", "a_dst", "b", "w_skip", "b_skip")},
             "concat": bool(c)}
            for i, c in enumerate(config["concat"])]


def with_self_loops(src, dst, num_nodes: int):
    """(src, dst) int64 with one (i, i) a node appended."""
    nodes = torch.arange(num_nodes, device=src.device)
    return torch.cat([src.long(), nodes]), torch.cat([dst.long(), nodes])


def attention(h, a_src, a_dst, src, dst, num_nodes: int,
              negative_slope: float):
    """α (E, K): the softmax of the edges' scores over each destination's
    incoming edges, head by head."""
    s_src = (h * a_src).sum(-1)
    s_dst = (h * a_dst).sum(-1)
    e = torch.nn.functional.leaky_relu(
        s_src.index_select(0, src) + s_dst.index_select(0, dst),
        negative_slope)
    heads = e.shape[1]
    m = torch.full((num_nodes, heads), float("-inf"), dtype=e.dtype,
                   device=e.device).scatter_reduce_(
        0, dst[:, None].expand(-1, heads), e, "amax", include_self=True)
    p = torch.exp(e - m.index_select(0, dst))
    z = torch.zeros((num_nodes, heads), dtype=e.dtype,
                    device=e.device).index_add_(0, dst, p)
    return p / z.index_select(0, dst)


def weighted_sum(h, alpha, src, dst, num_nodes: int):
    """(V, K, F): Σ over each destination's incoming edges of α · h[src]."""
    out = torch.zeros((num_nodes,) + tuple(h.shape[1:]), dtype=h.dtype,
                      device=h.device)
    for lo in range(0, src.numel(), EDGE_CHUNK):
        s, d = src[lo:lo + EDGE_CHUNK], dst[lo:lo + EDGE_CHUNK]
        out.index_add_(0, d, h.index_select(0, s)
                       * alpha[lo:lo + EDGE_CHUNK, :, None])
    return out


def forward(x, src, dst, num_nodes: int, layers, *, self_loops: bool = True,
            negative_slope: float = 0.2):
    """Logits (V, C) of a GAT stack on one graph (``src``, ``dst``: its
    edges, self-loops added here when ``self_loops``). Differentiable: a
    caller that wants no gradients runs it under ``torch.no_grad()``."""
    with full_fp32():
        if self_loops:
            src, dst = with_self_loops(src, dst, num_nodes)
        else:
            src, dst = src.long(), dst.long()
        h = x.float()
        for i, layer in enumerate(layers):
            a_src, a_dst = layer["a_src"].float(), layer["a_dst"].float()
            hk = (h @ layer["w"].float()).reshape(h.shape[0], *a_src.shape)
            alpha = attention(hk, a_src, a_dst, src, dst, num_nodes,
                              negative_slope)
            o = weighted_sum(hk, alpha, src, dst, num_nodes)
            conv = o.reshape(o.shape[0], -1) if layer["concat"] \
                else o.mean(1)
            y = conv + layer["b"].float() + h @ layer["w_skip"].float() \
                + layer["b_skip"].float()
            h = torch.nn.functional.elu(y) if i < len(layers) - 1 else y
        return h

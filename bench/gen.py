"""The benchmark's inputs and weights, made from the seed on the device in a
few large calls. Plain torch: nothing here imports the program, so the
reference and the program are handed the same tensors.

* :func:`in_degrees`, :func:`graph` — the paper's Table II recipe
  (``data/graphs.py`` ``synth_graph``, re-implemented): zipf(alpha)
  in-degree weights capped at E/4, destinations drawn in proportion to
  them and sorted, sources uniform. The zeta draws use Devroye's rejection
  method (numpy's), so the degree law is numpy's; the values are not
  numpy's. The degrees come from a generator of their own, so that every
  seed draws other sources for the same degrees.
* :func:`zipf_tokens` — token ids as Zipf-distributed ranks mapped through
  a seeded permutation of the vocabulary.
* :func:`flat_normal` — one N(0, 1) draw for many leaves, each a view of
  it scaled in place.
"""
from __future__ import annotations

import math


def zeta(torch, alpha: float, n: int, gen, device, dtype=None):
    """``n`` draws of the zeta (discrete Zipf) law P(k) ∝ k^-alpha, k ≥ 1,
    by Devroye's rejection method, in float64 (the tail is heavy)."""
    dtype = dtype or torch.float64
    am1 = alpha - 1.0
    b = 2.0 ** am1
    out = torch.empty(n, dtype=dtype, device=device)
    todo = torch.arange(n, device=device)
    while todo.numel():
        u = 1.0 - torch.rand(todo.numel(), generator=gen, dtype=dtype,
                             device=device)
        v = torch.rand(todo.numel(), generator=gen, dtype=dtype,
                       device=device)
        x = torch.floor(u ** (-1.0 / am1))
        t = (1.0 + 1.0 / x) ** am1
        ok = (x >= 1) & torch.isfinite(x) & (v * x * (t - 1.0) / (b - 1.0)
                                            <= t / b)
        out[todo[ok]] = x[ok]
        todo = todo[~ok]
    return out


def in_degrees(torch, num_nodes: int, num_edges: int, alpha: float,
               cap_share: float, gen, device):
    """(V,) int64 in-degrees summing to E, node by node: zeta(alpha)
    weights capped at ``cap_share``·E (never below 1), each of the E edges
    given a destination drawn with probability ∝ its weight."""
    w = zeta(torch, alpha, num_nodes, gen, device)
    w = torch.clamp(w, max=max(num_edges * cap_share, 1.0))
    cdf = torch.cumsum(w / w.sum(), 0)
    u = torch.rand(num_edges, generator=gen, dtype=torch.float64,
                   device=device)
    dst = torch.searchsorted(cdf, u, right=True).clamp_(max=num_nodes - 1)
    return torch.bincount(dst, minlength=num_nodes)


def graph(torch, degrees, gen, device):
    """(src, dst) int32: node v the destination of ``degrees[v]`` edges
    (``dst`` sorted non-decreasing), each edge's source uniform from
    ``gen``. The same degrees under another generator give another graph
    with the same work a node."""
    num_nodes = degrees.numel()
    dst = torch.repeat_interleave(
        torch.arange(num_nodes, dtype=torch.int32, device=device), degrees)
    src = torch.randint(0, num_nodes, (dst.numel(),), generator=gen,
                        dtype=torch.int32, device=device)
    return src, dst


def zipf_tokens(torch, vocab: int, exponent: float, shape, perm, gen,
                device):
    """Token ids of ``shape``: ranks r ≥ 1 drawn with P(r) ∝ r^-exponent
    over the vocabulary (inverse CDF), mapped through ``perm`` (a
    permutation of the vocabulary)."""
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    p = ranks ** (-exponent)
    cdf = torch.cumsum(p / p.sum(), 0)
    u = torch.rand(math.prod(shape), generator=gen, dtype=torch.float64,
                   device=device)
    r = torch.searchsorted(cdf, u, right=True).clamp_(max=vocab - 1)
    return perm[r].reshape(shape)


def flat_normal(torch, specs, dtype, gen, device) -> dict:
    """{name: tensor}: one N(0, 1) draw in ``dtype`` for every (name,
    shape, std) of ``specs``, each leaf a view of it scaled by its std
    (std None: filled with ones)."""
    sizes = [math.prod(shape) for _, shape, _ in specs]
    flat = torch.randn(sum(sizes), generator=gen, dtype=dtype, device=device)
    out, lo = {}, 0
    for (name, shape, std), n in zip(specs, sizes):
        leaf = flat[lo:lo + n].view(shape)
        if std is None:
            leaf.fill_(1.0)
        else:
            leaf.mul_(std)
        out[name] = leaf
        lo += n
    return out

"""The port's GAT as published (concatenated heads, bias, skip connections,
ELU, self-loops; Veličković et al., ICLR 2018, §3.3) against the plain
reference the benchmark checks it with (``bench/reference/gat.py``), on
the CPU at a small size: logits and gradients. Also the self-loop helper,
the ``gat.scores`` counter and the ``gat.attention`` span, and that the
reference's GAT (averaged heads, no bias, no skip) is built as before."""
from __future__ import annotations

import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.reference import gat as reference  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.data.graphs import add_self_loops  # noqa: E402
from repro_torch.models import gnn  # noqa: E402

V, E, D_IN, WIDTH, CLASSES = 300, 3000, 12, 8, 5
HEADS, CONCAT = [4, 4, 6], [True, True, False]


def graph(seed: int = 0, num_nodes: int = V, num_edges: int = E):
    """(src, dst) int32, destinations sorted, some nodes without edges."""
    g = torch.Generator().manual_seed(seed)
    dst = torch.randint(0, num_nodes - 7, (num_edges,), generator=g,
                        dtype=torch.int32).sort().values
    src = torch.randint(0, num_nodes, (num_edges,), generator=g,
                        dtype=torch.int32)
    return src, dst


def published(seed: int = 0) -> gnn.GNN:
    """The published model at a small width (concatenating layers
    ``HEADS[i] × WIDTH`` wide), with biases drawn so that they take part
    (the model starts them at 0)."""
    dims = [D_IN] + [k * WIDTH for k in HEADS[:-1]] + [CLASSES]
    model = gnn.GNN("gat", dims, heads=HEADS, concat=CONCAT, bias=True,
                    skip=True, activation="elu",
                    generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith((".b", ".b_skip")):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return model


def reference_layers(model: gnn.GNN) -> list:
    return [{"w": l.w, "a_src": l.a_src, "a_dst": l.a_dst, "b": l.b,
             "w_skip": l.w_skip, "b_skip": l.b_skip, "concat": l.concat}
            for l in model.layers]


def port_logits(model, x, src, dst):
    edge_index = add_self_loops(torch.stack([src, dst]), V)
    return model(x, edge_index, V, impl="ref")


@pytest.mark.parametrize("seed", [0, 1])
def test_published_gat_matches_the_reference(seed):
    model = published(seed)
    src, dst = graph(seed)
    x = torch.randn(V, D_IN, generator=torch.Generator().manual_seed(seed))
    assert [l.w.shape[1] for l in model.layers] == [32, 32, 30]
    assert model.dims == [D_IN, 32, 32, CLASSES]
    with torch.no_grad():
        got = port_logits(model, x, src, dst)
        want = reference.forward(x, src, dst, V, reference_layers(model))
    assert got.shape == (V, CLASSES)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_published_gat_gradients_match_the_reference():
    model = published(3)
    src, dst = graph(3)
    x = torch.randn(V, D_IN, generator=torch.Generator().manual_seed(3))
    weight = torch.randn(V, CLASSES, generator=torch.Generator().manual_seed(4))
    params = list(model.parameters())
    got = torch.autograd.grad(
        (port_logits(model, x, src, dst) * weight).sum(), params)
    want = torch.autograd.grad(
        (reference.forward(x, src, dst, V, reference_layers(model))
         * weight).sum(), params)
    for (name, _), g, w in zip(model.named_parameters(), got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5, msg=name)


@pytest.mark.parametrize("fault", ["averaged", "no_loops", "relu"])
def test_the_comparison_sees_each_part_of_the_model(fault):
    """Averaged heads in layer 1, no self-loops or ReLU for ELU: each
    moves the logits far outside the comparison's tolerance."""
    model = published(5)
    src, dst = graph(5)
    x = torch.randn(V, D_IN, generator=torch.Generator().manual_seed(5))
    layers = reference_layers(model)
    loops = True
    if fault == "averaged":
        layers[0]["concat"] = False
        layers[0]["b"] = layers[0]["b"][:WIDTH]
        layers[0]["w_skip"] = layers[0]["w_skip"][:, :WIDTH]
        layers[0]["b_skip"] = layers[0]["b_skip"][:WIDTH]
        layers[1]["w"] = layers[1]["w"][:WIDTH]
        layers[1]["w_skip"] = layers[1]["w_skip"][:WIDTH]
    elif fault == "no_loops":
        loops = False
    else:
        model.activation = "relu"
    with torch.no_grad():
        got = port_logits(model, x, src, dst)
        want = reference.forward(x, src, dst, V, layers, self_loops=loops)
    assert (got - want).abs().max() > 1e-2


def test_self_loops_keep_destinations_sorted_and_add_one_row_a_node():
    src, dst = graph(7)
    # two padded rows at the end carry the drop id
    ei = torch.cat([torch.stack([src, dst]),
                    torch.tensor([[0, 3], [V, V]], dtype=torch.int32)], 1)
    out = add_self_loops(ei, V)
    assert out.dtype == ei.dtype and out.shape == (2, E + 2 + V)
    assert bool((out[1, 1:] >= out[1, :-1]).all())
    loops = out[0] == out[1]
    assert int(loops.sum()) == V + int((src == dst).sum())
    assert torch.equal(out[:, -2:], ei[:, -2:])
    # the edges given keep their order; each node's loop heads its rows
    kept = torch.ones(out.shape[1], dtype=torch.bool)
    first = torch.searchsorted(out[1].contiguous(),
                               torch.arange(V, dtype=torch.int32))
    assert torch.equal(out[0, first], torch.arange(V, dtype=torch.int32))
    assert torch.equal(out[1, first], torch.arange(V, dtype=torch.int32))
    kept[first] = False
    assert torch.equal(out[:, kept], ei)


def test_self_loops_on_a_graph_without_edges():
    out = add_self_loops(torch.zeros(2, 0, dtype=torch.int64), 4)
    assert torch.equal(out, torch.arange(4).repeat(2, 1))


def test_gat_scores_count_edges_times_heads_by_layer():
    obs.enable()
    model = published(0)
    src, dst = graph(0)
    x = torch.randn(V, D_IN)
    counter = obs.get_registry().get("gat.scores")
    before = {i: counter.value(layer=str(i)) for i in range(3)}
    with torch.no_grad():
        port_logits(model, x, src, dst)
    for i, heads in enumerate(HEADS):
        assert counter.value(layer=str(i)) - before[i] == (E + V) * heads


def test_gat_attention_span_holds_the_scores_not_the_sums():
    obs.enable()
    obs.reset_spans()
    model = published(0)
    src, dst = graph(0)
    with torch.no_grad():
        port_logits(model, torch.randn(V, D_IN), src, dst)
    root = obs.spans("gnn.forward")[-1]
    for layer, heads in zip(root.children, HEADS):
        names = [c.name for c in layer.children]
        assert names == ["gat.attention"] + ["mp.aggregate"] * heads
        assert layer.children[0].children == []
        assert layer.children[0].attrs["heads"] == heads


@pytest.mark.parametrize("heads", [1, 2, 3])
def test_todays_gat_builds_the_same_parameters(heads):
    """``GNN("gat", …)`` with the reference's arguments: per layer w,
    a_src and a_dst drawn in that order from the generator, the heads
    averaged, and nothing else."""
    dims = [6, 8, 8, 3]
    model = gnn.GNN("gat", dims, heads=heads,
                    generator=torch.Generator().manual_seed(11))
    g = torch.Generator().manual_seed(11)
    want = {}
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        want[f"layers.{i}.w"] = torch.randn(
            d_in, heads * d_out, generator=g) * (1.0 / math.sqrt(d_in))
        for a in ("a_src", "a_dst"):
            want[f"layers.{i}.{a}"] = torch.randn(
                heads, d_out, generator=g) * (1.0 / math.sqrt(d_out))
    got = model.state_dict()
    assert list(got) == list(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    assert all(not l.concat and l.head_dim == d for l, d in
               zip(model.layers, dims[1:]))


@pytest.mark.parametrize("family", ["gcn", "sage", "gin"])
def test_other_families_refuse_gats_options(family):
    for kw in ({"concat": True}, {"skip": True}, {"bias": True}):
        with pytest.raises(ValueError):
            gnn.GNN(family, [4, 8, 2], **kw)


def test_concatenated_heads_must_divide_the_width():
    with pytest.raises(ValueError):
        gnn.GATLayer(4, 10, heads=4, concat=True)
    with pytest.raises(ValueError):
        gnn.GNN("gat", [4, 8, 2], heads=[2, 2, 2])

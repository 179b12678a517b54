"""Full-graph GAT inference, a closed loop with one request in flight.

A request is one forward of ``repro_torch.models.gnn.GNN("gat", ...)``
over the whole graph, self-loops added once in set-up
(``repro_torch.data.graphs.add_self_loops``) and its ``SegmentPlan`` built
once, as a server keeps them; then the argmax prediction of every node,
copied to pinned host memory. The request, its timing by two CUDA events,
the window's sample and the check's numbers are ``gnn_infer``'s; the check
compares with the plain fp32 GAT (``bench/reference/gat.py``) on the same
inputs, its own self-loops added to the same edges.

Config keys: ``num_nodes``, ``num_edges``, ``num_features``,
``num_classes``, ``heads`` and ``concat`` (one a layer), ``hidden`` (a
head's width in a concatenating layer), ``bias``, ``skip``,
``activation``, ``negative_slope``, ``self_loops``, ``degree_zipf``,
``degree_cap_share``, ``degree_seed``, ``bias_std``. Traffic keys: as
``gnn_infer``'s.
"""
from __future__ import annotations

import math

from bench import gen, harness, roofline
from bench.drivers import gnn_infer
from bench.reference import gat as reference

# the slope of the program's LeakyReLU (models/gnn.py GATLayer)
PROGRAM_NEGATIVE_SLOPE = 0.2


def layer_dims(config) -> list:
    """The widths between layers: a concatenating layer's output is its
    heads' widths together, an averaging one's a head's width (the last
    layer's: the class count)."""
    hidden = [config["hidden"] * k if c else config["hidden"]
              for k, c in zip(config["heads"][:-1], config["concat"][:-1])]
    return [config["num_features"]] + hidden + [config["num_classes"]]


def head_widths(config) -> list:
    dims = layer_dims(config)
    return [d // k if c else d for d, k, c in
            zip(dims[1:], config["heads"], config["concat"])]


def weight_specs(config) -> list:
    """(name, shape, std) of every weight, named as the GNN's
    ``state_dict``: W and W_skip N(0, 1/d_in), a_src and a_dst N(0, 1/F),
    the biases N(0, bias_std²)."""
    dims = layer_dims(config)
    specs = []
    for i, (k, f) in enumerate(zip(config["heads"], head_widths(config))):
        d_in, d_out = dims[i], dims[i + 1]
        std, a_std = 1.0 / math.sqrt(d_in), 1.0 / math.sqrt(f)
        specs += [(f"layers.{i}.w", (d_in, k * f), std),
                  (f"layers.{i}.a_src", (k, f), a_std),
                  (f"layers.{i}.a_dst", (k, f), a_std),
                  (f"layers.{i}.b", (d_out,), config["bias_std"]),
                  (f"layers.{i}.w_skip", (d_in, d_out), std),
                  (f"layers.{i}.b_skip", (d_out,), config["bias_std"])]
    return specs


def inputs(torch, config, seed, device) -> dict:
    """The graph, the features and the weights: ``gnn_infer``'s graph and
    features (the in-degrees from ``degree_seed``, the rest from the
    seed), GAT's weights."""
    degrees = gen.in_degrees(
        torch, config["num_nodes"], config["num_edges"],
        config["degree_zipf"], config["degree_cap_share"],
        torch.Generator(device=device).manual_seed(config["degree_seed"]),
        device)
    g = torch.Generator(device=device).manual_seed(seed)
    src, dst = gen.graph(torch, degrees, g, device)
    x = torch.randn(config["num_nodes"], config["num_features"],
                    generator=g, device=device)
    weights = gen.flat_normal(torch, weight_specs(config), torch.float32, g,
                              device)
    return {"src": src, "dst": dst, "x": x, "weights": weights}


def infer_flops(num_nodes: int, num_rows: int, config) -> int:
    """One full-graph GAT forward over ``num_rows`` edges (self-loops
    included): a layer's transform (2·V·d_in·K·F) and skip (2·V·d_in·
    d_out), the two scores (2 · 2·V·K·F), a score an edge and head (its
    add and LeakyReLU, and the softmax's max, exp, sum and divide: 6·E·K),
    the weighted sums (2·E·K·F) and, averaging, the mean (V·K·F)."""
    dims, total = layer_dims(config), 0
    for i, (k, f) in enumerate(zip(config["heads"], head_widths(config))):
        d_in, d_out = dims[i], dims[i + 1]
        total += 2 * num_nodes * d_in * (k * f + d_out)
        total += 4 * num_nodes * k * f
        total += 6 * num_rows * k + 2 * num_rows * k * f
        if not config["concat"][i]:
            total += num_nodes * k * f
    return total


class Session(gnn_infer.Session):
    """``gnn_infer``'s request loop on GAT: the model first (a program
    without GAT's published options fails here, before any input is
    made), then the inputs, the self-loops and the plan."""

    def __init__(self, torch, config, traffic, seed, device):
        from repro_torch.data import graphs
        from repro_torch.models import gnn
        if config["negative_slope"] != PROGRAM_NEGATIVE_SLOPE:
            raise ValueError(f"the program's LeakyReLU slope is "
                             f"{PROGRAM_NEGATIVE_SLOPE}, the configuration "
                             f"states {config['negative_slope']}")
        self.torch, self.config, self.device = torch, config, device
        self.cuda = torch.device(device).type == "cuda"
        dims = layer_dims(config)
        with torch.device("meta"):
            model = gnn.GNN("gat", dims, heads=config["heads"],
                            concat=config["concat"], bias=config["bias"],
                            skip=config["skip"],
                            activation=config["activation"])
        phases = harness.Phases(self.sync)
        self.data = inputs(torch, config, seed, device)
        phases.end("inputs")
        self.num_nodes = config["num_nodes"]
        model.load_state_dict(self.data["weights"], assign=True)
        self.model = model.eval()
        self.edge_index = torch.stack([self.data["src"], self.data["dst"]])
        if config["self_loops"]:
            self.edge_index = graphs.add_self_loops(self.edge_index,
                                                    self.num_nodes)
        # the widest aggregation is a head's
        self.plan = gnn.make_model_plan(self.edge_index, self.num_nodes,
                                        feat=max(head_widths(config)),
                                        device=device)
        phases.end("model, self-loops and plan")
        self.sample = harness.Reservoir(seed, traffic["sample"])
        self.times = []
        self.flops_per_unit = infer_flops(
            self.num_nodes, int(self.edge_index.shape[1]), config)
        self.peak_flops = roofline.FP32_FLOPS
        for _ in range(traffic.get("warmup", 2)):
            self._request()
        phases.end("warm-up")
        self.times.clear()
        self.last = None

    def check(self) -> dict:
        """Frees the program's model, plan and edges, then compares every
        kept answer with the reference: ``logit_err`` and ``argmax_gap``
        as ``gnn_infer`` defines them."""
        torch = self.torch
        kept = list(self.sample.items)
        if self.last is not None and all(self.last is not k for k in kept):
            kept.append(self.last)
        del self.model, self.plan, self.edge_index, self.sample, self.last
        if self.cuda:
            torch.cuda.empty_cache()
        d, config = self.data, self.config
        with torch.no_grad():
            ref = reference.forward(
                d["x"], d["src"], d["dst"], self.num_nodes,
                reference.layers_of(d["weights"], config),
                self_loops=config["self_loops"],
                negative_slope=config["negative_slope"])
        scale = float(ref.abs().max())
        best = ref.max(1).values
        logit_err = gap = 0.0
        for logits, host in kept:
            logit_err = harness.worst(
                logit_err, float((logits.float() - ref).abs().max()) / scale)
            chosen = ref.gather(1, host.to(ref.device).long()[:, None])[:, 0]
            gap = harness.worst(gap, float((best - chosen).max()) / scale)
        return {"logit_err": logit_err, "argmax_gap": gap}


def setup(config, traffic, seed, device):
    import torch
    return Session(torch, config, traffic, seed, device)

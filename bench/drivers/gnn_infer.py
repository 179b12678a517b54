"""Full-graph GNN inference, a closed loop with one request in flight.

A request is one forward of ``repro_torch.models.gnn.GNN`` over the whole
graph (its ``SegmentPlan`` built once in set-up, as a server keeps it), the
argmax prediction of every node, copied to pinned host memory. Each
request is timed by two CUDA events: one recorded as it is issued, one
once its predictions have landed on the host. The check compares the
logits and predictions of a sample of the window's requests, drawn from
the seed, with the plain fp32 reference on the same inputs.

Config keys: ``family``, ``num_nodes``, ``num_edges``, ``num_features``,
``hidden``, ``num_layers``, ``num_classes``, ``degree_zipf``,
``degree_cap_share``, ``degree_seed``, ``bias_std``. Traffic keys:
``warmup`` (requests before the window), ``sample`` (requests kept for
the check), ``trace_units``.
"""
from __future__ import annotations

import math
import time

from bench import gen, harness, roofline
from bench.reference import sage as reference


def layer_dims(config) -> list:
    return ([config["num_features"]]
            + [config["hidden"]] * (config["num_layers"] - 1)
            + [config["num_classes"]])


def weight_specs(config) -> list:
    """(name, shape, std) of every weight, named as the GNN's
    ``state_dict``: N(0, 1/d_in) transforms, N(0, bias_std²) biases."""
    dims = layer_dims(config)
    specs = []
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        std = 1.0 / math.sqrt(d_in)
        specs += [(f"layers.{i}.w_self", (d_in, d_out), std),
                  (f"layers.{i}.w_neigh", (d_in, d_out), std),
                  (f"layers.{i}.b", (d_out,), config["bias_std"])]
    return specs


def inputs(torch, config, seed, device) -> dict:
    """The graph, the features and the weights. The in-degree of every
    node is drawn from the configuration's ``degree_seed``, the same for
    every run; the seed draws the edges' sources, the features and the
    weights."""
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


class Session:
    def __init__(self, torch, config, traffic, seed, device):
        from repro_torch.models import gnn
        self.torch, self.config, self.device = torch, config, device
        self.cuda = torch.device(device).type == "cuda"
        phases = harness.Phases(self.sync)
        self.data = inputs(torch, config, seed, device)
        phases.end("inputs")
        self.num_nodes = config["num_nodes"]
        dims = layer_dims(config)
        with torch.device("meta"):
            model = gnn.GNN(config["family"], dims)
        model.load_state_dict(self.data["weights"], assign=True)
        self.model = model.eval()
        self.edge_index = torch.stack([self.data["src"], self.data["dst"]])
        self.plan = gnn.make_model_plan(self.edge_index, self.num_nodes,
                                        feat=max(dims), device=device)
        phases.end("model and plan")
        self.sample = harness.Reservoir(seed, traffic["sample"])
        self.times = []
        self.flops_per_unit = roofline.sage_infer_flops(
            self.num_nodes, config["num_edges"], dims)
        self.peak_flops = roofline.FP32_FLOPS
        for _ in range(traffic.get("warmup", 2)):
            self._request()
        phases.end("warm-up")
        self.times.clear()
        self.last = None

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def _request(self):
        """One request: the forward, the argmax, the predictions copied
        into pinned host memory (as a server's fetch would) and waited
        for. On the card two CUDA events time it: one recorded as it is
        issued, one once the copy to the host has landed."""
        torch = self.torch
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        with torch.inference_mode():
            logits = self.model(self.data["x"], self.edge_index,
                                self.num_nodes, plan=self.plan)
            pred = logits.argmax(1)
        host = torch.empty(pred.shape, dtype=pred.dtype, pin_memory=self.cuda)
        host.copy_(pred, non_blocking=self.cuda)
        if self.cuda:
            end.record()
            end.synchronize()
            self.times.append((start, end))
        else:
            self.times.append(time.perf_counter() - t0)
        return logits, host

    def unit(self):
        answer = self._request()
        self.sample.offer(answer)
        self.last = answer

    def latencies(self) -> list:
        if not self.cuda:
            return list(self.times)
        self.torch.cuda.synchronize(self.device)
        return [s.elapsed_time(e) / 1e3 for s, e in self.times]

    def failed(self) -> int:
        return 0

    def check(self) -> dict:
        """Frees the program's model and plan, then compares every kept
        answer with the reference: ``logit_err``, the largest |program -
        reference| logit over the reference's largest |logit|; and
        ``argmax_gap``, the largest amount by which the reference's logit of
        a node's predicted class lies below its best, on the same scale."""
        torch = self.torch
        kept = list(self.sample.items)
        if self.last is not None and all(self.last is not k for k in kept):
            kept.append(self.last)
        del self.model, self.plan, self.edge_index, self.sample, self.last
        if self.cuda:
            torch.cuda.empty_cache()
        d = self.data
        ref = reference.forward(d["x"], d["src"], d["dst"], self.num_nodes,
                                reference.layers_of(
                                    d["weights"], self.config["num_layers"]))
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

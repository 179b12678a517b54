"""GNNServer: synchronous GNN inference serving on the card.

One ``step()`` of the serving loop:

    queue ──GraphBatcher──▶ block-diagonal batch (batch_graphs)
          ──buckets──────▶ pad to the batch's ShapeBucket (drop-id edges)
          ──PlanCache────▶ BucketEntry: canonical config / max_chunks / stats
          ──stamp────────▶ per-request chunk metadata, on the device
          ──forward──────▶ the model's layers, each aggregation one kernel
          ──unpad/unbatch▶ per-request logits + latency / launch stats

A cache hit performs no plan or config work: the per-request cost is one
``searchsorted`` stamp on the device, the host-to-device copies, and the
forward.

The server runs on the card by default (``device=None`` means ``"cuda"``)
and raises when there is none; ``device="cpu"`` runs the plain versions,
as the tests do. Counters are plain attributes of the server.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.config_space import default_config
from repro_torch.core.device import resolve_device
from repro_torch.data.graphs import (Graph, batch_graphs, synth_graph,
                                     unbatch_nodes, unpad_nodes)
from repro_torch.kernels.ops import fusion_scope
from repro_torch.models.gnn import GNN, MODELS
from repro_torch.serve.batcher import GraphBatcher, GraphRequest
from repro_torch.serve.buckets import BucketPolicy, ShapeBucket, pad_to_bucket
from repro_torch.serve.plan_cache import BucketEntry, PlanCache

__all__ = ["ServedResult", "GNNServer"]


@dataclasses.dataclass
class ServedResult:
    """Per-request outcome + the latency/efficiency breakdown."""
    uid: int
    logits: np.ndarray            # (V_request, C)
    bucket: ShapeBucket
    batch_size: int               # graphs co-served in this step
    queue_s: float                # submit -> admission
    serve_s: float                # batch -> pad -> stamp -> forward -> host
    latency_s: float              # submit -> result
    cache_hit: bool
    built: bool                   # this step built the bucket's cache entry
    pad_nodes: int                # bucket V minus batch V (waste)
    pad_edges: int
    fusion: Dict[str, int]        # kernels ("fused:…") and plain versions
    #                               ("unfused:…") this step ran
    stages: Dict[str, float]      # host-clock seconds of this step's stages:
    #                               batch, pad, cache (lookup or build),
    #                               copy (to the device), stamp, forward
    #                               (enqueue), fetch (wait for the device +
    #                               logits back to the host)


class GNNServer:
    """Synchronous serving engine for one model.

    ``submit()`` enqueues graphs; ``step()`` serves one micro-batch;
    ``run_until_drained()`` loops. All four families work (GCN / GIN /
    SAGE / multi-head GAT). The model is moved to ``device`` and put in
    eval mode.

    Knobs: bucket ``policy`` (pad waste vs cache entries),
    ``cache_capacity`` (entries held), batch budget + ``max_wait_s``
    (throughput vs tail latency). On the card every aggregation runs its
    CUDA kernel; on the CPU its plain version.
    """

    def __init__(self, model: GNN, family: Optional[str] = None, *,
                 device=None,
                 policy: Optional[BucketPolicy] = None,
                 cache_capacity: int = 32,
                 max_batch_nodes: int = 4096,
                 max_batch_edges: Optional[int] = None,
                 max_batch_graphs: int = 16,
                 max_wait_s: float = 0.0):
        family = model.family if family is None else family
        if family not in MODELS or family != model.family:
            raise ValueError(f"model is a {model.family!r}; family must be "
                             f"that one of {MODELS}, got {family!r}")
        self.device = resolve_device(device, "GNNServer")
        self.model = model.to(self.device).eval()
        self.family = family
        self.feat = max(model.dims)     # sizes the bucket's kernel config
        self.policy = policy or BucketPolicy()
        self.cache = PlanCache(capacity=cache_capacity)
        self.batcher = GraphBatcher(max_batch_nodes=max_batch_nodes,
                                    max_batch_edges=max_batch_edges,
                                    max_batch_graphs=max_batch_graphs,
                                    max_wait_s=max_wait_s)
        self._uid = 0
        self.results: Dict[int, ServedResult] = {}
        self.reset()

    # -- admission -----------------------------------------------------------
    def submit(self, graph: Graph, uid: Optional[int] = None) -> int:
        """Enqueue one graph; returns its request id."""
        if graph.orig_num_nodes is not None:
            raise ValueError("submit expects unpadded graphs; the engine "
                             "pads to its own buckets")
        if uid is not None and (uid in self.results
                                or any(r.uid == uid
                                       for r in self.batcher.queue)):
            raise ValueError(f"duplicate request uid {uid}: its result "
                             "would silently overwrite the earlier one")
        if uid is None:
            uid = self._uid
        self._uid = max(self._uid, uid) + 1
        self.batcher.submit(GraphRequest(uid=uid, graph=graph))
        return uid

    # -- cache entries -------------------------------------------------------
    def _entry_key(self, bucket: ShapeBucket):
        return (bucket, self.feat, self.family, str(self.device))

    def _build_entry(self, bucket: ShapeBucket) -> BucketEntry:
        return BucketEntry(bucket, self.feat, default_config(self.feat))

    def _get_entry(self, bucket: ShapeBucket, weight: int = 1, warm=False):
        """(entry, built): the bucket's cache line and whether this call
        built it."""
        before = self.cache.stats.plan_builds
        key, build = self._entry_key(bucket), lambda: self._build_entry(bucket)
        entry = (self.cache.warm(key, build) if warm
                 else self.cache.get_or_build(key, build, weight=weight))
        return entry, self.cache.stats.plan_builds > before

    # -- one serving iteration ----------------------------------------------
    def step(self, flush: bool = False) -> List[ServedResult]:
        """Admit one micro-batch and serve it; [] when the batcher holds."""
        reqs = self.batcher.next_batch(flush=flush)
        if not reqs:
            return []
        t0 = time.perf_counter()
        batch = batch_graphs([r.graph for r in reqs])
        t_batch = time.perf_counter()
        padded, bucket = pad_to_bucket(batch, self.policy)
        t_pad = time.perf_counter()
        entry, built = self._get_entry(bucket, weight=len(reqs))
        stages = {"batch": t_batch - t0, "pad": t_pad - t_batch,
                  "cache": time.perf_counter() - t_pad}
        with fusion_scope() as fusion:
            logits = self._run(entry, padded, stages)
        t_fwd = time.perf_counter()
        logits = logits.float().cpu().numpy()      # waits for the device
        t1 = time.perf_counter()
        stages["fetch"] = t1 - t_fwd
        if built:
            self.builds += 1
        self.batches += 1
        self.serve_s += t1 - t0
        self._pad_nodes.append(bucket.num_nodes / max(batch.num_nodes, 1))
        self._pad_edges.append(bucket.num_edges / max(batch.num_edges, 1))
        per_graph = unbatch_nodes(batch, unpad_nodes(padded, logits))
        out = []
        for req, y in zip(reqs, per_graph):
            res = ServedResult(
                uid=req.uid, logits=y, bucket=bucket, batch_size=len(reqs),
                queue_s=t0 - req.t_submit, serve_s=t1 - t0,
                latency_s=t1 - req.t_submit, cache_hit=not built,
                built=built, pad_nodes=bucket.num_nodes - batch.num_nodes,
                pad_edges=bucket.num_edges - batch.num_edges,
                fusion=dict(fusion), stages=stages)
            self.results[req.uid] = res
            self.requests += 1
            self._latency.append(res.latency_s)
            self._queue.append(res.queue_s)
            out.append(res)
        return out

    def _run(self, entry: BucketEntry, padded: Graph,
             stages: Optional[Dict[str, float]] = None):
        """The padded forward, enqueued; ``stages`` (if given) gains the
        host-clock seconds of copy, stamp and forward."""
        t0 = time.perf_counter()
        dev = self.device
        dtype = next(self.model.parameters()).dtype
        x = torch.from_numpy(padded.x).to(dev, dtype)
        ei = torch.from_numpy(padded.edge_index).to(dev)
        dis = torch.from_numpy(padded.deg_inv_sqrt).to(dev, dtype)
        t1 = time.perf_counter()
        plan = entry.stamp(ei[1])       # on the device, from the copied dst
        t2 = time.perf_counter()
        with torch.inference_mode():
            out = self.model(x, ei, padded.num_nodes, dis, plan=plan)
        if stages is not None:
            stages.update(copy=t1 - t0, stamp=t2 - t1,
                          forward=time.perf_counter() - t2)
        return out

    def run_until_drained(self, max_steps: int = 100_000
                          ) -> Dict[int, ServedResult]:
        steps = 0
        while self.batcher.queue and steps < max_steps:
            self.step(flush=True)
            steps += 1
        return self.results

    # -- warmup ---------------------------------------------------------------
    def warmup(self, buckets: Sequence[ShapeBucket]) -> int:
        """Build cache lines ahead of traffic and run each new one once on
        an all-padding member of its bucket (kernels built and loaded,
        allocator warm). Returns the number of entries built; prefills do
        not count as cache misses."""
        buckets = list(buckets)
        if len(buckets) > self.cache.capacity:
            raise ValueError(
                f"warming {len(buckets)} buckets into a capacity-"
                f"{self.cache.capacity} cache would evict the earliest "
                "prefills immediately; raise cache_capacity")
        built = 0
        for bucket in buckets:
            entry, new = self._get_entry(bucket, warm=True)
            if not new:
                continue
            g = synth_graph(f"warmup-{bucket}", min(2, bucket.num_nodes), 0,
                            feat=self.model.dims[0])
            padded, _ = pad_to_bucket(g, bucket=bucket)
            self._run(entry, padded).cpu()
            built += 1
        self.builds += built
        return built

    # -- stats ----------------------------------------------------------------
    def stats(self) -> Dict:
        """The serving-window summary. Well-defined on a cold engine: every
        count is 0, throughput / latencies 0.0, pad overheads 1.0."""
        lat = self._latency
        return {
            "requests": self.requests,
            "batches": self.batches,
            "mean_batch_size": (self.requests / self.batches
                                if self.batches else 0.0),
            "builds": self.builds,
            "buckets": len(self.cache),
            "cache": self.cache.stats.as_dict(),
            "throughput_rps": (self.requests / self.serve_s
                               if self.serve_s else 0.0),
            "latency_mean_s": float(np.mean(lat)) if lat else 0.0,
            "latency_p95_s": (float(np.percentile(lat, 95, method="higher"))
                              if lat else 0.0),
            "pad_node_overhead": (float(np.mean(self._pad_nodes))
                                  if self._pad_nodes else 1.0),
            "pad_edge_overhead": (float(np.mean(self._pad_edges))
                                  if self._pad_edges else 1.0),
        }

    def reset(self) -> None:
        """Zero the serving-window accounting and the delivered results;
        cache lines are kept."""
        self.requests = self.batches = self.builds = 0
        self.serve_s = 0.0
        self._latency: List[float] = []
        self._queue: List[float] = []
        self._pad_nodes: List[float] = []
        self._pad_edges: List[float] = []
        self.results.clear()

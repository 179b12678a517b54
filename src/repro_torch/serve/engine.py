"""GNNServer: synchronous GNN inference serving on the card.

One ``step()`` of the serving loop:

    queue ──GraphBatcher──▶ block-diagonal batch (batch_graphs)
          ──buckets──────▶ pad to the batch's ShapeBucket (drop-id edges)
          ──PlanCache────▶ BucketEntry: canonical config / stats
          ──copy─────────▶ the padded arrays to the device
          ──stamp────────▶ per-request row offsets, on the device
          ──execute──────▶ the model's layers, each aggregation one kernel
          ──fetch────────▶ logits back to the host, unpadded and unbatched

A cache hit performs no plan or config work: the per-request cost is one
``searchsorted`` stamp on the device, the host-to-device copies, and the
forward. Sampled mini-batches (:meth:`GNNServer.sampled_pipeline`,
:meth:`GNNServer.serve_sampled`) arrive on the device already stamped by
the prefetch pipeline's producers, against this engine's own cache.

The server runs on the card by default (``device=None`` means ``"cuda"``)
and raises when there is none; ``device="cpu"`` runs the plain versions,
as the tests do. Its accounting lives in the :mod:`repro_torch.obs`
registry under the engine's instance label (vital instruments: ``stats()``
works with observability disabled), and each step opens the span tree
``serve.step`` ⊃ ``serve.batch``, ``serve.pad``, ``serve.plan_cache``,
``serve.copy``, ``serve.stamp``, ``serve.execute``, ``serve.fetch``. A
bucket's *build* is its entry's first run (PyTorch compiles nothing):
``serve.builds`` counts it, :func:`repro_torch.obs.record_build` names its
cause, and its ``serve.execute`` span carries ``new_bucket=True``.

``shards > 1`` serves through the partitioned path
(:mod:`repro_torch.core.dist_mp`), SPMD: one server a rank of a
``shards``-rank process group, each on its own device. Every rank must
submit the same requests in the same order and step the same number of
times, or the ranks' collectives pair up wrongly and hang. The padded
batch is partitioned and planned per request inside the ``serve.stamp``
span (the partition depends on the degree distribution, not only on the
bucket), and every rank returns the same replicated logits. Sampled
serving is single-device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.device import resolve_device
from repro_torch.data.graphs import (Graph, batch_graphs, synth_graph,
                                     unbatch_nodes, unpad_nodes)
from repro_torch.kernels.ops import fusion_scope
from repro_torch.models.gnn import GNN, MODELS
from repro_torch.obs import span
from repro_torch.serve.batcher import GraphBatcher, GraphRequest
from repro_torch.serve.buckets import BucketPolicy, ShapeBucket, pad_to_bucket
from repro_torch.serve.plan_cache import BucketEntry, PlanCache, bucket_config

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
    cache_hit: bool               # the bucket's entry had run before
    built: bool                   # this step was the entry's first run
    pad_nodes: int                # bucket V minus batch V (waste)
    pad_edges: int
    fusion: Dict[str, int]        # kernels ("fused:…") and plain versions
    #                               ("unfused:…") this step ran
    stages: Dict[str, float]      # host-clock seconds of this step's stages:
    #                               batch, pad, cache (lookup or build),
    #                               copy (to the device), stamp, forward
    #                               (enqueue), fetch (wait for the device +
    #                               logits back to the host)


@contextlib.contextmanager
def _stage(stages: Optional[Dict[str, float]], key: str, name: str,
           **attrs):
    """One stage of a step: the span ``name``, and its host-clock seconds
    in ``stages[key]`` (when ``stages`` is given)."""
    t0 = time.perf_counter()
    with span(name, **attrs) as s:
        yield s
    if stages is not None:
        stages[key] = time.perf_counter() - t0


class GNNServer:
    """Synchronous serving engine for one model.

    ``submit()`` enqueues graphs; ``step()`` serves one micro-batch;
    ``run_until_drained()`` loops. All four families work (GCN / GIN /
    SAGE / multi-head GAT). The model is moved to ``device`` and put in
    eval mode.

    Knobs: bucket ``policy`` (pad waste vs cache entries),
    ``cache_capacity`` (entries held), batch budget + ``max_wait_s``
    (throughput vs tail latency), ``tune`` (pay sweeps on the card, at a
    bucket's first build, for measured kernel configs) and ``perfdb``
    (the :class:`~repro_torch.core.autotune.PerfDB` the buckets' configs
    are looked up in and swept into; the default one otherwise). On the
    card every aggregation runs its CUDA kernel; on the CPU its plain
    version. ``shards`` > 1 (with ``mesh``, this rank's
    :class:`~repro_torch.core.dist_mp.ShardMesh`, or the default group's
    when omitted) serves every request sharded across the ranks: each
    rank must submit and step exactly as the others do (see the module
    docstring).
    """

    def __init__(self, model: GNN, family: Optional[str] = None, *,
                 device=None,
                 policy: Optional[BucketPolicy] = None,
                 cache_capacity: int = 32,
                 max_batch_nodes: int = 4096,
                 max_batch_edges: Optional[int] = None,
                 max_batch_graphs: int = 16,
                 max_wait_s: float = 0.0,
                 tune: bool = False,
                 shards: int = 0,
                 mesh=None,
                 perfdb=None):
        family = model.family if family is None else family
        if family not in MODELS or family != model.family:
            raise ValueError(f"model is a {model.family!r}; family must be "
                             f"that one of {MODELS}, got {family!r}")
        self.device = resolve_device(device, "GNNServer")
        self.model = model.to(self.device).eval()
        self.family = family
        self.feat = max(model.dims)     # sizes the bucket's kernel config
        self.policy = policy or BucketPolicy()
        self.tune = bool(tune)
        if perfdb is None or isinstance(perfdb, (str, os.PathLike)):
            # one PerfDB for the engine's lifetime: its JSON is parsed once
            from repro_torch.core.autotune import PerfDB
            perfdb = PerfDB(perfdb)
        self._perfdb = perfdb
        self.shards = int(shards)
        self.mesh = None
        if self.shards > 1:
            from repro_torch.core.dist_mp import check_mesh, make_shard_mesh
            self.mesh = (make_shard_mesh(self.shards, device=self.device)
                         if mesh is None else check_mesh(mesh))
            if self.mesh.size != self.shards or \
                    self.mesh.device != self.device:
                raise ValueError(
                    f"the mesh has {self.mesh.size} ranks on "
                    f"{self.mesh.device}; the server {self.shards} shards "
                    f"on {self.device}")
        self.cache = PlanCache(capacity=cache_capacity)
        self.batcher = GraphBatcher(max_batch_nodes=max_batch_nodes,
                                    max_batch_edges=max_batch_edges,
                                    max_batch_graphs=max_batch_graphs,
                                    max_wait_s=max_wait_s)
        self._uid = 0
        self.results: Dict[int, ServedResult] = {}
        reg = obs.get_registry()
        self._labels = {"engine": obs.next_id("engine")}
        self._m_requests = reg.counter("serve.requests", ("engine",),
                                       vital=True)
        self._m_batches = reg.counter("serve.batches", ("engine",),
                                      vital=True)
        self._m_serve_s = reg.counter("serve.serve_s", ("engine",),
                                      vital=True)
        self._m_builds = reg.counter("serve.builds", ("engine",), vital=True)
        self._m_latency = reg.histogram("serve.request_latency_s",
                                        ("engine",), vital=True)
        self._m_queue = reg.histogram("serve.queue_s", ("engine",),
                                      vital=True)
        self._m_pad_nodes = reg.histogram("serve.pad_node_frac",
                                          ("engine",), vital=True,
                                          buckets=(1.0, 1.5, 2.0, 4.0, 8.0))
        self._m_pad_edges = reg.histogram("serve.pad_edge_frac",
                                          ("engine",), vital=True,
                                          buckets=(1.0, 1.5, 2.0, 4.0, 8.0))
        self._metrics = (self._m_requests, self._m_batches, self._m_serve_s,
                         self._m_builds, self._m_latency, self._m_queue,
                         self._m_pad_nodes, self._m_pad_edges)
        for m in self._metrics:
            m.touch(**self._labels)

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
        return (bucket, self.feat, self.family, str(self.device), self.shards)

    def _build_entry(self, bucket: ShapeBucket) -> BucketEntry:
        """The bucket's cache line, its config resolved once
        (:func:`~repro_torch.serve.plan_cache.bucket_config`): the measured
        PerfDB winner for the bucket's shape class > with ``tune=True``, a
        sweep on the card > the generated rules."""
        return BucketEntry(bucket, self.feat,
                           bucket_config(bucket, self.feat, tune=self.tune,
                                         db=self._perfdb))

    def _entry(self, bucket: ShapeBucket, weight: int = 1,
               warm: bool = False) -> BucketEntry:
        key, build = self._entry_key(bucket), lambda: self._build_entry(bucket)
        return (self.cache.warm(key, build) if warm
                else self.cache.get_or_build(key, build, weight=weight))

    def _execute(self, entry: BucketEntry, cause: str, run):
        """``run()`` under the ``serve.execute`` span; an entry's first run
        is the bucket's build: counted and attributed to ``cause``."""
        new = not entry.executed
        with span("serve.execute", bucket=str(entry.bucket),
                  new_bucket=new):
            out = run()
        if new:
            entry.executed = True
            self._m_builds.inc(**self._labels)
            obs.record_build("serve.forward", cause,
                             engine=self._labels["engine"],
                             bucket=str(entry.bucket), model=self.family,
                             feat=self.feat, device=str(self.device))
        return out, new

    # -- one serving iteration ----------------------------------------------
    def step(self, flush: bool = False) -> List[ServedResult]:
        """Admit one micro-batch and serve it; [] when the batcher holds."""
        reqs = self.batcher.next_batch(flush=flush)
        if not reqs:
            return []
        stages: Dict[str, float] = {}
        with span("serve.step", engine=self._labels["engine"],
                  requests=len(reqs)) as root:
            t0 = time.perf_counter()
            with _stage(stages, "batch", "serve.batch", graphs=len(reqs)):
                batch = batch_graphs([r.graph for r in reqs])
            with _stage(stages, "pad", "serve.pad"):
                padded, bucket = pad_to_bucket(batch, self.policy)
            root.set(bucket=str(bucket))
            with _stage(stages, "cache", "serve.plan_cache",
                        bucket=str(bucket)):
                entry = self._entry(bucket, weight=len(reqs))
            with fusion_scope() as fusion:
                logits, built = self._run(entry, padded, stages,
                                          "bucket_miss")
            with _stage(stages, "fetch", "serve.fetch"):
                logits = logits.float().cpu().numpy()  # waits for the device
            t1 = time.perf_counter()
            self._m_batches.inc(**self._labels)
            self._m_serve_s.inc(t1 - t0, **self._labels)
            self._m_pad_nodes.observe(
                bucket.num_nodes / max(batch.num_nodes, 1), **self._labels)
            self._m_pad_edges.observe(
                bucket.num_edges / max(batch.num_edges, 1), **self._labels)
            per_graph = unbatch_nodes(batch, unpad_nodes(padded, logits))
            out = []
            for req, y in zip(reqs, per_graph):
                res = ServedResult(
                    uid=req.uid, logits=y, bucket=bucket,
                    batch_size=len(reqs), queue_s=t0 - req.t_submit,
                    serve_s=t1 - t0, latency_s=t1 - req.t_submit,
                    cache_hit=not built, built=built,
                    pad_nodes=bucket.num_nodes - batch.num_nodes,
                    pad_edges=bucket.num_edges - batch.num_edges,
                    fusion=dict(fusion), stages=stages)
                self.results[req.uid] = res
                self._m_requests.inc(**self._labels)
                self._m_latency.observe(res.latency_s, **self._labels)
                self._m_queue.observe(res.queue_s, **self._labels)
                out.append(res)
            return out

    def _run(self, entry: BucketEntry, padded: Graph,
             stages: Optional[Dict[str, float]], cause: str):
        """The padded forward, enqueued: (logits on the device, whether this
        was the entry's first run). ``stages`` (if given) gains the
        host-clock seconds of copy, stamp and forward."""
        dev = self.device
        dtype = next(self.model.parameters()).dtype
        with _stage(stages, "copy", "serve.copy"):
            x = torch.from_numpy(padded.x).to(dev, dtype)
            ei = torch.from_numpy(padded.edge_index).to(dev)
            dis = torch.from_numpy(padded.deg_inv_sqrt).to(dev, dtype)
        part = None
        if self.shards > 1:
            from repro_torch.core.plan import make_partitioned_plan
            from repro_torch.data.partition import partition_graph
            with _stage(stages, "stamp", "serve.stamp", sharded=True):
                part = partition_graph(padded, self.shards, device=dev)
                plan = make_partitioned_plan(part, feat=self.feat,
                                             config=entry.config)
        else:
            with _stage(stages, "stamp", "serve.stamp"):
                plan = entry.stamp(ei[1])   # on the device, from the dst
        t0 = time.perf_counter()
        out = self._execute(entry, cause, lambda: self._forward(
            x, ei, padded.num_nodes, dis, plan, part))
        if stages is not None:
            stages["forward"] = time.perf_counter() - t0
        return out

    def _forward(self, x, ei, num_nodes: int, dis, plan, partition=None):
        with torch.inference_mode():
            return self.model(x, ei, num_nodes, dis, plan=plan,
                              mesh=self.mesh, partition=partition)

    def run_until_drained(self, max_steps: int = 100_000
                          ) -> Dict[int, ServedResult]:
        steps = 0
        while self.batcher.queue and steps < max_steps:
            self.step(flush=True)
            steps += 1
        return self.results

    # -- sampled (out-of-core) ingest -----------------------------------------
    def sampled_pipeline(self, sampler, *, depth: int = 2,
                         num_threads: Optional[int] = None):
        """An async prefetch pipeline whose batches are served by this
        engine's cache lines: the producer shares ``self.cache`` and builds
        entries as this engine does, on this engine's device (the
        card unless the server was built on the CPU), so a batch's plan is
        stamped under the entry :meth:`serve_sampled` runs — one entry per
        bucket across the producer threads and the serving loop."""
        from repro_torch.data.pipeline import (PrefetchPipeline,
                                               SampledBatchProducer)
        self._single_device("sampled serving")
        producer = SampledBatchProducer(
            sampler, feat=self.feat, policy=self.policy, cache=self.cache,
            entry_key=self._entry_key, entry_builder=self._build_entry,
            device=self.device)
        return PrefetchPipeline(producer, depth=depth,
                                num_threads=num_threads)

    def serve_sampled(self, batch) -> np.ndarray:
        """Serve one :class:`~repro_torch.data.pipeline.SampledBatch`: the
        seed rows' logits, (num_seeds, C). A batch from
        :meth:`sampled_pipeline` runs with its stamped plan as it is; a
        batch stamped against another cache's entry is re-stamped under
        this engine's (the ``serve.stamp`` span carries ``restamp=True``),
        not rebuilt."""
        self._single_device("sampled serving")
        if batch.arrays["x"].device != self.device:
            raise ValueError(f"the batch lies on {batch.arrays['x'].device}, "
                             f"the server on {self.device}")
        batch.ready()
        with span("serve.step", engine=self._labels["engine"],
                  bucket=str(batch.bucket), sampled=True):
            t0 = time.perf_counter()
            with span("serve.plan_cache", bucket=str(batch.bucket)):
                entry = self._entry(batch.bucket)
            plan = batch.plan
            if batch.entry is not entry:
                with span("serve.stamp", restamp=True):
                    plan = entry.stamp(batch.arrays["edge_index"][1])
            dtype = next(self.model.parameters()).dtype
            a = batch.arrays
            logits, _ = self._execute(
                entry, "sampled_ingest", lambda: self._forward(
                    a["x"].to(dtype), a["edge_index"], batch.bucket.num_nodes,
                    a["deg_inv_sqrt"].to(dtype), plan))
            with span("serve.fetch"):
                logits = logits[:batch.num_seeds].float().cpu().numpy()
            self._m_batches.inc(**self._labels)
            self._m_serve_s.inc(time.perf_counter() - t0, **self._labels)
            return logits

    def _single_device(self, what: str) -> None:
        if self.shards > 1:
            raise NotImplementedError(
                f"{what} is single-device (the sharded path partitions "
                "each request)")

    # -- warmup ---------------------------------------------------------------
    def warmup(self, buckets: Sequence[ShapeBucket]) -> int:
        """Build cache lines ahead of traffic and run each new one once on
        an all-padding member of its bucket (kernels built and loaded,
        allocator warm). Returns the number of entries run; prefills do
        not count as cache misses."""
        buckets = list(buckets)
        if len(buckets) > self.cache.capacity:
            raise ValueError(
                f"warming {len(buckets)} buckets into a capacity-"
                f"{self.cache.capacity} cache would evict the earliest "
                "prefills immediately; raise cache_capacity")
        built = 0
        for bucket in buckets:
            entry = self._entry(bucket, warm=True)
            if entry.executed:
                continue
            g = synth_graph(f"warmup-{bucket}", min(2, bucket.num_nodes), 0,
                            feat=self.model.dims[0])
            padded, _ = pad_to_bucket(g, bucket=bucket)
            self._run(entry, padded, None, "warmup")[0].cpu()
            built += 1
        return built

    # -- stats ----------------------------------------------------------------
    @property
    def builds(self) -> int:
        """Bucket entries run for the first time (warmup + serving)."""
        return int(self._m_builds.value(**self._labels))

    def stats(self) -> Dict:
        """The serving-window summary, read off the registry. Well-defined
        on a cold engine: every count is 0, throughput / latencies 0.0, pad
        overheads 1.0 (no padding observed == no waste)."""
        lab = self._labels
        requests = int(self._m_requests.value(**lab))
        batches = int(self._m_batches.value(**lab))
        serve_s = self._m_serve_s.value(**lab)
        n_lat = self._m_latency.count(**lab)
        n_pad = self._m_pad_nodes.count(**lab)
        return {
            "requests": requests,
            "batches": batches,
            "mean_batch_size": requests / batches if batches else 0.0,
            "builds": self.builds,
            "buckets": len(self.cache),
            "cache": self.cache.stats.as_dict(),
            "throughput_rps": requests / serve_s if serve_s else 0.0,
            "latency_mean_s": (self._m_latency.mean(**lab) if n_lat
                               else 0.0),
            "latency_p95_s": (self._m_latency.percentile(95, **lab)
                              if n_lat else 0.0),
            "pad_node_overhead": (self._m_pad_nodes.mean(**lab) if n_pad
                                  else 1.0),
            "pad_edge_overhead": (self._m_pad_edges.mean(**lab) if n_pad
                                  else 1.0),
        }

    def reset(self) -> None:
        """Zero this engine's serving-window accounting (counters,
        latency/padding histograms, delivered results). Cache lines are
        kept — ``reset()`` starts a fresh measurement window, not a fresh
        engine — so ``stats()`` right after is the cold-engine shape."""
        for m in self._metrics:
            m.reset(**self._labels)
            m.touch(**self._labels)
        self.results.clear()

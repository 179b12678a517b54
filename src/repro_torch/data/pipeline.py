"""Async host→device mini-batch pipeline over the neighbour sampler — the
back half of the out-of-core path, as the reference's
(``repro/data/pipeline.py``).

The per-step host work of sampled training is substantial: k-hop
expansion, bucket padding, the plan-cache lookup, the host-to-device
copies and the plan stamp. Run synchronously, all of it sits on the
critical path between device steps. This module moves it off:

  :class:`SampledBatchProducer`
      the function ``step -> SampledBatch``: sample (via
      :class:`~repro_torch.data.sampling.NeighborSampler`), pad onto the
      serving bucket ladder (:func:`~repro_torch.serve.buckets.
      pad_to_bucket`), resolve the bucket's
      :class:`~repro_torch.serve.plan_cache.BucketEntry` from a
      thread-safe :class:`~repro_torch.serve.plan_cache.PlanCache`, copy
      the arrays to the device, and stamp the plan there — its row
      offsets, plus the graph's
      :class:`~repro_torch.core.plan.SourceOrder`, so a training step's
      backward walks follow it instead of sorting on the device.

      On the card each producer thread works on a ``torch.cuda.Stream`` of
      its own: pinned host tensors, ``non_blocking`` copies, the stamp
      and the source order inside that stream, then a recorded
      ``torch.cuda.Event``. :meth:`SampledBatch.ready` makes the
      consumer's current stream wait on that event and records the
      batch's tensors as used there (``record_stream``), so the caching
      allocator never hands a producer's tensor to other work while the
      consumer's kernels still read it. On the CPU the producer does the
      same work without streams.

  :class:`PrefetchPipeline`
      bounded-depth prefetch: while the consumer runs step ``t``, a small
      thread pool produces steps ``t+1 .. t+depth``, so the next batch
      is on the device when the consumer asks. ``depth=0`` is the
      synchronous loader. ``stats()["overlap"]`` is the fraction of host
      production hidden from the consumer. The producers share the
      interpreter lock with the consumer, and the expansion is Python,
      so the overlap a training loop gets is bounded by how long its own
      step leaves the lock free (PERF.md).

A batch is a pure function of ``(sampler.seed, step)``: producer threads
decide only *when* a batch is made, never *what* it holds, so any
prefetch depth, thread count or scheduling order yields the bitwise same
batch stream, and checkpoint replay stays exact through the async path.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.device import resolve_device
from repro_torch.core.plan import SegmentPlan, source_order
from repro_torch.data.graphs import Graph
from repro_torch.data.sampling import NeighborSampler
from repro_torch.obs import span
from repro_torch.serve.buckets import (BucketPolicy, ShapeBucket, bucket_for,
                                       pad_to_bucket)
from repro_torch.serve.plan_cache import BucketEntry, PlanCache, bucket_config

__all__ = ["SampledBatch", "SampledBatchProducer", "PrefetchPipeline"]


def _plan_tensors(plan: SegmentPlan):
    """Every tensor a plan holds (its source order's too)."""
    out = [plan.row_ptr]
    order = plan.src_order
    if order is not None:
        out += [order.perm, order.src, order.dst, order.row_ptr]
    return out


@dataclasses.dataclass
class SampledBatch:
    """One mini-batch on the device: the padded host graph plus what a
    step consumes — device tensors and the bucket's stamped plan.

    ``arrays`` holds ``x`` (V_bucket, F) float32, ``edge_index``
    (2, E_bucket) int32, ``deg_inv_sqrt`` (V_bucket,), ``labels``
    (V_bucket,) int64 and ``label_mask`` (V_bucket,) float32 — 1.0
    exactly on the seed rows, the rows a loss may read (sampled
    neighbours have truncated neighbourhoods). ``entry`` is the cache
    line the plan was stamped against; ``event`` the producer stream's
    event after the batch's last device work (None on the CPU). Call
    :meth:`ready` in the thread that consumes the batch before using its
    tensors (:class:`PrefetchPipeline` does)."""
    step: int
    graph: Graph                  # padded, host-side
    bucket: ShapeBucket
    num_seeds: int
    seed_nodes: np.ndarray        # (num_seeds,) global ids
    plan: SegmentPlan             # the entry's static fields, this batch's
    #                               metadata and source order
    arrays: Dict[str, torch.Tensor]
    entry: BucketEntry
    event: Optional[torch.cuda.Event] = None
    produce_s: float = 0.0        # host time to make this batch
    wait_s: float = 0.0           # consumer time blocked on this batch

    def ready(self) -> "SampledBatch":
        """Hand the batch to the calling thread's current stream: wait for
        the producer's event and mark every tensor as used on this stream.
        Idempotent; nothing to do on the CPU."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.arrays["x"].device)
            stream.wait_event(self.event)
            for t in list(self.arrays.values()) + _plan_tensors(self.plan):
                t.record_stream(stream)
        return self


class SampledBatchProducer:
    """The deterministic ``step -> SampledBatch`` function.

    Plans come from a :class:`PlanCache` keyed and built like a serving
    engine's — pass ``entry_key`` / ``entry_builder`` (as
    :meth:`GNNServer.sampled_pipeline` does) to share cache lines with an
    engine, or let the defaults build engine-equivalent entries. ``feat``
    is the plans' representative feature width (the model's widest
    layer). The default entries take the engine's precedence without the
    sweep (producer threads never time kernels): the PerfDB's measured
    winner (``perfdb``, else the default one) > the generated rules.
    ``device``: where batches go (``None``: the card, raising without one;
    ``"cpu"`` for the plain versions)."""

    def __init__(self, sampler: NeighborSampler, *,
                 feat: int = 128,
                 policy: Optional[BucketPolicy] = None,
                 cache: Optional[PlanCache] = None,
                 entry_key: Optional[Callable[[ShapeBucket], object]] = None,
                 entry_builder: Optional[
                     Callable[[ShapeBucket], BucketEntry]] = None,
                 device=None, perfdb=None):
        self.device = resolve_device(device, "SampledBatchProducer")
        self.sampler = sampler
        self.feat = int(feat)
        self.policy = policy or BucketPolicy()
        self.cache = cache if cache is not None else PlanCache()
        self._entry_key = entry_key or (
            lambda b: (b, self.feat, "sampled"))
        self._perfdb = perfdb
        self._entry_builder = entry_builder or (
            lambda b: BucketEntry(b, self.feat, bucket_config(
                b, self.feat, db=self._perfdb)))
        self._local = threading.local()     # each thread's CUDA stream

    def entry_for(self, bucket: ShapeBucket) -> BucketEntry:
        return self.cache.get_or_build(
            self._entry_key(bucket), lambda: self._entry_builder(bucket))

    def buckets_for_warmup(self, probe_steps: int = 8) -> list:
        """The distinct buckets the first ``probe_steps`` batches touch —
        sampling is deterministic, so probing IS the schedule (host-only:
        nothing is padded or copied)."""
        seen = []
        for s in range(probe_steps):
            sub = self.sampler.sample_batch(s)
            b = bucket_for(sub.num_nodes, sub.num_edges, self.policy)
            if b not in seen:
                seen.append(b)
                obs.record_probe("pipeline.warmup_probe", str(b), step=s)
        return seen

    def _stream(self) -> Optional[torch.cuda.Stream]:
        """This thread's side stream on the card (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        stream = getattr(self._local, "stream", None)
        if stream is None:
            stream = self._local.stream = torch.cuda.Stream(self.device)
        return stream

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t
        # pinned, so the copy is asynchronous on the producer's stream (the
        # caching host allocator keeps the pinned block until it is done)
        return t.pin_memory().to(self.device, non_blocking=True)

    def produce(self, step: int) -> SampledBatch:
        """Make one batch. Pure in ``step``; safe from any thread (the
        cache is locked, each thread has its own stream and span stack)."""
        with span("pipeline.produce", step=int(step)) as root:
            t0 = time.perf_counter()
            with span("pipeline.sample", step=int(step)):
                sub = self.sampler.sample_batch(step)
            with span("pipeline.pad"):
                padded, bucket = pad_to_bucket(sub, self.policy)
            root.set(bucket=str(bucket))
            with span("pipeline.plan_cache", bucket=str(bucket)):
                entry = self.entry_for(bucket)
            v = bucket.num_nodes
            mask = (np.arange(v) < sub.num_seeds).astype(np.float32)
            stream = self._stream()
            event = None
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()):
                with span("pipeline.copy"):
                    arrays = {
                        "x": self._to_device(padded.x),
                        "edge_index": self._to_device(padded.edge_index),
                        "deg_inv_sqrt": self._to_device(padded.deg_inv_sqrt),
                        "labels": self._to_device(
                            padded.labels.astype(np.int64)),
                        "label_mask": self._to_device(mask),
                    }
                with span("pipeline.stamp"):
                    src, dst = arrays["edge_index"]
                    plan = dataclasses.replace(
                        entry.stamp(dst), src_order=source_order(
                            src, dst, v, v, num_real=sub.num_edges))
                if stream is not None:
                    event = torch.cuda.Event()
                    event.record(stream)
            return SampledBatch(
                step=int(step), graph=padded, bucket=bucket,
                num_seeds=sub.num_seeds, seed_nodes=sub.seed_nodes,
                plan=plan, arrays=arrays, entry=entry, event=event,
                produce_s=time.perf_counter() - t0)


class PrefetchPipeline:
    """Bounded-depth async prefetch over a ``step -> SampledBatch``
    producer.

    ``batch(step)`` returns the batch for ``step``, ready on the calling
    thread's stream, and keeps the window ``step+1 .. step+depth`` in
    flight on the pool. Sequential consumption (the training loop) finds
    its next batch already made. Out-of-window or backward jumps are made
    synchronously (determinism makes that slow, never wrong). ``depth=0``
    is the blocking loader, the baseline ``stats()['overlap']`` measures
    against.

    Always :meth:`close` (or use as a context manager) — the pool's
    threads are non-daemon."""

    def __init__(self, producer, depth: int = 2,
                 num_threads: Optional[int] = None):
        if depth < 0:
            raise ValueError("depth must be >= 0")
        self._produce = producer.produce if hasattr(producer, "produce") \
            else producer
        self.depth = int(depth)
        self.num_threads = max(1, int(num_threads if num_threads is not None
                                      else min(self.depth or 1, 4)))
        self._pool: Optional[ThreadPoolExecutor] = None
        if self.depth > 0:
            self._pool = ThreadPoolExecutor(
                max_workers=self.num_threads,
                thread_name_prefix="repro-torch-prefetch")
        self._pending: Dict[int, Future] = {}
        self._lock = threading.Lock()
        self._closed = False
        # accounting (consumer-thread writes), registry-backed under this
        # pipeline's instance label; vital so stats() works with
        # observability disabled
        reg = obs.get_registry()
        self._labels = {"pipeline": obs.next_id("pipeline")}
        self._m_batches = reg.counter("pipeline.batches", ("pipeline",),
                                      vital=True)
        self._m_sync_falls = reg.counter("pipeline.sync_falls",
                                         ("pipeline",), vital=True)
        self._m_wait = reg.histogram("pipeline.wait_s", ("pipeline",),
                                     vital=True)
        self._m_produce = reg.histogram("pipeline.produce_s", ("pipeline",),
                                        vital=True)
        for m in (self._m_batches, self._m_sync_falls, self._m_wait,
                  self._m_produce):
            m.touch(**self._labels)

    @property
    def batches(self) -> int:
        return int(self._m_batches.value(**self._labels))

    @property
    def sync_falls(self) -> int:
        return int(self._m_sync_falls.value(**self._labels))

    @property
    def wait_s(self) -> float:
        return self._m_wait.total(**self._labels)

    @property
    def produce_s(self) -> float:
        return self._m_produce.total(**self._labels)

    # -- scheduling ----------------------------------------------------------
    def _schedule(self, step: int) -> None:
        with self._lock:
            if self._closed or step in self._pending:
                return
            self._pending[step] = self._pool.submit(self._produce, step)

    def batch(self, step: int) -> SampledBatch:
        """The batch for ``step`` (bitwise the same at any depth), ready
        on the calling thread's current stream."""
        step = int(step)
        if self._closed:
            raise RuntimeError("pipeline is closed")
        t0 = time.perf_counter()
        if self._pool is None:
            b = self._produce(step)
        else:
            with self._lock:
                fut = self._pending.pop(step, None)
            if fut is None:
                # cold start or random access: make it here, synchronously
                self._m_sync_falls.inc(**self._labels)
                b = self._produce(step)
            else:
                b = fut.result()
            for ahead in range(step + 1, step + 1 + self.depth):
                self._schedule(ahead)
        b.wait_s = time.perf_counter() - t0
        b.ready()
        self._m_batches.inc(**self._labels)
        self._m_wait.observe(b.wait_s, **self._labels)
        self._m_produce.observe(b.produce_s, **self._labels)
        return b

    # -- accounting ----------------------------------------------------------
    def stats(self) -> Dict:
        """Overlap accounting. ``overlap`` = fraction of host production
        hidden from the consumer (0 for the blocking loader by
        construction). ``*_steady`` medians drop the first batch, which
        pays cold caches and kernel loads."""
        wait_hist = self._m_wait.samples(**self._labels)
        produce_hist = self._m_produce.samples(**self._labels)
        wait = np.asarray(wait_hist[1:] or wait_hist or [0.0])
        prod = np.asarray(produce_hist[1:] or produce_hist or [0.0])
        return {
            "depth": self.depth,
            "num_threads": self.num_threads,
            "batches": self.batches,
            "sync_falls": self.sync_falls,
            "wait_s": self.wait_s,
            "produce_s": self.produce_s,
            "overlap": (1.0 - self.wait_s / self.produce_s
                        if self.produce_s > 0 else 0.0),
            "wait_s_median_steady": float(np.median(wait)),
            "produce_s_median_steady": float(np.median(prod)),
        }

    def close(self) -> None:
        """Shut the pool down; idempotent. Batches in flight are finished
        first (cancelled where they have not started)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            pending = list(self._pending.values())
            self._pending.clear()
        for fut in pending:
            fut.cancel()
        if self._pool is not None:
            self._pool.shutdown(wait=True)

    def __enter__(self) -> "PrefetchPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # backstop; close() is the contract
        try:
            self.close()
        except Exception:
            pass

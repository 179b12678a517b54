"""LRU cache of per-bucket plan templates.

A :class:`BucketEntry` canonicalizes everything static per bucket:

  * one :class:`~repro_torch.core.config_space.KernelConfig`, resolved once
    per bucket by the engine — a measured PerfDB winner when one exists for
    the bucket's shape class (:func:`measured_config`, a pure lookup), a
    sweep with ``tune=True``, else the generated rules;
  * canonical per-bucket :class:`~repro_torch.core.plan.SegmentStats`
    (skew 1), so every decision made from the template (the transform
    order included) is a function of the bucket, not of the request.

Per request only the plan's row offsets change: :meth:`BucketEntry.stamp`
recomputes them (``searchsorted`` over the padded destinations) under the
template — no plan or config work on a cache hit. There is no compiled
program to keep: PyTorch runs eagerly, so an entry is "built" once per
bucket and then reused.

The cache is a capacity-bounded, thread-safe LRU (the prefetch pipeline's
producer threads share it with the consumer); ``warm`` prefills entries
ahead of traffic without counting a miss. Its counters live in the
:mod:`repro_torch.obs` registry, and each miss and eviction records an
attribution event.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Dict, Hashable, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.config_space import KernelConfig
from repro_torch.core.plan import SegmentPlan, SegmentStats
from repro_torch.kernels.gather_segment_reduce import row_offsets
from repro_torch.serve.buckets import ShapeBucket

__all__ = ["CacheStats", "BucketEntry", "PlanCache", "measured_config",
           "bucket_config"]


def measured_config(bucket: ShapeBucket, feat: int,
                    op: str = "gather_segment_reduce",
                    db=None) -> Optional[KernelConfig]:
    """The PerfDB's measured winner of ``op`` for the bucket's shape class
    on this card, or None. A lookup only: serving never pays a sweep
    inline (populate the DB with ``tune=True``)."""
    from repro_torch.core import autotune
    return autotune.lookup(op, idx_size=max(bucket.num_edges, 1),
                           num_segments=max(bucket.num_nodes, 1), feat=feat,
                           db=db)


def bucket_config(bucket: ShapeBucket, feat: int, *, tune: bool = False,
                  db=None) -> KernelConfig:
    """The bucket's canonical config, per axis: the PerfDB's measured
    winner for the bucket's shape class (the gather's for M_b, the fused
    kernel's for S_b) > with ``tune=True``, a sweep on the card, stored
    under the same shape class and ``db`` > the generated rules."""
    from repro_torch.core import autotune
    from repro_torch.core.heuristics import fusable_width, select_config
    e, v = max(bucket.num_edges, 1), max(bucket.num_nodes, 1)
    rules = select_config(e, max(min(bucket.num_edges, bucket.num_nodes), 1),
                          feat, tune=False)

    def measured(op: str) -> Optional[KernelConfig]:
        cfg = measured_config(bucket, feat, op, db)
        if cfg is None and tune:
            cfg = autotune.tune(op=op, idx_size=e, num_segments=v,
                                feat=feat, db=db).config
        return cfg

    m_b = (measured("gather_segment_reduce") or rules).m_b
    s_b = rules.s_b
    if fusable_width(feat):
        s_b = (measured("fused_transform_reduce") or rules).s_b
    return KernelConfig("SR", s_b, rules.n_b, m_b, 1)


def _canonical_stats(bucket: ShapeBucket) -> SegmentStats:
    """Deterministic per-bucket stats (skew 1)."""
    e, v = bucket.num_edges, bucket.num_nodes
    live = max(min(e, v), 1)
    avg = e / live
    return SegmentStats(num_rows=e, num_segments=v, live_segments=live,
                        max_degree=max(int(np.ceil(avg)), 1),
                        avg_degree=avg, std_degree=0.0)


class BucketEntry:
    """One cache line: the bucket's canonical plan template. ``executed``
    turns true at the entry's first run (the engine counts that run as
    the bucket's build)."""

    def __init__(self, bucket: ShapeBucket, feat: int, config: KernelConfig):
        self.bucket = bucket
        self.executed = False
        self.feat = int(feat)
        self.config = config
        # all-pad index: the template's row offsets describe "no real
        # edges"; stamp() replaces them with a request's
        self.template = SegmentPlan(
            row_ptr=torch.zeros(bucket.num_nodes + 1, dtype=torch.int64),
            num_rows=bucket.num_edges, num_segments=bucket.num_nodes,
            config=config, stats=_canonical_stats(bucket))

    def stamp(self, dst) -> SegmentPlan:
        """A servable plan for one padded graph: the request's row offsets
        under the bucket's static fields. They are computed where ``dst``
        lies (a numpy array gives CPU tensors), so a server stamps on the
        card from the destinations it has already copied there."""
        dst = torch.as_tensor(dst)
        if dst.numel() != self.bucket.num_edges:
            raise ValueError(
                f"stamp expects {self.bucket.num_edges} padded edges "
                f"(bucket {self.bucket}), got {dst.numel()}")
        return dataclasses.replace(
            self.template, row_ptr=row_offsets(dst, self.bucket.num_nodes))


class CacheStats:
    """Hit/miss/eviction and build-time accounting of one cache — a view
    over labeled instruments in the :mod:`repro_torch.obs` registry. Each
    stats object carries a process-unique ``cache`` label, so every
    PlanCache's counters export side by side in one dump; the instruments
    are vital (they count with observability disabled). Attribute reads
    and writes (``stats.hits += 1``) go straight through to the registry
    series."""

    _INT_FIELDS = ("hits", "misses", "evictions", "prefills", "plan_builds")
    _FLOAT_FIELDS = ("plan_build_s",)

    def __init__(self, cache_id: Optional[str] = None):
        reg = obs.get_registry()
        self.cache_id = cache_id or obs.next_id("cache")
        self._labels = {"cache": self.cache_id}
        self._metrics = {
            f: reg.counter(f"serve.plan_cache.{f}", labels=("cache",),
                           vital=True)
            for f in self._INT_FIELDS + self._FLOAT_FIELDS}
        for m in self._metrics.values():
            m.touch(**self._labels)

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def as_dict(self) -> Dict:
        d = {f: getattr(self, f)
             for f in self._INT_FIELDS + self._FLOAT_FIELDS}
        d["hit_rate"] = round(self.hit_rate, 4)
        return d


def _stats_field(field: str, as_int: bool):
    def fget(self):
        v = self._metrics[field].value(**self._labels)
        return int(v) if as_int else v

    def fset(self, v):
        self._metrics[field].set(float(v), **self._labels)

    return property(fget, fset)


for _f in CacheStats._INT_FIELDS:
    setattr(CacheStats, _f, _stats_field(_f, as_int=True))
for _f in CacheStats._FLOAT_FIELDS:
    setattr(CacheStats, _f, _stats_field(_f, as_int=False))
del _f


class PlanCache:
    """Capacity-bounded LRU over :class:`BucketEntry` cache lines.

    ``weight=`` attributes a lookup to the number of requests it served (a
    batch of k graphs sharing one bucket counts k hits). Thread-safe: every
    read-modify-write, and the build inside :meth:`get_or_build`, happens
    under one re-entrant lock, so racing misses on one key build once."""

    def __init__(self, capacity: int = 32):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self.stats = CacheStats()
        self._lock = threading.RLock()
        self._entries: "collections.OrderedDict[Hashable, BucketEntry]" = \
            collections.OrderedDict()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def keys(self):
        with self._lock:
            return list(self._entries)

    def entries(self) -> list:
        """(key, entry) of every cache line, least recently used first;
        counts no hit or miss."""
        with self._lock:
            return list(self._entries.items())

    def lookup(self, key: Hashable, weight: int = 1) -> Optional[BucketEntry]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.stats.misses += weight
                obs.record_cache_event(self.stats.cache_id, "miss",
                                       key=str(key), weight=weight)
                return None
            self._entries.move_to_end(key)
            self.stats.hits += weight
            return entry

    def insert(self, key: Hashable, entry: BucketEntry) -> None:
        with self._lock:
            self._entries[key] = entry
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                old_key, _ = self._entries.popitem(last=False)
                self.stats.evictions += 1
                obs.record_cache_event(self.stats.cache_id, "eviction",
                                       key=str(old_key),
                                       capacity=self.capacity)

    def _build(self, key, builder) -> BucketEntry:
        t0 = time.perf_counter()
        entry = builder()
        self.stats.plan_builds += 1
        self.stats.plan_build_s += time.perf_counter() - t0
        self.insert(key, entry)
        return entry

    def get_or_build(self, key: Hashable,
                     builder: Callable[[], BucketEntry],
                     weight: int = 1) -> BucketEntry:
        """One serving lookup: LRU hit, or build + insert on a miss."""
        with self._lock:
            entry = self.lookup(key, weight=weight)
            return entry if entry is not None else self._build(key, builder)

    def warm(self, key: Hashable,
             builder: Callable[[], BucketEntry]) -> BucketEntry:
        """Prefill ahead of traffic: counted as a prefill, not a miss."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                return entry
            self.stats.prefills += 1
            return self._build(key, builder)

"""LRU cache of per-bucket plan templates.

A :class:`BucketEntry` canonicalizes everything static per bucket:

  * one :class:`~repro_torch.core.config_space.KernelConfig` (the Hopper
    default for the served width; measured selection is not ported yet);
  * ``max_chunks`` pinned to the bucket-static worst case;
  * canonical per-bucket :class:`~repro_torch.core.plan.SegmentStats`
    (skew 1), so every decision made from the template is a function of the
    bucket, not of the request.

Per request only the plan's chunk metadata and row offsets change:
:meth:`BucketEntry.stamp` recomputes them (``searchsorted`` over the
padded destinations) under the template — no plan or config work on a
cache hit. There is no compiled program to keep: PyTorch runs eagerly,
so an entry is "built" once per bucket and then reused.

The cache is a capacity-bounded, thread-safe LRU; ``warm`` prefills
entries ahead of traffic without counting a miss.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Dict, Hashable, Optional

import numpy as np
import torch

from repro_torch.core.config_space import KernelConfig
from repro_torch.core.plan import SegmentPlan, SegmentStats
from repro_torch.kernels.gather_segment_reduce import row_offsets
from repro_torch.kernels.segment_reduce import chunk_metadata
from repro_torch.serve.buckets import ShapeBucket

__all__ = ["CacheStats", "BucketEntry", "PlanCache", "bucket_max_chunks"]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def bucket_max_chunks(bucket: ShapeBucket, config: KernelConfig) -> int:
    """Bucket-static chunk bound: every row block (``ceil(E_bucket / m_b)``)
    covers any graph in the bucket."""
    m_pad = _round_up(max(bucket.num_edges, 1), config.m_b)
    return max(m_pad // config.m_b, 1)


def _canonical_stats(bucket: ShapeBucket) -> SegmentStats:
    """Deterministic per-bucket stats (skew 1)."""
    e, v = bucket.num_edges, bucket.num_nodes
    live = max(min(e, v), 1)
    avg = e / live
    return SegmentStats(num_rows=e, num_segments=v, live_segments=live,
                        max_degree=max(int(np.ceil(avg)), 1),
                        avg_degree=avg, std_degree=0.0)


class BucketEntry:
    """One cache line: the bucket's canonical plan template."""

    def __init__(self, bucket: ShapeBucket, feat: int, config: KernelConfig):
        self.bucket = bucket
        self.feat = int(feat)
        self.config = config
        self.max_chunks = bucket_max_chunks(bucket, config)
        self.m_pad = _round_up(max(bucket.num_edges, 1), config.m_b)
        # all-pad index: the template's metadata describes "no real edges";
        # stamp() replaces it with a request's actual chunk metadata
        self.template = self._stamp_plan(
            torch.full((0,), bucket.num_nodes, dtype=torch.int32),
            template=None)

    def _stamp_plan(self, dst: torch.Tensor, template) -> SegmentPlan:
        v, cfg = self.bucket.num_nodes, self.config
        idxp = torch.full((self.m_pad,), v, dtype=torch.int32,
                          device=dst.device)
        idxp[:dst.numel()] = dst
        cf, cc = chunk_metadata(idxp, v, cfg.s_b, cfg.m_b, self.m_pad)
        rp = row_offsets(idxp, v)
        if template is not None:
            return dataclasses.replace(template, chunk_first=cf,
                                       chunk_count=cc, row_ptr=rp)
        return SegmentPlan(chunk_first=cf, chunk_count=cc, row_ptr=rp,
                           num_rows=self.bucket.num_edges, num_segments=v,
                           max_chunks=self.max_chunks, config=cfg,
                           stats=_canonical_stats(self.bucket))

    def stamp(self, dst) -> SegmentPlan:
        """A servable plan for one padded graph: the request's chunk
        metadata and row offsets under the bucket's static fields. It is computed where
        ``dst`` lies (a numpy array gives CPU tensors), so a server stamps
        on the card from the destinations it has already copied there."""
        dst = torch.as_tensor(dst)
        if dst.numel() != self.bucket.num_edges:
            raise ValueError(
                f"stamp expects {self.bucket.num_edges} padded edges "
                f"(bucket {self.bucket}), got {dst.numel()}")
        return self._stamp_plan(dst, self.template)


@dataclasses.dataclass
class CacheStats:
    """Hit/miss/eviction and build-time accounting of one cache."""
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    prefills: int = 0
    plan_builds: int = 0
    plan_build_s: float = 0.0

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def as_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["hit_rate"] = round(self.hit_rate, 4)
        return d


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

    def lookup(self, key: Hashable, weight: int = 1) -> Optional[BucketEntry]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.stats.misses += weight
                return None
            self._entries.move_to_end(key)
            self.stats.hits += weight
            return entry

    def insert(self, key: Hashable, entry: BucketEntry) -> None:
        with self._lock:
            self._entries[key] = entry
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.stats.evictions += 1

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

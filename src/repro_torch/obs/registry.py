"""Thread-safe metrics registry: the one store every counter of
:mod:`repro_torch` lands in, as the reference's (``repro/obs/registry.py``).

Three instrument kinds, all labeled:

  * :class:`Counter` — monotonically increasing float (``inc``); the
    load-bearing accounting (cache hits, bucket builds, launches).
  * :class:`Gauge`   — last-written value (``set`` / ``add``); queue
    depths and other point-in-time levels.
  * :class:`Histogram` — fixed-bucket latency/size distribution **plus**
    a bounded window of raw samples, so ``p50/p95/p99`` are exact over
    the retained window (the buckets only feed the Prometheus export;
    quantiles never interpolate bucket edges).

Instruments are registered once per name (idempotent — asking again with
the same kind/labels returns the same :class:`Metric`) and live for the
process; ``reset()`` zeroes series without unregistering, so long-lived
holders (a serving engine, a plan cache) keep valid handles across
measurement windows.

Enable/disable semantics: the module-level switch
(``repro_torch.obs.disable``) turns *non-vital* instruments into no-ops —
spans, kernel-launch mirrors, attribution — bounding observability
overhead. Instruments created with ``vital=True`` always record: they
back public counter APIs (``CacheStats``, ``GNNServer.stats``,
``PrefetchPipeline.stats``, ``Trainer.buckets``) whose correctness does
not depend on telemetry being switched on.

Snapshot / delta: ``snapshot()`` returns a list of plain-dict series
(JSON-ready); ``delta(prev)`` subtracts a previous snapshot from the
current one (counters and histogram count/sum), which is how a caller
measures one window of a shared process-global registry.
"""
from __future__ import annotations

import collections
import itertools
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Metric", "MetricsRegistry",
           "get_registry", "next_id", "DEFAULT_LATENCY_BUCKETS_S"]

# observability switch — flipped by repro_torch.obs.enable()/disable(); read
# here so the per-call guard is one module-global load
_ENABLED = True


def _set_enabled(flag: bool) -> None:
    global _ENABLED
    _ENABLED = bool(flag)


def _is_enabled() -> bool:
    return _ENABLED


# a ladder from 10µs to ~100s — wide enough for kernel launches on the
# card and plain versions on the CPU alike
DEFAULT_LATENCY_BUCKETS_S = (1e-5, 1e-4, 1e-3, 1e-2, 0.1, 0.5, 1.0, 5.0,
                             30.0, 120.0)

_DEFAULT_WINDOW = 4096          # raw samples retained per histogram series


class _HistSeries:
    """One labeled histogram series: bucket counts + raw-sample window."""

    __slots__ = ("buckets", "counts", "sum", "count", "samples")

    def __init__(self, buckets: Tuple[float, ...], window: int):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)      # +inf overflow bucket
        self.sum = 0.0
        self.count = 0
        self.samples: collections.deque = collections.deque(maxlen=window)

    def observe(self, v: float) -> None:
        i = 0
        for i, edge in enumerate(self.buckets):
            if v <= edge:
                break
        else:
            i = len(self.buckets)
        self.counts[i] += 1
        self.sum += v
        self.count += 1
        self.samples.append(v)

    def percentile(self, q: float) -> float:
        """Exact q-th percentile (0..100) over the retained window."""
        if not self.samples:
            return 0.0
        s = sorted(self.samples)
        # nearest-rank on the retained window: exact, no interpolation
        rank = max(int(len(s) * q / 100.0 + 0.5), 1)
        return s[min(rank, len(s)) - 1]

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class Metric:
    """One named instrument; holds every labeled series under it."""

    def __init__(self, registry: "MetricsRegistry", name: str, kind: str,
                 labelnames: Tuple[str, ...], help: str, *,
                 buckets: Optional[Tuple[float, ...]] = None,
                 window: int = _DEFAULT_WINDOW, vital: bool = False):
        self.registry = registry
        self.name = name
        self.kind = kind                  # counter | gauge | histogram
        self.labelnames = tuple(labelnames)
        self.help = help
        self.vital = bool(vital)
        self.buckets = tuple(buckets) if buckets else \
            (DEFAULT_LATENCY_BUCKETS_S if kind == "histogram" else None)
        self.window = int(window)
        self._series: Dict[Tuple, object] = {}

    # -- series addressing ---------------------------------------------------
    def _key(self, labels: Dict[str, str]) -> Tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[n]) for n in self.labelnames)

    def _num(self, key: Tuple) -> List[float]:
        cell = self._series.get(key)
        if cell is None:
            cell = self._series[key] = [0.0]
        return cell

    def _hist(self, key: Tuple) -> _HistSeries:
        cell = self._series.get(key)
        if cell is None:
            cell = self._series[key] = _HistSeries(self.buckets, self.window)
        return cell

    def _on(self) -> bool:
        return self.vital or _ENABLED

    # -- counter / gauge -----------------------------------------------------
    def inc(self, n: float = 1.0, **labels) -> None:
        if not self._on():
            return
        key = self._key(labels)
        with self.registry._lock:
            self._num(key)[0] += n

    def set(self, v: float, **labels) -> None:
        if not self._on():
            return
        key = self._key(labels)
        with self.registry._lock:
            self._num(key)[0] = float(v)

    add = inc                             # gauge alias

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self.registry._lock:
            cell = self._series.get(key)
            return float(cell[0]) if cell is not None else 0.0

    def touch(self, **labels) -> None:
        """Materialize a labeled series at its zero value, so it exports
        before (or without) a first event — a zero counter is data."""
        if not self._on():
            return
        key = self._key(labels)
        with self.registry._lock:
            if self.kind == "histogram":
                self._hist(key)
            else:
                self._num(key)

    # -- histogram -----------------------------------------------------------
    def observe(self, v: float, **labels) -> None:
        if not self._on():
            return
        key = self._key(labels)
        with self.registry._lock:
            self._hist(key).observe(float(v))

    def series(self, **labels) -> Optional[_HistSeries]:
        key = self._key(labels)
        with self.registry._lock:
            return self._series.get(key)

    def count(self, **labels) -> int:
        s = self.series(**labels)
        return s.count if s is not None else 0

    def total(self, **labels) -> float:
        s = self.series(**labels)
        return s.sum if s is not None else 0.0

    def mean(self, **labels) -> float:
        s = self.series(**labels)
        return s.mean if s is not None else 0.0

    def percentile(self, q: float, **labels) -> float:
        s = self.series(**labels)
        return s.percentile(q) if s is not None else 0.0

    def samples(self, **labels) -> list:
        key = self._key(labels)
        with self.registry._lock:
            cell = self._series.get(key)
            return list(cell.samples) if cell is not None else []

    # -- lifecycle -----------------------------------------------------------
    def reset(self, **labels) -> None:
        """Zero one series (with labels) or every series (without)."""
        with self.registry._lock:
            if labels:
                self._series.pop(self._key(labels), None)
            else:
                self._series.clear()

    def series_items(self):
        """[(labels_dict, series_cell)] — snapshot helper."""
        with self.registry._lock:
            return [(dict(zip(self.labelnames, key)), cell)
                    for key, cell in self._series.items()]


class Counter(Metric):
    pass


class Gauge(Metric):
    pass


class Histogram(Metric):
    pass


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """The process-global instrument store (one per process by default —
    :func:`get_registry`). All mutation happens under one RLock; the
    per-event cost is a dict lookup + a float add."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: "collections.OrderedDict[str, Metric]" = \
            collections.OrderedDict()
        self._ids = itertools.count()

    # -- registration --------------------------------------------------------
    def _register(self, name: str, kind: str, labels: Sequence[str],
                  help: str, *, buckets=None, vital=False,
                  window=_DEFAULT_WINDOW) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != kind or m.labelnames != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}"
                        f"{m.labelnames}; asked for {kind}{tuple(labels)}")
                m.vital = m.vital or vital
                return m
            m = _KINDS[kind](self, name, kind, tuple(labels), help,
                             buckets=buckets, vital=vital, window=window)
            self._metrics[name] = m
            return m

    def counter(self, name: str, labels: Sequence[str] = (), help: str = "",
                *, vital: bool = False) -> Counter:
        return self._register(name, "counter", labels, help, vital=vital)

    def gauge(self, name: str, labels: Sequence[str] = (), help: str = "",
              *, vital: bool = False) -> Gauge:
        return self._register(name, "gauge", labels, help, vital=vital)

    def histogram(self, name: str, labels: Sequence[str] = (),
                  help: str = "", *, buckets=None, vital: bool = False,
                  window: int = _DEFAULT_WINDOW) -> Histogram:
        return self._register(name, "histogram", labels, help,
                              buckets=buckets, vital=vital, window=window)

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return list(self._metrics)

    def schema(self) -> Dict[str, Tuple[str, ...]]:
        """name -> labelnames for every registered metric (the shape the
        schema-stability test pins)."""
        with self._lock:
            return {n: m.labelnames for n, m in self._metrics.items()}

    def next_id(self, prefix: str) -> str:
        """Process-unique instance label ('engine0', 'cache3', ...)."""
        with self._lock:
            return f"{prefix}{next(self._ids)}"

    # -- snapshot / delta ----------------------------------------------------
    def snapshot(self) -> List[dict]:
        """Every series as a plain JSON-ready dict."""
        out = []
        with self._lock:
            for name, m in self._metrics.items():
                for labels, cell in m.series_items():
                    row = {"name": name, "type": m.kind, "labels": labels}
                    if m.kind == "histogram":
                        row.update(
                            count=cell.count, sum=cell.sum,
                            mean=cell.mean,
                            p50=cell.percentile(50),
                            p95=cell.percentile(95),
                            p99=cell.percentile(99),
                            buckets=[[edge, c] for edge, c in
                                     zip(list(m.buckets) + ["+Inf"],
                                         cell.counts)])
                    else:
                        row["value"] = cell[0]
                    out.append(row)
        return out

    def delta(self, prev: List[dict]) -> List[dict]:
        """Current snapshot minus ``prev`` (counters and histogram
        count/sum; gauges report their current value). Series absent from
        ``prev`` are reported whole."""
        base = {(r["name"], tuple(sorted(r["labels"].items()))): r
                for r in prev}
        out = []
        for row in self.snapshot():
            key = (row["name"], tuple(sorted(row["labels"].items())))
            old = base.get(key)
            row = dict(row)
            if old is not None:
                if row["type"] == "counter":
                    row["value"] = row["value"] - old.get("value", 0.0)
                elif row["type"] == "histogram":
                    row["count"] = row["count"] - old.get("count", 0)
                    row["sum"] = row["sum"] - old.get("sum", 0.0)
                    row.pop("buckets", None)  # deltas of buckets: unused
            out.append(row)
        return out

    def reset(self) -> None:
        """Zero every series; instruments stay registered (long-lived
        holders keep valid handles)."""
        with self._lock:
            for m in self._metrics.values():
                m._series.clear()


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def next_id(prefix: str) -> str:
    return _REGISTRY.next_id(prefix)

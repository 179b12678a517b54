"""Metric export: JSON-lines and Prometheus text, plus the periodic
flusher behind ``REPRO_METRICS_PATH``, as the reference's
(``repro/obs/export.py``), in the same formats.

JSON-lines (the machine-readable artifact CI parses): one JSON object
per line — ``{"record": "metric", ...}`` series rows straight from
:meth:`MetricsRegistry.snapshot`, ``{"record": "event", ...}``
attribution events, and one trailing ``{"record": "meta", ...}`` stamp.

Prometheus text format (scrape endpoint / pushgateway food): metric
names sanitized (``serve.plan_cache.hits`` → ``repro_serve_plan_cache_
hits``), HELP/TYPE headers, histogram series expanded to ``_bucket``
(cumulative, ``le``-labeled) + ``_sum`` + ``_count`` per convention.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional

from repro_torch.obs import hooks as _hooks
from repro_torch.obs import registry as _registry

__all__ = ["to_jsonl", "write_jsonl", "to_prometheus", "write_prometheus",
           "start_flusher", "stop_flusher"]


def _snapshot(registry=None) -> List[dict]:
    reg = registry if registry is not None else _registry.get_registry()
    return reg.snapshot()


def to_jsonl(registry=None, events: bool = True) -> str:
    lines = []
    for row in _snapshot(registry):
        lines.append(json.dumps({"record": "metric", **row}))
    if events:
        for e in _hooks.attributions():
            lines.append(json.dumps({"record": "event", **e},
                                    default=str))
    lines.append(json.dumps({"record": "meta", "t_s": time.time(),
                             "pid": os.getpid()}))
    return "\n".join(lines) + "\n"


def write_jsonl(path: str, registry=None, events: bool = True) -> str:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(to_jsonl(registry, events=events))
    os.replace(tmp, path)         # atomic: readers never see a torn file
    return path


def _sanitize(name: str) -> str:
    out = "".join(c if c.isalnum() else "_" for c in name)
    return f"repro_{out}"


def to_prometheus(registry=None) -> str:
    reg = registry if registry is not None else _registry.get_registry()
    lines = []
    with reg._lock:
        metrics = list(reg._metrics.items())
    for name, m in metrics:
        pname = _sanitize(name)
        if m.help:
            lines.append(f"# HELP {pname} {m.help}")
        lines.append(f"# TYPE {pname} {m.kind}")
        for labels, cell in m.series_items():
            lab = ",".join(f'{k}="{v}"' for k, v in labels.items())
            if m.kind == "histogram":
                cum = 0
                for edge, c in zip(list(m.buckets) + ["+Inf"], cell.counts):
                    cum += c
                    le = f'le="{edge}"'
                    full = ",".join(x for x in (lab, le) if x)
                    lines.append(f"{pname}_bucket{{{full}}} {cum}")
                tail = f"{{{lab}}}" if lab else ""
                lines.append(f"{pname}_sum{tail} {cell.sum}")
                lines.append(f"{pname}_count{tail} {cell.count}")
            else:
                tail = f"{{{lab}}}" if lab else ""
                lines.append(f"{pname}{tail} {cell[0]}")
    return "\n".join(lines) + "\n"


def write_prometheus(path: str, registry=None) -> str:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(to_prometheus(registry))
    os.replace(tmp, path)
    return path


# ---------------------------------------------------------------------------
# periodic flusher (REPRO_METRICS_PATH)
# ---------------------------------------------------------------------------

_FLUSHER: Optional["_Flusher"] = None
_FLUSHER_LOCK = threading.Lock()


class _Flusher:
    """Daemon thread writing the JSON-lines dump every ``every_s``; a
    final write happens at :func:`stop_flusher` (repro_torch.obs registers one
    at process exit)."""

    def __init__(self, path: str, every_s: float):
        self.path = path
        self.every_s = float(every_s)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="repro-torch-obs-flush")
        self._thread.start()

    def _run(self):
        while not self._stop.wait(self.every_s):
            try:
                write_jsonl(self.path)
            except OSError:
                pass              # a transient fs error must not kill obs

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5.0)
        try:
            write_jsonl(self.path)
        except OSError:
            pass


def start_flusher(path: str, every_s: float = 30.0) -> None:
    """Idempotent: one flusher per process; re-calling re-points it."""
    global _FLUSHER
    with _FLUSHER_LOCK:
        if _FLUSHER is not None:
            _FLUSHER.stop()
        _FLUSHER = _Flusher(path, every_s)


def stop_flusher() -> None:
    global _FLUSHER
    with _FLUSHER_LOCK:
        if _FLUSHER is not None:
            _FLUSHER.stop()
            _FLUSHER = None

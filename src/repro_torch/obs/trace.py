"""Tracing spans: per-request / per-step span trees with a ring-buffer
trace log and Chrome ``trace_event`` export, as the reference's
(``repro/obs/trace.py``).

``span("serve.step", bucket=str(b))`` opens a timed stage; nested
``span(...)`` calls in the same thread/context attach as children, so one
served request or training step yields one tree covering its stages
(batch → pad → plan_cache → copy → stamp → execute → fetch for a served
step; sample → prepare → execute for a training step; sample → pad →
plan_cache → stamp → copy for a produced mini-batch). Completed **root**
spans land in a bounded ring buffer (old traces fall off; memory is
bounded by construction). A span times the host: the device work a stage
enqueues may finish after the span closes.

Context propagation uses :mod:`contextvars`: threads have independent
span stacks, so a prefetch producer's ``pipeline.produce`` tree never
interleaves with the consumer's ``train.step`` tree — each thread's
roots enter the ring independently.

Export: :func:`chrome_trace` renders the ring as Chrome
``trace_event`` JSON ("X" complete events, µs timestamps relative to
process start) loadable in ``chrome://tracing`` / Perfetto;
:func:`write_chrome_trace` writes it to disk (also wired to
``REPRO_TRACE_PATH`` at process exit by :mod:`repro_torch.obs`).

Disabled mode (``repro_torch.obs.disable()``): ``span`` yields a shared
no-op span and records nothing — the per-call cost is one flag check.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import json
import os
import threading
import time
from typing import Dict, List, Optional

from repro_torch.obs import registry as _registry

__all__ = ["Span", "span", "current_span", "spans", "reset_spans",
           "chrome_trace", "write_chrome_trace"]

_T0 = time.perf_counter()         # process-relative timestamp origin

_RING_CAP = int(os.environ.get("REPRO_TRACE_RING", "512"))
_RING: collections.deque = collections.deque(maxlen=_RING_CAP)
_RING_LOCK = threading.Lock()

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_obs_span", default=None)


class Span:
    """One timed stage. ``attrs`` carry structured context (bucket, step,
    cause, ...); ``children`` make the tree."""

    __slots__ = ("name", "attrs", "t0", "dur_s", "children", "tid",
                 "thread")

    def __init__(self, name: str, attrs: Dict):
        self.name = name
        self.attrs = attrs
        self.t0 = time.perf_counter() - _T0
        self.dur_s = 0.0
        self.children: List["Span"] = []
        self.tid = threading.get_ident()
        self.thread = threading.current_thread().name

    def set(self, **attrs) -> None:
        """Attach attributes mid-span (e.g. the bucket once known)."""
        self.attrs.update(attrs)

    # -- tree queries --------------------------------------------------------
    def find(self, name: str) -> Optional["Span"]:
        """First span named ``name`` in this subtree (depth-first)."""
        if self.name == name:
            return self
        for c in self.children:
            hit = c.find(name)
            if hit is not None:
                return hit
        return None

    def stages(self) -> set:
        """Every span name in this subtree."""
        out = {self.name}
        for c in self.children:
            out |= c.stages()
        return out

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()

    def as_dict(self) -> dict:
        return {"name": self.name, "t0_s": self.t0, "dur_s": self.dur_s,
                "attrs": dict(self.attrs), "thread": self.thread,
                "children": [c.as_dict() for c in self.children]}

    def __repr__(self):
        return (f"Span({self.name!r}, {self.dur_s * 1e3:.2f}ms, "
                f"{len(self.children)} children)")


class _NullSpan:
    """Shared no-op span for disabled mode."""

    name = None
    attrs: Dict = {}
    children: List = []

    def set(self, **attrs) -> None:
        pass

    def find(self, name):
        return None

    def stages(self):
        return set()


_NULL = _NullSpan()


@contextlib.contextmanager
def span(name: str, **attrs):
    """Open one timed stage; yields the live :class:`Span` (a shared
    no-op when observability is disabled)."""
    if not _registry._is_enabled():
        yield _NULL
        return
    s = Span(name, attrs)
    parent = _CURRENT.get()
    token = _CURRENT.set(s)
    try:
        yield s
    finally:
        s.dur_s = (time.perf_counter() - _T0) - s.t0
        _CURRENT.reset(token)
        if parent is not None:
            parent.children.append(s)
        else:
            with _RING_LOCK:
                _RING.append(s)


def current_span() -> Optional[Span]:
    return _CURRENT.get()


def spans(name: Optional[str] = None) -> List[Span]:
    """Completed root spans in the ring (oldest first); ``name`` filters
    by root-span name."""
    with _RING_LOCK:
        roots = list(_RING)
    if name is not None:
        roots = [r for r in roots if r.name == name]
    return roots


def reset_spans() -> None:
    with _RING_LOCK:
        _RING.clear()


# ---------------------------------------------------------------------------
# Chrome trace_event export
# ---------------------------------------------------------------------------

def chrome_trace(roots: Optional[List[Span]] = None) -> dict:
    """The ring (or ``roots``) as a Chrome ``trace_event`` document:
    one "X" (complete) event per span, µs timestamps relative to process
    start, thread ids preserved so producer/consumer lanes separate."""
    if roots is None:
        roots = spans()
    events = []
    for root in roots:
        for s in root.walk():
            args = {k: (v if isinstance(v, (int, float, bool, str))
                        or v is None else str(v))
                    for k, v in s.attrs.items()}
            events.append({
                "name": s.name, "ph": "X", "cat": "repro_torch",
                "ts": s.t0 * 1e6, "dur": s.dur_s * 1e6,
                "pid": os.getpid(), "tid": s.tid, "args": args,
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str,
                       roots: Optional[List[Span]] = None) -> str:
    doc = chrome_trace(roots)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path

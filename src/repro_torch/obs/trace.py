"""Tracing spans: per-request / per-step span trees with a ring-buffer
trace log and Chrome ``trace_event`` export, as the reference's
(``repro/obs/trace.py``).

``with span("serve.step", bucket=str(b)):`` opens a timed stage; nested
``span(...)`` calls in the same thread attach as children, so one served
request, training step or plan build yields one tree covering its stages.
Completed **root** spans land in a bounded ring buffer (old traces fall
off; memory is bounded by construction). A span times the host: the
device work a stage enqueues may finish after the span closes.

Each thread keeps its own stack of open spans (a ``threading.local``), so
a prefetch producer's ``pipeline.produce`` tree never interleaves with the
consumer's ``train.step`` tree — each thread's roots enter the ring
independently. A span records its thread's id; the thread's name is looked
up when the span is exported (:meth:`Span.as_dict`).

**The profiler's clock.** While a ``torch.profiler`` session records
(``torch.autograd._profiler_enabled()``), a span also holds a
``torch.profiler.record_function`` range of its own name open for its
whole life. The span then lands in the profiler's Chrome trace as a
``user_annotation`` event, on the clock of the kernels and tied to their
launches by thread and time, with the same nesting. torch is reached
through ``sys.modules``: this module imports nothing but the standard
library, and without a profiler no range is entered.

The port's spans (no name begins with ``bench.``, which a benchmark keeps
for its own ranges, or ``repro_torch::``, the custom ops' prefix):

    span                    opened in                     read by
    ----------------------  ----------------------------  -----------------
    gnn.forward             models/gnn.py GNN.forward     -
    gnn.layer               one a layer, under it         -
    mp.order                core/mp.py mp_transform       -
    mp.aggregate            core/mp.py mp, mp_transform,  mp_ms.gnn_infer
                            mp_typed: the segment-op
                            launches, no dense matmul
    gat.attention           models/gnn.py GATLayer: the   attn_ms.gnn_infer
                            scores, their per-edge rows
                            and segment_softmax, not the
                            transform or the weighted sums
    plan.build              core/plan.py make_plan,       plan_s.gnn_infer
                            make_graph_plan
    plan.host_index         its stages: the copy to the   -
    plan.stats              host and int32 cast; sorted
    plan.row_ptr            check, stats and config;
    plan.source_order       row offsets; source order
    serve.step (batch, pad, serve/engine.py               ServedResult.stages
      plan_cache, copy,
      stamp, execute, fetch)
    train.step (sample,     train/trainer.py              -
      prepare, execute)
    pipeline.produce        data/pipeline.py              -
      (sample, pad,
      plan_cache, copy,
      stamp)
    autotune.tune           core/autotune.py              -

``mp_ms.gnn_infer``, ``attn_ms.gnn_infer`` and ``plan_s.gnn_infer`` are
per-layer metrics of the port's benchmark (``bench/metrics``): the first
two sum the device time of the kernels launched inside the profiler's
``mp.aggregate`` and ``gat.attention`` ranges, the third reads the newest
root ``plan.build`` in the ring. The other spans
name the profiler trace's idle gaps and the stages of a tree.

Export: :func:`chrome_trace` renders the ring as Chrome
``trace_event`` JSON ("X" complete events, µs timestamps relative to
process start) loadable in ``chrome://tracing`` / Perfetto;
:func:`write_chrome_trace` writes it to disk (also wired to
``REPRO_TRACE_PATH`` at process exit by :mod:`repro_torch.obs`).

Disabled mode (``repro_torch.obs.disable()``): ``span`` returns a shared
no-op span and records nothing, neither a span nor a profiler range — the
per-call cost is one flag check.
"""
from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional

from repro_torch.obs import registry as _registry

__all__ = ["Span", "span", "current_span", "spans", "reset_spans",
           "chrome_trace", "write_chrome_trace"]

_clock = time.perf_counter
_get_ident = threading.get_ident
_T0 = _clock()                    # process-relative timestamp origin

_RING_CAP = int(os.environ.get("REPRO_TRACE_RING", "512"))
# deque's append, copy and clear are atomic: the ring needs no lock
_RING: collections.deque = collections.deque(maxlen=_RING_CAP)

# each thread's innermost open span (``span``: absent until its first)
_LOCAL = threading.local()


class Span:
    """One timed stage, and its own context manager: ``with`` opens it in
    this thread's context (under the span open there, if any) and closes
    it. ``attrs`` carry structured context (bucket, step, cause, ...);
    ``children`` make the tree. While a ``torch.profiler`` session records,
    the span also holds a ``record_function`` range of its name open."""

    __slots__ = ("name", "attrs", "t0", "dur_s", "children", "tid",
                 "_parent", "_range")

    def __init__(self, name: str, attrs: Dict):
        self.name = name
        self.attrs = attrs
        self.dur_s = 0.0
        self.children: List["Span"] = []
        self.tid = _get_ident()

    def __enter__(self) -> "Span":
        if (_profiler_enabled or _find_profiler)():
            self._range = sys.modules["torch"].autograd.profiler \
                .record_function(self.name)
            self._range.__enter__()
        else:
            self._range = None
        local = _LOCAL
        self._parent = getattr(local, "span", None)
        local.span = self
        self.t0 = _clock() - _T0
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.dur_s = (_clock() - _T0) - self.t0
        parent = self._parent
        _LOCAL.span = parent
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        self._parent = None
        if parent is not None:
            parent.children.append(self)
        else:
            _RING.append(self)

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

    def as_dict(self, _names: Optional[Dict[int, str]] = None) -> dict:
        """The subtree as plain data; ``thread`` is the name of the thread
        that ran the span, looked up now (its id as text once that thread
        has ended)."""
        names = _thread_names() if _names is None else _names
        return {"name": self.name, "t0_s": self.t0, "dur_s": self.dur_s,
                "attrs": dict(self.attrs),
                "thread": names.get(self.tid, str(self.tid)),
                "children": [c.as_dict(names) for c in self.children]}

    def __repr__(self):
        return (f"Span({self.name!r}, {self.dur_s * 1e3:.2f}ms, "
                f"{len(self.children)} children)")


class _NullSpan:
    """Shared no-op span for disabled mode."""

    name = None
    attrs: Dict = {}
    children: List = []

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass

    def set(self, **attrs) -> None:
        pass

    def find(self, name):
        return None

    def stages(self):
        return set()


_NULL = _NullSpan()


def _thread_names() -> Dict[int, str]:
    return {t.ident: t.name for t in threading.enumerate()}


# torch's "is a profiler session recording" flag, once torch is loaded
_profiler_enabled = None


def _find_profiler() -> bool:
    """The profiler's flag, found through ``sys.modules`` (and kept) once
    torch is loaded: a process without torch never imports it."""
    global _profiler_enabled
    torch = sys.modules.get("torch")
    if torch is None or not hasattr(torch, "autograd"):
        return False
    _profiler_enabled = torch.autograd._profiler_enabled
    return _profiler_enabled()


def span(name: str, **attrs):
    """One timed stage as a context manager that yields the live
    :class:`Span` (a shared no-op when observability is disabled)."""
    if not _registry._ENABLED:
        return _NULL
    return Span(name, attrs)


def current_span() -> Optional[Span]:
    return getattr(_LOCAL, "span", None)


def spans(name: Optional[str] = None) -> List[Span]:
    """Completed root spans in the ring (oldest first); ``name`` filters
    by root-span name."""
    roots = list(_RING)
    if name is not None:
        roots = [r for r in roots if r.name == name]
    return roots


def reset_spans() -> None:
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

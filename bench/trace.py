"""The traced window of a ``--trace 1`` run and what the per-layer readers
(``bench/metrics``) read from it.

Two profiler sessions, one after the other. The first, over the host and
the card without shapes (recording shapes doubles the host's time a step
of an op-heavy unit, and the card then waits on the host), is the window:
a :class:`View` of its Chrome trace. The second, over the host alone with
shapes, runs one more unit for the custom ops' recorded arguments
(:func:`custom_op_calls`); it starts no device tracing, so it cannot take
device events from the first.

The harness marks its own regions with ``record_function`` ranges named
``bench.*``: ``bench.window`` spans the traced units (ending after the
device has finished them), and ``bench.sync`` the harness's own
synchronisations, which the readers leave out. Times in the view are
seconds from the window's start; device events are clipped to the window.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import re
import tempfile
from pathlib import Path

from bench.roofline import Arg

WINDOW = "bench.window"
SYNC = "bench.sync"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# runtime calls that block the host until the device has caught up
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
              "cuStreamSynchronize", "cuCtxSynchronize",
              "cuEventSynchronize", "cuMemcpyDtoH_v2", "cuMemcpyHtoD_v2")
CUSTOM_OP_PREFIX = "repro_torch::"


def profile(torch, device: bool = True):
    """The window's profiler (host and card, no shapes), or with
    ``device=False`` the host alone with the ops' shapes."""
    act = [torch.profiler.ProfilerActivity.CPU]
    if device:
        act.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=act, record_shapes=not device)


def export(prof) -> dict:
    """The profiler's Chrome trace as a dict (written to a file in TMPDIR
    and removed)."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.unlink(path)


class Event:
    __slots__ = ("name", "cat", "start", "end", "tid", "args")

    def __init__(self, name, cat, start, end, tid, args):
        self.name, self.cat = name, cat
        self.start, self.end = start, end
        self.tid, self.args = tid, args

    @property
    def dur(self) -> float:
        return self.end - self.start


def _args_of(e: Event):
    """The recorded arguments of a host op as :class:`Arg`s."""
    a = e.args
    dims = a.get("Input Dims", [])
    types = a.get("Input type", [])
    values = a.get("Concrete Inputs", [])
    return [Arg(d, types[i] if i < len(types) else "",
                values[i] if i < len(values) else "")
            for i, d in enumerate(dims)]


def outermost_custom_ops(events) -> list:
    """The calls of the port's custom ops among ``events``, those nested
    under a call of the same op on the same thread left out."""
    calls = sorted((e for e in events if e.name.startswith(CUSTOM_OP_PREFIX)),
                   key=lambda e: (e.tid, e.start, -e.end))
    out, last = [], {}
    for e in calls:
        prev = last.get((e.tid, e.name))
        if prev is not None and e.start < prev.end:
            continue
        out.append(e)
        last[(e.tid, e.name)] = e
    return out


def custom_op_calls(trace: dict) -> list:
    """[(op name, [Arg])] of every outermost custom-op call in a trace
    recorded with shapes, in the order of their start."""
    events = [Event(e.get("name", ""), e.get("cat", ""),
                    float(e["ts"]) * 1e-6,
                    (float(e["ts"]) + float(e.get("dur", 0))) * 1e-6,
                    e.get("tid"), e.get("args", {}) or {})
              for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "ts" in e and e.get("cat") == "cpu_op"]
    calls = sorted(outermost_custom_ops(events), key=lambda e: e.start)
    return [(c.name, _args_of(c)) for c in calls]


class View:
    """One traced window, read once from the Chrome trace."""

    def __init__(self, trace: dict):
        raw = [e for e in trace.get("traceEvents", [])
               if e.get("ph") == "X" and "ts" in e]
        windows = [e for e in raw if e.get("name") == WINDOW
                   and e.get("cat") == "user_annotation"]
        if len(windows) != 1:
            raise ValueError(f"the trace holds {len(windows)} "
                             f"'{WINDOW}' ranges, not one")
        w = windows[0]
        t0 = float(w["ts"])
        self.window_s = float(w["dur"]) * 1e-6
        lo, hi = 0.0, self.window_s

        def ev(e):
            start = (float(e["ts"]) - t0) * 1e-6
            return Event(e.get("name", ""), e.get("cat", ""), start,
                         start + float(e.get("dur", 0)) * 1e-6,
                         e.get("tid"), e.get("args", {}) or {})
        every = [ev(e) for e in raw]
        self.device = []
        for e in every:
            if e.cat in DEVICE_CATS and e.end > lo and e.start < hi:
                e.start, e.end = max(e.start, lo), min(e.end, hi)
                self.device.append(e)
        self.device.sort(key=lambda e: e.start)
        inside = [e for e in every if e.cat not in DEVICE_CATS
                  and e.start >= lo and e.start <= hi]
        self.launches = [e for e in inside if e.cat in LAUNCH_CATS]
        self.host_ops = [e for e in inside
                         if e.cat in ("cpu_op", "user_annotation")
                         and e.name != WINDOW]
        self._harness = sorted((e.start, e.end, e.tid)
                               for e in self.host_ops
                               if e.name.startswith("bench."))
        # a kernel's launch by the correlation id the two share
        by_corr = {e.args.get("correlation"): e for e in every
                   if e.cat in LAUNCH_CATS}
        self.launch_of = {id(d): by_corr.get(d.args.get("correlation"))
                          for d in self.device}

    # -- what the readers ask ---------------------------------------------
    def kernels(self) -> list:
        return [e for e in self.device if e.cat == "kernel"]

    def busy_s(self) -> float:
        """The union of the device events' intervals in the window."""
        busy, reach = 0.0, 0.0
        for e in self.device:
            if e.end > reach:
                busy += e.end - max(e.start, reach)
                reach = e.end
        return busy

    def in_harness(self, e: Event) -> bool:
        """Whether ``e`` ran inside one of the harness's own ranges."""
        for start, end, tid in self._harness:
            if start <= e.start <= end and (tid == e.tid or tid is None):
                return True
        return False

    def host_syncs(self) -> int:
        """Runtime calls that block the host, outside the harness's own."""
        return sum(1 for e in self.launches
                   if e.name in SYNC_CALLS and not self.in_harness(e))

    def custom_ops(self) -> list:
        """The outermost calls of the port's custom ops in the window."""
        return outermost_custom_ops(self.host_ops)

    def kernels_launched_in(self, calls) -> dict:
        """{id(call): [kernel events]}: the kernels whose launch (tied by
        the profiler's correlation id) lies inside each call on its
        thread."""
        by_tid = collections.defaultdict(list)
        for c in calls:
            by_tid[c.tid].append(c)
        starts = {}
        for tid, cs in by_tid.items():
            cs.sort(key=lambda c: c.start)
            starts[tid] = [c.start for c in cs]
        out = {id(c): [] for c in calls}
        for k in self.kernels():
            launch = self.launch_of.get(id(k))
            cs = by_tid.get(launch.tid) if launch is not None else None
            if not cs:
                continue
            i = bisect.bisect_right(starts[launch.tid], launch.start) - 1
            if i >= 0 and launch.start <= cs[i].end:
                out[id(cs[i])].append(k)
        return out

    def host_op_at(self, t: float) -> str:
        """The innermost host op or range open at ``t`` (seconds into the
        window), the harness's own ranges included."""
        best = None
        for e in self.host_ops:
            if e.start <= t <= e.end and (best is None or e.dur < best.dur):
                best = e
        return best.name if best is not None else "(no host op)"

    def idle_gaps(self) -> list:
        """[(start, length)] of the gaps between device events in the
        window, the window's ends included."""
        gaps, reach = [], 0.0
        for e in self.device:
            if e.start > reach:
                gaps.append((reach, e.start - reach))
            reach = max(reach, e.end)
        if self.window_s > reach:
            gaps.append((reach, self.window_s - reach))
        return gaps


_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")


def port_kernel_names(csrc: Path) -> set:
    """The ``__global__`` functions of the port's CUDA sources."""
    names = set()
    for f in csrc.glob("*.cu*"):
        names.update(_GLOBAL.findall(f.read_text()))
    return names


def port_kernel_matcher(names: set):
    """A predicate: whether a kernel's name (demangled or mangled) is one
    of ``names``."""
    if not names:
        return lambda name: False
    pat = re.compile(r"(?<![A-Za-z_])(" + "|".join(sorted(names))
                     + r")(?=[<(IE])")
    return lambda name: pat.search(name) is not None


def breakdown(view: View, top: int = 10) -> dict:
    """The device ops that took most time in the window (summed by name),
    and the longest idle gaps, each named by the host op open at its
    middle."""
    by_name = collections.Counter()
    for e in view.device:
        by_name[e.name[:160]] += e.dur
    ops = [[n, s] for n, s in by_name.most_common(top)]
    gaps = sorted(view.idle_gaps(), key=lambda g: -g[1])[:top]
    return {"device_ops": ops,
            "idle_gaps": [[view.host_op_at(s + d / 2), d] for s, d in gaps]}

"""One run of one cell: the cell's files found by name, set-up, the
measured (or traced) window, the correctness check against the plain
reference, and the result line.

A cell of ``BENCHMARK.json`` names a configuration (its file, under
``bench/configs``) and a traffic mix (``bench/traffic/<traffic>.json``).
The traffic file's ``driver`` names the module of ``bench/drivers`` that
runs the timed path; the cell's limits are ``bench/limits/<cell>.json``;
each metric is read by ``bench/metrics/<name before the first dot>.py``.
A later cell, mix or metric on an existing driver or reader is new files
and entries only.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import random
import sys
import time
from pathlib import Path
from typing import Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
# top-level module names that no run may load (the JAX package and JAX)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module of the benchmark by its file (its name may hold '-')."""
    name = "bench._loaded." + "_".join(path.relative_to(BENCH).with_suffix(
        "").parts)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def parked_spec() -> dict:
    """BENCHMARK.json with the entries of the cells taken out of it
    (``bench/parked.json``) added back: for those cells' tests."""
    spec = load_json(ROOT / "BENCHMARK.json")
    parked = load_json(BENCH / "parked.json")
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        spec[key] = spec[key] + parked[key]
    return spec


@dataclasses.dataclass
class Cell:
    """A cell's files, read: its entry, configuration, traffic, limits and
    the metrics it reports."""
    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @classmethod
    def load(cls, name: str, spec: Optional[dict] = None) -> "Cell":
        spec = spec if spec is not None else load_json(ROOT / "BENCHMARK.json")
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                           f"{sorted(cells)}")
        entry = cells[name]
        configs = {c["name"]: c for c in spec["configs"]}
        config = load_json(ROOT / configs[entry["config"]]["file"])
        traffic = load_json(BENCH / "traffic" / f"{entry['traffic']}.json")
        limits = load_json(BENCH / "limits" / f"{name}.json")

        def mine(m):
            return name in m.get("workloads", [name])
        return cls(name, entry, config, traffic, limits,
                   [m for m in spec["end_to_end"] if mine(m)],
                   [m for m in spec["per_layer"] if mine(m)])


@dataclasses.dataclass
class Record:
    """What the readers read: the window's counts and times, the cell's
    constants, and in a traced run the trace's view (``units`` its units),
    the seconds a unit took untraced just before it, and the custom-op
    calls of one unit with their recorded shapes."""
    setup_s: float
    window_s: float
    units: int
    latencies_s: Optional[list] = None
    tokens_per_unit: Optional[int] = None
    flops_per_unit: Optional[float] = None
    peak_flops: Optional[float] = None
    view: object = None
    unit_s: Optional[float] = None        # a unit's seconds, untraced
    op_calls: Optional[list] = None       # one unit's custom-op calls
    csrc: Path = CSRC


class Reservoir:
    """A sample of ``size`` of a stream's items, drawn from the seed
    (reservoir sampling): the answers the check compares."""

    def __init__(self, seed: int, size: int):
        self.rng = random.Random(seed)
        self.size = size
        self.items: list = []
        self.seen = 0

    def offer(self, item) -> None:
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                self.items[j] = item
        self.seen += 1


def say(msg: str) -> None:
    """A progress line on standard error (before the checks, which come
    last there)."""
    print(f"bench: {msg}", file=sys.stderr, flush=True)


class Phases:
    """Seconds of each named phase of a set-up, on the host clock after a
    synchronisation of the card (``sync``), printed as they end."""

    def __init__(self, sync):
        self.sync = sync
        self.t = time.perf_counter()
        self.seconds: dict = {}

    def end(self, name: str) -> None:
        self.sync()
        now = time.perf_counter()
        self.seconds[name] = now - self.t
        self.t = now
        say(f"set-up {name}: {self.seconds[name]:.3f} s")


def worst(a: float, b: float) -> float:
    """The larger of two readings, a reading that is not finite as inf."""
    if not math.isfinite(b) or not math.isfinite(a):
        return math.inf
    return max(a, b)


def forbidden_modules(modules) -> list:
    """The loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def judge(checks: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number the driver
    compared at or under its limit (a number that is not finite fails)."""
    out, correct = {}, True
    for name, value in checks.items():
        if name not in limits:
            raise KeyError(f"no limit for {name!r} in the cell's limits")
        limit = float(limits[name]["limit"])
        value = float(value)
        ok = math.isfinite(value) and value <= limit
        correct = correct and ok
        out[name] = {"value": value, "limit": limit}
    missing = set(limits) - set(checks)
    if missing:
        raise KeyError(f"the driver compared none of {sorted(missing)}")
    return correct, out


def run_cell(torch, cell: Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float) -> dict:
    """Set up the cell, run its window, check its outputs and return the
    result line's dict. The window is ``seconds`` long; in a traced run it
    is the traffic's ``trace_units`` units run untraced twice (the second
    pass timed: the time a unit), the same number under the profiler
    (:mod:`bench.trace`), then one more under the shapes' profiler. ``t_start``: the process's start on the
    host clock (set-up counts from it)."""
    from bench import trace as tr
    driver = load_module(BENCH / "drivers" / f"{cell.traffic['driver']}.py")
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    session = driver.setup(cell.config, cell.traffic, seed, device)
    sync()
    setup_s = time.perf_counter() - t_start
    view, units, unit_s, op_calls = None, 0, None, None
    if trace:
        n = int(cell.traffic["trace_units"])
        # untraced first: one pass that lets the card come back up to
        # speed after a set-up on the host, then the time a unit for the
        # rates
        for _ in range(n):
            session.unit()
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            session.unit()
        sync()
        unit_s = (time.perf_counter() - t0) / n
        prof = tr.profile(torch)
        with prof:
            with torch.profiler.record_function(tr.WINDOW):
                for _ in range(n):
                    session.unit()
                with torch.profiler.record_function(tr.SYNC):
                    sync()
        view = tr.View(tr.export(prof))
        prof = tr.profile(torch, device=False)
        with prof:
            session.unit()
            sync()
        op_calls = tr.custom_op_calls(tr.export(prof))
        del prof
        units, attempted, window_s = n, 3 * n + 1, view.window_s
    else:
        t0 = time.perf_counter()
        while True:
            session.unit()
            units += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync()
        window_s = time.perf_counter() - t0
        attempted = units
    rec = Record(setup_s=setup_s, window_s=window_s, units=units,
                 latencies_s=session.latencies(),
                 tokens_per_unit=getattr(session, "tokens_per_unit", None),
                 flops_per_unit=session.flops_per_unit,
                 peak_flops=session.peak_flops, view=view, unit_s=unit_s,
                 op_calls=op_calls)
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    failed = session.failed()
    # the program's state goes before the reference runs
    checks = session.check()
    del session
    gc.collect()
    correct, compared = judge(checks, cell.limits)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_module(BENCH / "metrics"
                            / f"{m['name'].split('.')[0]}.py").read(rec)
        if value is None:
            if not trace:
                raise RuntimeError(f"{cell.name}: end-to-end metric "
                                   f"{m['name']} read nothing")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(cell.entry["chips"]),
           "memory_peak_bytes": peak}
    out = {"correct": bool(correct and failed == 0), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = view.busy_s()
        dev["window_s"] = view.window_s
        out["breakdown"] = tr.breakdown(view)
    out["checks"] = compared
    return out

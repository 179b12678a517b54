"""repro_torch.obs — telemetry of the port, as the reference's ``repro.obs``:
the same three pillars, the same API and the same environment variables,
stdlib only.

  * **metrics registry** (:mod:`repro_torch.obs.registry`) — thread-safe
    Counter/Gauge/Histogram with labels; exact p50/p95/p99 over a bounded
    sample window; snapshot + delta; JSON-lines and Prometheus export
    (:mod:`repro_torch.obs.export`).
  * **tracing spans** (:mod:`repro_torch.obs.trace`) — ``span("serve.step")``
    context managers building per-request / per-step span trees, with a
    ring-buffer trace log and Chrome ``trace_event`` export. While a
    ``torch.profiler`` session records, each span is also a
    ``record_function`` range of its name, on the profiler's clock.
  * **attribution hooks** (:mod:`repro_torch.obs.hooks`) — every bucket
    build, plan-cache miss or eviction, autotuner consult and bucket probe
    records a
    structured cause, so ``why_built()`` answers "why did step 37 build?".

The counter APIs (``fusion_counts``, ``CacheStats``, ``GNNServer.stats``,
``PrefetchPipeline.stats``, ``Trainer.buckets``) are views over this
registry — their instruments are *vital* and keep counting even when
:func:`disable` switches the optional instrumentation (spans, launch
mirrors, attribution) off. Spans time the host; they never synchronise
with the card.

The port has no XLA compile, so the reference's instruments that count
compiles are renamed, not faked: a *build* is the first run of a shape
bucket's entry (its plan, its kernels' first launches). ``OBS_SCHEMA``
is the reference's with these changes (``=``: the same name; ``-``: none,
the port's own):

    metric                          labels        reference name
    ------------------------------  ------------  --------------------------
    kernel.launches                 kind, op      =
    kernel.schedule_launches        op, schedule  -
    serve.requests                  engine        =
    serve.batches                   engine        =
    serve.serve_s                   engine        =
    serve.builds                    engine        serve.compiles
    serve.request_latency_s         engine        =
    serve.queue_s                   engine        =
    serve.pad_node_frac             engine        =
    serve.pad_edge_frac             engine        =
    serve.submitted                 batcher       =
    serve.queue_depth               batcher       =
    serve.plan_cache.hits           cache         =
    serve.plan_cache.misses         cache         =
    serve.plan_cache.evictions      cache         =
    serve.plan_cache.prefills       cache         =
    serve.plan_cache.plan_builds    cache         =
    serve.plan_cache.plan_build_s   cache         =
    pipeline.batches                pipeline      =
    pipeline.sync_falls             pipeline      =
    pipeline.wait_s                 pipeline      =
    pipeline.produce_s              pipeline      =
    train.steps                     trainer       =
    train.buckets                   trainer       train.traces
    build.events                    site, cause   compile.events
    autotune.tunes                  op, outcome   =
    -                                             serve.plan_cache.compiles
    -                                             serve.plan_cache.compile_s

``kernel.schedule_launches`` counts the row-run kernels' launches (the
gather's runs path, segment_reduce) by column schedule, ``tiled`` or
``whole_row`` (:func:`repro_torch.kernels.ops.schedule_launch_counts`);
``serve.builds`` counts the first run of a bucket's entry;
``train.buckets`` the first step on a new ``GraphStatic``;
``build.events`` is filled by :func:`record_build` (the reference's
``record_compile``) and read by :func:`why_built` (``why_compiled``).
The plan cache's ``plan_builds`` / ``plan_build_s`` already count the
entry, so its compile pair is dropped. ``autotune.tunes`` counts
:func:`record_tune`'s consults of the autotuner (outcome ``hit`` or
``sweep``); a sweep runs inside the span ``autotune.tune``. No span is
named ``*.compile``:
``serve.execute`` and ``train.execute`` carry ``new_bucket=True`` on a
bucket's first run.

The spans of the GNN request and of the plan build, and the benchmark
metric each feeds (``bench/metrics``; the full table is in
:mod:`repro_torch.obs.trace`):

    gnn.forward > gnn.layer > mp.order    (names the trace's idle gaps)
    gnn.layer > mp.aggregate               mp_ms.gnn_infer: device time of
                                           the kernels launched inside
    plan.build > plan.host_index,          plan_s.gnn_infer: the newest
      plan.stats, plan.row_ptr,            root plan.build's seconds
      plan.source_order

No span is named ``bench.*`` or ``repro_torch::*``.

Environment:

  * ``REPRO_OBS=0``            — start disabled (overhead ≈ flag checks)
  * ``REPRO_METRICS_PATH``     — periodic + at-exit JSON-lines flush
  * ``REPRO_METRICS_EVERY_S``  — flush period (default 30)
  * ``REPRO_TRACE_PATH``       — Chrome trace JSON written at exit
"""
from __future__ import annotations

import atexit
import os

from repro_torch.obs import export, hooks, registry, trace
from repro_torch.obs.export import (start_flusher, stop_flusher, to_jsonl,
                                    to_prometheus, write_jsonl,
                                    write_prometheus)
from repro_torch.obs.hooks import (attributions, record_build,
                                   record_cache_event, record_probe,
                                   record_tune, reset_events, why_built)
from repro_torch.obs.registry import (Counter, Gauge, Histogram,
                                      MetricsRegistry, get_registry, next_id)
from repro_torch.obs.trace import (Span, chrome_trace, current_span,
                                   reset_spans, span, spans,
                                   write_chrome_trace)

__all__ = [
    "registry", "trace", "hooks", "export",
    # registry
    "get_registry", "next_id", "Counter", "Gauge", "Histogram",
    "MetricsRegistry",
    # spans
    "span", "spans", "current_span", "reset_spans", "Span",
    "chrome_trace", "write_chrome_trace",
    # attribution
    "record_build", "record_cache_event", "record_tune", "record_probe",
    "attributions", "why_built", "reset_events",
    # export
    "to_jsonl", "write_jsonl", "to_prometheus", "write_prometheus",
    "start_flusher", "stop_flusher",
    # switch + summaries
    "enable", "disable", "enabled", "report", "reset", "OBS_SCHEMA",
]


# the documented metric schema (the table above; tests pin both)
OBS_SCHEMA = {
    # kernel launch accounting (mirrors fusion_counts, and the row-run
    # kernels' launches by column schedule)
    "kernel.launches":            ("kind", "op"),
    "kernel.schedule_launches":   ("op", "schedule"),
    # serving engine (one label value per GNNServer instance)
    "serve.requests":             ("engine",),
    "serve.batches":              ("engine",),
    "serve.serve_s":              ("engine",),
    "serve.builds":               ("engine",),
    "serve.request_latency_s":    ("engine",),
    "serve.queue_s":              ("engine",),
    "serve.pad_node_frac":        ("engine",),
    "serve.pad_edge_frac":        ("engine",),
    # batcher admission
    "serve.submitted":            ("batcher",),
    "serve.queue_depth":          ("batcher",),
    # plan cache (one label value per PlanCache instance)
    "serve.plan_cache.hits":         ("cache",),
    "serve.plan_cache.misses":       ("cache",),
    "serve.plan_cache.evictions":    ("cache",),
    "serve.plan_cache.prefills":     ("cache",),
    "serve.plan_cache.plan_builds":  ("cache",),
    "serve.plan_cache.plan_build_s": ("cache",),
    # out-of-core pipeline (one label value per PrefetchPipeline)
    "pipeline.batches":           ("pipeline",),
    "pipeline.sync_falls":        ("pipeline",),
    "pipeline.wait_s":            ("pipeline",),
    "pipeline.produce_s":         ("pipeline",),
    # trainer (one label value per Trainer instance)
    "train.steps":                ("trainer",),
    "train.buckets":              ("trainer",),
    # attribution counters
    "build.events":               ("site", "cause"),
    "autotune.tunes":             ("op", "outcome"),
}


# ---------------------------------------------------------------------------
# switch
# ---------------------------------------------------------------------------

def enable() -> None:
    """Switch the optional instrumentation (spans, launch mirrors,
    attribution events) on. Vital counters always count."""
    registry._set_enabled(True)


def disable() -> None:
    """Switch the optional instrumentation off; per-call cost drops to a
    flag check. The public counter APIs keep working (vital)."""
    registry._set_enabled(False)


def enabled() -> bool:
    return registry._is_enabled()


def reset() -> None:
    """Zero metrics, drop spans and attribution events. Registered
    instruments keep their handles (safe for live engines)."""
    get_registry().reset()
    reset_spans()
    reset_events()


# ---------------------------------------------------------------------------
# human summary
# ---------------------------------------------------------------------------

def report() -> str:
    """A human-readable telemetry summary: counters grouped by prefix,
    histogram quantiles, and the most recent build attributions."""
    reg = get_registry()
    lines = ["== repro_torch.obs report =="]
    by_prefix: dict = {}
    for row in reg.snapshot():
        by_prefix.setdefault(row["name"].split(".")[0], []).append(row)
    for prefix in sorted(by_prefix):
        lines.append(f"[{prefix}]")
        for row in by_prefix[prefix]:
            lab = ",".join(f"{k}={v}" for k, v in row["labels"].items())
            lab = f"{{{lab}}}" if lab else ""
            if row["type"] == "histogram":
                lines.append(
                    f"  {row['name']}{lab}  n={row['count']} "
                    f"mean={row['mean']:.6f} p50={row['p50']:.6f} "
                    f"p95={row['p95']:.6f} p99={row['p99']:.6f}")
            else:
                v = row["value"]
                v = int(v) if float(v).is_integer() else v
                lines.append(f"  {row['name']}{lab} = {v}")
    builds = why_built()
    if builds:
        lines.append(f"[attribution] {len(builds)} builds recorded; "
                     "most recent:")
        for e in builds[-8:]:
            detail = {k: v for k, v in e.items()
                      if k not in ("kind", "site", "cause", "t_s")}
            lines.append(f"  {e['site']} <- {e['cause']} {detail}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# environment wiring
# ---------------------------------------------------------------------------

if os.environ.get("REPRO_OBS", "1") in ("0", "false", "False"):
    disable()

_METRICS_PATH = os.environ.get("REPRO_METRICS_PATH")
if _METRICS_PATH:
    start_flusher(_METRICS_PATH,
                  float(os.environ.get("REPRO_METRICS_EVERY_S", "30")))
    atexit.register(stop_flusher)

_TRACE_PATH = os.environ.get("REPRO_TRACE_PATH")
if _TRACE_PATH:
    atexit.register(lambda: write_chrome_trace(_TRACE_PATH))

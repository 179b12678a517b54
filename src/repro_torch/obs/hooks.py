"""Attribution hooks: every expensive or surprising event — a bucket's
first run, a plan-cache miss or eviction, an autotuner sweep or PerfDB
hit, a bucket probe — records a
structured *cause*, so "why did step 37 build?" is answerable from the
telemetry dump alone. As the reference's (``repro/obs/hooks.py``), with
builds in place of compiles: PyTorch runs eagerly, so what the port pays
once per shape bucket is the entry's first run (its plan, its kernels'
first launches), not an XLA compile.

Events are plain dicts in a bounded ring (``attributions()``), each with
``kind`` / ``site`` / ``cause`` plus whatever structured detail the call
site attaches (bucket, static signature, engine, step). A counter per
(site, cause) lands in the metrics registry (``build.events``) so
dashboards can alert on build storms without parsing the ring.

Recording respects the observability switch
(``repro_torch.obs.disable()`` makes every hook a no-op); the public
counter APIs these events annotate (``CacheStats`` etc.) are vital and
keep counting regardless.
"""
from __future__ import annotations

import collections
import os
import threading
import time
from typing import List, Optional

from repro_torch.obs import registry as _registry

__all__ = ["record_build", "record_cache_event", "record_tune", "record_probe",
           "attributions", "why_built", "reset_events"]

_RING_CAP = int(os.environ.get("REPRO_OBS_EVENTS", "1024"))
_EVENTS: collections.deque = collections.deque(maxlen=_RING_CAP)
_LOCK = threading.Lock()


def _record(kind: str, site: str, cause: str, detail: dict) -> None:
    if not _registry._is_enabled():
        return
    event = {"kind": kind, "site": site, "cause": cause,
             "t_s": time.time(), **detail}
    with _LOCK:
        _EVENTS.append(event)


def record_build(site: str, cause: str, **detail) -> None:
    """A bucket's first run at ``site`` (serve.forward, train.step, ...)
    because of ``cause`` (warmup, bucket_miss, new_bucket,
    sampled_ingest, ...). Attach the bucket or static signature, engine or
    trainer — whatever identifies what ran."""
    _registry.get_registry().counter(
        "build.events", labels=("site", "cause")).inc(site=site, cause=cause)
    _record("build", site, cause, detail)


def record_cache_event(cache: str, cause: str, **detail) -> None:
    """A plan-cache miss or eviction on ``cache`` (the instance label the
    cache's counters carry). Hits are not recorded here — they are the
    steady state the counters already measure."""
    _record("cache", f"plan_cache:{cache}", cause, detail)


def record_tune(op: str, *, cache_hit: bool, timings: int = 0,
                **detail) -> None:
    """One autotuner consult: a warm PerfDB hit or a paid sweep on the card
    (``timings`` kernel configurations timed)."""
    outcome = "hit" if cache_hit else "sweep"
    _registry.get_registry().counter(
        "autotune.tunes", labels=("op", "outcome")).inc(op=op,
                                                        outcome=outcome)
    _record("tune", f"autotune:{op}", outcome, dict(detail, timings=timings))


def record_probe(site: str, bucket, **detail) -> None:
    """A bucket probe (e.g. warmup schedule discovery): which bucket a
    probed batch landed in, before any traffic pays for it."""
    _record("probe", site, "bucket_probe", dict(detail, bucket=str(bucket)))


def attributions(kind: Optional[str] = None) -> List[dict]:
    """The event ring, oldest first; ``kind`` filters (build / cache /
    probe)."""
    with _LOCK:
        events = list(_EVENTS)
    if kind is not None:
        events = [e for e in events if e["kind"] == kind]
    return events


def why_built() -> List[dict]:
    """Every recorded bucket build with its cause — the build audit."""
    return attributions("build")


def reset_events() -> None:
    with _LOCK:
        _EVENTS.clear()

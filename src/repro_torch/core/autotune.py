"""Measured config selection: a sweep of the built kernel instances on
the card, kept in a persistent performance database (paper §III-C).

* :func:`tune` times the candidates of one (op, shape class) on the card:
  the rules' pick and the shipped values first, then the lattice
  (:func:`repro_torch.core.config_space.all_configs`), each launched
  through the port's kernel wrappers on seeded synthetic inputs, held
  against the plain version, and timed with CUDA events (warm-up, then the
  median of ``reps``). There is no CPU sweep: without a card and without a
  ``measure_fn`` it raises.
* :class:`PerfDB` keeps every sweep as JSON under
  ``~/.cache/repro_torch-perfdb`` (``REPRO_PERFDB_PATH`` moves it), keyed
  ``backend / op [@shelf] / quantized features`` with a backend that names
  the card (``cuda:NVIDIA H100 80GB HBM3``), so a sweep of another card is
  never served here. The schema, the key format and ``DB_VERSION`` are the
  reference package's: its files read here.
* The winner is the top tier of :func:`repro_torch.core.heuristics.
  select_config`; ``python -m repro_torch.core.train_rules --from-perfdb``
  distills rules from the measured records.

An op's candidates are deduplicated by what its kernel reads
(:func:`config_projection`): M_b for the gather and segment_reduce, S_b
for the fused kernel, nothing for the softmax, sddmm and segment_matmul
(one candidate, still timed and stored).

Environment: ``REPRO_AUTOTUNE`` (the measured tier everywhere),
``REPRO_PERFDB_PATH`` (directory or ``*.json``),
``REPRO_AUTOTUNE_MAX_CONFIGS`` / ``REPRO_AUTOTUNE_REPS`` (sweep budget).
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import pathlib
import statistics
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.config_space import OP_AXIS, KernelConfig
from repro_torch.core.features import InputFeatures

__all__ = ["PerfDB", "TuneResult", "tune", "lookup", "autotune_enabled",
           "perf_key", "quantize_features", "config_projection",
           "make_runner", "current_backend"]

DB_VERSION = 1
DEFAULT_MAX_CONFIGS = 24
DEFAULT_REPS = 5
DEFAULT_WARMUP = 2
DEFAULT_SEED = 0                 # deterministic synthetic inputs
_QUANT_STEP = 0.5                # log2-space bin width for shape classes


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "") not in ("", "0", "false", "False")


def autotune_enabled() -> bool:
    """True when ``REPRO_AUTOTUNE=1`` turns on the measured tier globally."""
    return _env_flag("REPRO_AUTOTUNE")


def current_backend() -> Optional[str]:
    """``cuda:<card name>`` of the current card, or None without one: the
    shelf of the PerfDB that this process reads and writes."""
    import torch
    if not torch.cuda.is_available():
        return None
    return f"cuda:{torch.cuda.get_device_name()}"


# ---------------------------------------------------------------------------
# shape-class keys
# ---------------------------------------------------------------------------

def quantize_features(feats: InputFeatures,
                      step: float = _QUANT_STEP) -> Tuple[float, ...]:
    """The log2 feature vector in ``step``-wide bins: shapes in one bin
    share one measured config."""
    vec = feats.as_vector()
    # + 0.0 turns IEEE -0.0 into +0.0, so one bin is one key
    return tuple(float(np.round(v / step) * step + 0.0) for v in vec)


def perf_key(backend: str, op: str, feats: InputFeatures) -> str:
    """``backend / op [@io-dtype shelf] / quantized shape class`` (fp32 has
    no shelf suffix; bf16 is ``@b2``)."""
    q = quantize_features(feats)
    shelf = "" if feats.dtype_bytes == 4 else f"@b{feats.dtype_bytes}"
    return f"{backend}/{op}{shelf}/" + ",".join(f"{v:g}" for v in q)


# ---------------------------------------------------------------------------
# persistent database
# ---------------------------------------------------------------------------

class PerfDB:
    """On-disk JSON cache of measured sweeps, one entry per shape class.

    The whole sweep is stored (config → median µs), not only the winner,
    so ``train_rules --from-perfdb`` retrains from the same records."""

    def __init__(self, path: "str | os.PathLike | None" = None):
        if path is None:
            path = os.environ.get("REPRO_PERFDB_PATH") or os.path.join(
                os.path.expanduser("~"), ".cache", "repro_torch-perfdb")
        p = pathlib.Path(path)
        self.file = p if p.suffix == ".json" else p / "perfdb.json"
        self._entries: Optional[Dict[str, dict]] = None

    def load(self) -> Dict[str, dict]:
        if self._entries is None:
            try:
                with open(self.file) as f:
                    doc = json.load(f)
                self._entries = (doc.get("entries", {})
                                 if doc.get("version") == DB_VERSION else {})
            except (OSError, ValueError):
                self._entries = {}
        return self._entries

    def _save(self) -> None:
        self.file.parent.mkdir(parents=True, exist_ok=True)
        # merge over what is on disk, so concurrent writers lose at most a
        # race on one key, never each other's entries
        on_disk: Dict[str, dict] = {}
        try:
            with open(self.file) as f:
                doc = json.load(f)
            if doc.get("version") == DB_VERSION:
                on_disk = doc.get("entries", {})
        except (OSError, ValueError):
            pass
        on_disk.update(self._entries)
        self._entries = on_disk
        doc = {"version": DB_VERSION, "entries": self._entries}
        # atomic replace: a reader never sees a torn file
        fd, tmp = tempfile.mkstemp(dir=self.file.parent, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            os.replace(tmp, self.file)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def get(self, key: str) -> Optional[dict]:
        return self.load().get(key)

    def put(self, key: str, entry: dict) -> None:
        self.load()[key] = entry
        self._save()

    def __len__(self) -> int:
        return len(self.load())

    def keys(self):
        return self.load().keys()


@functools.lru_cache(maxsize=8)
def _default_db(path_key: str) -> PerfDB:
    """One PerfDB per path for the process (parsed once, not per call)."""
    return PerfDB(path_key or None)


def _db(db: Optional[PerfDB]) -> PerfDB:
    return db if db is not None else _default_db(
        os.environ.get("REPRO_PERFDB_PATH", ""))


# ---------------------------------------------------------------------------
# runners: one per op, on seeded synthetic inputs on the card
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Runner:
    """``call(cfg)`` launches the op's kernel at ``cfg`` and returns its
    output; ``plain()`` is the plain version on the same inputs; ``dtype``
    the io dtype (it sets the check's tolerance)."""
    call: Callable[[KernelConfig], object]
    plain: Callable[[], object]
    dtype: object


def _synth_segments(rng, idx_size: int, num_segments: int):
    return np.sort(rng.integers(0, max(num_segments, 1),
                                size=idx_size)).astype(np.int32)


def make_runner(op: str, idx_size: int, num_segments: int, feat: int, *,
                seed: int = DEFAULT_SEED, io_dtype: str = "float32",
                d_out: Optional[int] = None, device="cuda") -> Runner:
    """The :class:`Runner` of ``op`` at a shape class: the reference
    package's synthetic inputs (sorted uniform segment ids, uniform gather
    ids, standard-normal rows), made with numpy from ``seed`` and moved to
    ``device`` once. The fused kernel's weight is (feat, ``d_out``), square
    by default."""
    import torch

    from repro_torch.core.plan import make_plan
    from repro_torch.kernels import ops as kops
    if op not in _OPS:
        raise ValueError(f"unknown op {op!r}; tunable: {sorted(_OPS)}")
    rng = np.random.default_rng(seed)
    dtype = getattr(torch, io_dtype)
    m, s, f = int(idx_size), max(int(num_segments), 1), max(int(feat), 1)

    def dev(a, cast=True):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return t.to(dtype) if cast and t.is_floating_point() else t

    def normal(*shape):
        return dev(rng.standard_normal(shape).astype(np.float32))

    kind = _OPS[op]
    if kind in ("segment_reduce", "gather", "fused", "softmax"):
        seg = dev(_synth_segments(rng, m, s))
        base = make_plan(seg, s, config=KernelConfig(), device=device)

        def planned(cfg):
            return dataclasses.replace(base, config=cfg)
    if kind == "segment_reduce":
        x = normal(m, f)
        return Runner(lambda cfg: kops.segment_reduce(
            x, seg, s, "sum", plan=planned(cfg), impl="cuda"),
            lambda: kops.segment_reduce(x, seg, s, "sum", impl="ref"), dtype)
    if kind == "gather":
        reduce = op[len("gather_segment_reduce_"):] or "sum"
        h = normal(s, f)
        gidx = dev(rng.integers(0, s, size=m).astype(np.int32))
        return Runner(lambda cfg: kops.gather_segment_reduce(
            h, gidx, seg, s, reduce=reduce, plan=planned(cfg), impl="cuda"),
            lambda: kops.gather_segment_reduce(h, gidx, seg, s,
                                               reduce=reduce, impl="ref"),
            dtype)
    if kind == "fused":
        n = f if d_out is None else int(d_out)
        h = normal(s, f)
        w = dev((rng.standard_normal((f, n)) / np.sqrt(f)).astype(np.float32))
        gidx = dev(rng.integers(0, s, size=m).astype(np.int32))
        return Runner(lambda cfg: kops.fused_transform_reduce(
            h, w, gidx, seg, s, plan=planned(cfg), impl="cuda"),
            lambda: kops.fused_transform_reduce(h, w, gidx, seg, s,
                                                impl="ref"), dtype)
    if kind == "softmax":
        x = normal(m, f)
        return Runner(lambda cfg: kops.segment_softmax(
            x, seg, s, plan=planned(cfg), impl="cuda"),
            lambda: kops.segment_softmax(x, seg, s, impl="ref"), dtype)
    if kind == "sddmm":
        a, b = normal(s, f), normal(s, f)
        row = dev(rng.integers(0, s, size=m).astype(np.int32))
        col = dev(rng.integers(0, s, size=m).astype(np.int32))
        return Runner(lambda cfg: kops.sddmm(a, b, row, col, impl="cuda"),
                      lambda: kops.sddmm(a, b, row, col, impl="ref"), dtype)
    # segment_matmul: balanced groups; grouped: zipf-skewed relation sizes
    if op == "segment_matmul":
        sizes = np.full((s,), m // s, np.int64)
        sizes[: m - int(sizes.sum())] += 1
    else:
        w_rel = np.minimum(rng.zipf(1.2, size=s).astype(np.float64),
                           max(m / 2.0, 1.0))
        sizes = rng.multinomial(m, w_rel / w_rel.sum())
    x = normal(m, f)
    w = dev((rng.standard_normal((s, f, f)) / np.sqrt(f)).astype(np.float32))
    gs = dev(sizes.astype(np.int64), cast=False)
    return Runner(lambda cfg: kops.segment_matmul(x, gs, w, config=cfg,
                                                  impl="cuda"),
                  lambda: kops.segment_matmul(x, gs, w, impl="ref"), dtype)


_OPS = {
    "segment_reduce": "segment_reduce",
    "gather_segment_reduce": "gather",
    "gather_segment_reduce_mean": "gather",
    "gather_segment_reduce_max": "gather",
    "segment_softmax": "softmax",
    "segment_matmul": "matmul",
    "grouped_segment_matmul": "matmul",
    "sddmm": "sddmm",
    "fused_transform_reduce": "fused",
}


def config_projection(op: str, cfg: KernelConfig) -> Tuple:
    """The slice of a config the op's kernel reads (the dedupe key)."""
    axis = OP_AXIS[op]
    return () if axis is None else (axis, getattr(cfg, axis))


def check_output(what: str, got, want, dtype) -> float:
    """Hold a kernel's output against the plain version (fp32: rtol 1e-4,
    atol 1e-4 times the largest magnitude; bf16: 2e-2); returns the max
    absolute error, raises AssertionError on a disagreement."""
    import torch
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    got, want = got.float(), want.float()
    finite = want[torch.isfinite(want)]
    scale = float(finite.abs().max()) if finite.numel() else 1.0
    torch.testing.assert_close(got, want, rtol=tol,
                               atol=tol * max(scale, 1e-30), equal_nan=True,
                               msg=lambda m: f"{what}: {m}")
    diff = (got - want).abs()
    diff = diff[torch.isfinite(diff)]
    return float(diff.max()) if diff.numel() else 0.0


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

# cycles of the busy-wait kernel queued before each timed call (about a
# millisecond): the call's host work is done before the start event fires
_BUSY_CYCLES = 2_000_000


def _median_us(fn: Callable[[], object], reps: int, warmup: int) -> float:
    """Median device time of one call, µs: CUDA events around each call
    after ``warmup`` discarded calls, each behind a busy-wait kernel so
    that the wrapper's host time stays out of the window."""
    import torch
    for _ in range(max(warmup, 0)):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(max(reps, 1)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(_BUSY_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# candidates
# ---------------------------------------------------------------------------

def _candidates(op: str, idx_size: int, num_segments: int, feat: int,
                max_configs: int, io_dtype: str = "float32"
                ) -> List[KernelConfig]:
    """The rules' pick and the shipped values first (so the winner is never
    worse than either on the measured inputs), then the lattice, deduped
    by the op's projection and capped at ``max_configs``."""
    from repro_torch.core.config_space import enumerate_configs
    from repro_torch.core.heuristics import hand_crafted_config, select_config
    seeds = [select_config(idx_size, num_segments, feat, op=op, tune=False),
             hand_crafted_config(idx_size, num_segments, feat)]
    out: List[KernelConfig] = []
    seen = set()
    for cfg in seeds + list(enumerate_configs(feat, io_dtype)):
        pk = config_projection(op, cfg)
        if pk in seen:
            continue
        seen.add(pk)
        out.append(cfg)
        if len(out) >= max_configs:
            break
    return out


# ---------------------------------------------------------------------------
# tune
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TuneResult:
    """Outcome of one :func:`tune` call (fresh sweep or cache hit)."""
    op: str
    backend: str
    key: str
    config: KernelConfig                    # the measured winner
    timings: Dict[Tuple, float]             # projection -> median µs
    timings_performed: int                  # 0 on a warm-cache hit
    cache_hit: bool

    def time_of(self, cfg: KernelConfig) -> Optional[float]:
        """Measured µs of ``cfg`` in this sweep (None if not swept)."""
        return self.timings.get(config_projection(self.op, cfg))


def _entry_to_result(op: str, backend: str, key: str,
                     entry: dict) -> TuneResult:
    timings = {config_projection(op, KernelConfig(*t["config"])): t["us"]
               for t in entry["timings"]}
    return TuneResult(op=op, backend=backend, key=key,
                      config=KernelConfig(*entry["best"]), timings=timings,
                      timings_performed=0, cache_hit=True)


def _features(idx_size, num_segments, feat, io_dtype) -> InputFeatures:
    from repro_torch.core.config_space import io_dtype_bytes
    return InputFeatures(int(idx_size), int(num_segments), int(feat),
                         dtype_bytes=io_dtype_bytes(io_dtype))


def lookup(op: str, *, idx_size: int, num_segments: int, feat: int,
           db: Optional[PerfDB] = None, io_dtype: str = "float32"
           ) -> Optional[KernelConfig]:
    """The measured winner of ``op`` at a shape class on this card, or
    None: a lookup only, never a sweep. None without a card."""
    backend = current_backend()
    if backend is None:
        return None
    key = perf_key(backend, op,
                   _features(idx_size, num_segments, feat, io_dtype))
    entry = _db(db).get(key)
    return None if entry is None else KernelConfig(*entry["best"])


def tune(op: str = "segment_reduce", *, idx_size: int, num_segments: int,
         feat: int, db: Optional[PerfDB] = None,
         max_configs: Optional[int] = None, reps: Optional[int] = None,
         warmup: Optional[int] = None, force: bool = False,
         seed: int = DEFAULT_SEED, io_dtype: str = "float32",
         d_out: Optional[int] = None,
         measure_fn: Optional[Callable[[KernelConfig], float]] = None
         ) -> TuneResult:
    """Measure the candidates of one (op, shape class) on the card; cache.

    A warm PerfDB entry returns with ``timings_performed == 0`` and no
    launch. On a miss every candidate is held against the plain version
    (a disagreement raises) and timed (median of ``reps`` CUDA
    event timings after ``warmup`` calls) on seeded synthetic inputs, and
    the sweep is stored. ``measure_fn`` (``cfg -> µs``) replaces the
    timing (tests); the shelf is the card's, else ``"measure_fn"``.
    Without a card and without ``measure_fn`` it raises: there is no CPU
    sweep.
    ``d_out`` is the fused kernel's output width (``feat`` by default); it
    is stored in the entry but is not part of the key."""
    if op not in _OPS:
        raise ValueError(f"unknown op {op!r}; tunable: {sorted(_OPS)}")
    backend = current_backend() or (
        "measure_fn" if measure_fn is not None else None)
    if backend is None:
        raise RuntimeError("autotune: measuring needs a CUDA card (there is "
                           "no CPU sweep); pass measure_fn= to score "
                           "candidates another way")
    feats = _features(idx_size, num_segments, feat, io_dtype)
    key = perf_key(backend, op, feats)
    db = _db(db)

    from repro_torch import obs

    if not force:
        entry = db.get(key)
        if entry is not None:
            obs.record_tune(op, cache_hit=True, key=key, backend=backend)
            return _entry_to_result(op, backend, key, entry)

    if max_configs is None:
        max_configs = int(os.environ.get("REPRO_AUTOTUNE_MAX_CONFIGS",
                                         str(DEFAULT_MAX_CONFIGS)))
    reps = (int(os.environ.get("REPRO_AUTOTUNE_REPS", str(DEFAULT_REPS)))
            if reps is None else reps)
    warmup = DEFAULT_WARMUP if warmup is None else warmup
    cands = _candidates(op, int(idx_size), int(num_segments), int(feat),
                        max_configs, io_dtype)
    if measure_fn is None:
        runner = make_runner(op, int(idx_size), int(num_segments), int(feat),
                             seed=seed, io_dtype=io_dtype, d_out=d_out)
        want = runner.plain()

        def measure_fn(cfg: KernelConfig) -> float:
            check_output(f"autotune {op} {config_projection(op, cfg)}",
                         runner.call(cfg), want, runner.dtype)
            return _median_us(lambda: runner.call(cfg), reps, warmup)

    swept: List[Tuple[KernelConfig, float]] = []
    with obs.span("autotune.tune", op=op, key=key, candidates=len(cands)):
        for cfg in cands:
            swept.append((cfg, float(measure_fn(cfg))))

    best_cfg, _ = min(swept, key=lambda cu: cu[1])
    entry = {
        "op": op,
        "backend": backend,
        "features": list(quantize_features(feats)),
        "idx_size": int(idx_size),
        "num_segments": int(num_segments),
        "feat": int(feat),
        "io_dtype": io_dtype,
        "reps": reps,
        "warmup": warmup,
        "seed": seed,
        "best": list(best_cfg.astuple()),
        "timings": [{"config": list(c.astuple()), "us": u} for c, u in swept],
    }
    if d_out is not None:
        entry["d_out"] = int(d_out)
    db.put(key, entry)
    obs.record_tune(op, cache_hit=False, timings=len(swept), key=key,
                    backend=backend, best=list(best_cfg.astuple()))
    return TuneResult(op=op, backend=backend, key=key, config=best_cfg,
                      timings={config_projection(op, c): u for c, u in swept},
                      timings_performed=len(swept), cache_hit=False)

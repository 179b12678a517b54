"""Fault tolerance for the training loop: the reference's host-side
machinery (``repro/distributed/fault_tolerance.py``), copied into the port
so that it imports nothing of the JAX package.

Pieces (all host-side, framework-agnostic, unit-tested):
  StragglerMonitor   — rolling step-time stats; flags steps > factor × p50
                       and recommends action after repeated offences.
  StepWatchdog       — hard wall-clock deadline per step (a hung collective
                       on a dead node looks like an infinite step).
  ResilientLoop      — runs steps, checkpoints every K, and on failure
                       restores the latest complete checkpoint and replays.
                       Deterministic data (seeded per step) makes replay
                       exact. `max_restarts` bounds crash loops.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Optional

from repro_torch.checkpoint import checkpoint as ckpt


class StragglerMonitor:
    def __init__(self, factor: float = 3.0, window: int = 50,
                 tolerance: int = 3):
        self.factor = factor
        self.window = window
        self.tolerance = tolerance
        self.times: list[float] = []
        self.offences = 0

    def record(self, duration_s: float) -> dict:
        self.times.append(duration_s)
        if len(self.times) > self.window:
            self.times.pop(0)
        med = sorted(self.times)[len(self.times) // 2]
        is_straggler = (len(self.times) >= 5
                        and duration_s > self.factor * med)
        self.offences = self.offences + 1 if is_straggler else 0
        return {
            "median_s": med,
            "is_straggler": is_straggler,
            # repeated stragglers ⇒ a sick node: re-shard / evict, don't wait
            "action": ("evict" if self.offences >= self.tolerance
                       else "warn" if is_straggler else "ok"),
        }


class StepTimeout(RuntimeError):
    pass


class StepWatchdog:
    """Hard deadline around a blocking step call.

    A timed-out step's thread cannot be killed (Python offers no such
    primitive) — it keeps running until the blocking call returns. The
    watchdog *tracks* every such thread instead of dropping it on the
    floor: :meth:`reap` joins the ones that have since finished and
    reports how many are still alive, and each :meth:`run` reaps first,
    so a long-lived loop cannot accumulate unobserved zombie threads.
    """

    def __init__(self, timeout_s: float):
        self.timeout_s = timeout_s
        self._timed_out: list[threading.Thread] = []

    def reap(self) -> int:
        """Join finished timed-out threads; return the count still alive."""
        still = []
        for th in self._timed_out:
            th.join(0)
            if th.is_alive():
                still.append(th)
        self._timed_out = still
        return len(still)

    def run(self, fn: Callable[[], Any]) -> Any:
        self.reap()
        result: list = []
        error: list = []

        def target():
            try:
                result.append(fn())
            except BaseException as e:  # noqa: BLE001 — propagated below
                error.append(e)

        th = threading.Thread(target=target, daemon=True)
        th.start()
        th.join(self.timeout_s)
        if th.is_alive():
            self._timed_out.append(th)
            raise StepTimeout(f"step exceeded {self.timeout_s}s deadline")
        if error:
            raise error[0]
        return result[0]


@dataclasses.dataclass
class ResilientLoopConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    max_restarts: int = 3
    step_timeout_s: Optional[float] = None
    straggler_factor: float = 3.0


class ResilientLoop:
    """Checkpoint/restart training loop with failure replay.

    step_fn(state, step:int) -> (state, metrics); state is any tree the
    checkpoint module takes (params, optimizer state, ...). Data must be
    derivable from the step index, so replay after restore is exact.

    ``entry``: a zero-argument callable that rebuilds the state a run
    entered with, for a step_fn that updates its state in place (the
    port's trainer); None keeps that state itself, as the reference
    does."""

    def __init__(self, cfg: ResilientLoopConfig, step_fn, init_state,
                 entry: Optional[Callable[[], Any]] = None):
        self.cfg = cfg
        self.step_fn = step_fn
        self.state = init_state
        self.entry = entry
        self.monitor = StragglerMonitor(cfg.straggler_factor)
        self.restarts = 0
        self.events: list[tuple] = []

    def _restore(self, failed_step: int, entry_state, entry_step: int):
        """Roll back to the newest checkpoint **at or before** the failed
        step. A newer checkpoint (stale steps from an earlier run sharing
        the directory) would jump the loop past its failure point with
        foreign state. With no eligible checkpoint, fall back to the
        state the run entered with."""
        latest = (ckpt.latest_step(self.cfg.ckpt_dir,
                                   at_or_before=failed_step)
                  if self.cfg.ckpt_dir else None)
        if latest is None or latest < entry_step:
            self.state = entry_state()
            self.events.append(("restored_entry", entry_step))
            return entry_step
        self.state = ckpt.restore(self.state, self.cfg.ckpt_dir, step=latest)
        self.events.append(("restored", latest))
        return latest

    def run(self, num_steps: int, start_step: int = 0,
            metrics_cb: Optional[Callable] = None):
        step = start_step
        # _restore's no-checkpoint fallback
        entry_state = self.entry or (lambda state=self.state: state)
        watchdog = (StepWatchdog(self.cfg.step_timeout_s)
                    if self.cfg.step_timeout_s else None)
        while step < num_steps:
            try:
                t0 = time.monotonic()
                if watchdog:
                    self.state, metrics = watchdog.run(
                        lambda: self.step_fn(self.state, step))
                else:
                    self.state, metrics = self.step_fn(self.state, step)
                dt = time.monotonic() - t0
                verdict = self.monitor.record(dt)
                if verdict["action"] == "evict":
                    self.events.append(("straggler_evict", step))
                    self.monitor.offences = 0
                if metrics_cb:
                    metrics_cb(step, metrics, verdict)
                step += 1
                if self.cfg.ckpt_dir and step % self.cfg.ckpt_every == 0:
                    ckpt.save(self.state, self.cfg.ckpt_dir, step,
                              keep=self.cfg.keep)
                    self.events.append(("saved", step))
            except (StepTimeout, RuntimeError, ValueError) as e:
                self.restarts += 1
                self.events.append(("failure", step, repr(e)))
                if self.restarts > self.cfg.max_restarts:
                    raise
                step = self._restore(step, entry_state, start_step)
        if watchdog:
            watchdog.reap()
        return self.state

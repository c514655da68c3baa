"""Fault-tolerance runtime: straggler watchdog and restart orchestration
(copy of `repro.runtime.fault`, pure Python).

At 1000+ nodes the common failures are (a) a host dying (handled by
checkpoint/restart, see checkpoint/manager.py) and (b) stragglers, hosts
that silently run 2-10x slow (thermal, ECC, network). The watchdog keeps
an EWMA of step times and flags outliers; the driver's response is
configurable (log, skip-ahead via the data pipeline, or
checkpoint-and-halt so the scheduler can replace the host).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional


@dataclasses.dataclass
class StragglerReport:
    step: int
    step_time: float
    ewma: float
    ratio: float


class StragglerWatchdog:
    def __init__(self, threshold: float = 2.0, alpha: float = 0.1,
                 warmup_steps: int = 5,
                 on_straggler: Optional[Callable] = None):
        self.threshold = threshold
        self.alpha = alpha
        self.warmup_steps = warmup_steps
        self.on_straggler = on_straggler
        self.ewma: Optional[float] = None
        self.count = 0
        self.flagged: list = []
        self._t0: Optional[float] = None

    def start_step(self):
        self._t0 = time.monotonic()

    def end_step(self, step: int) -> Optional[StragglerReport]:
        if self._t0 is None:
            raise RuntimeError("start_step not called")
        dt = time.monotonic() - self._t0
        self._t0 = None
        return self.observe(step, dt)

    def observe(self, step: int, dt: float) -> Optional[StragglerReport]:
        self.count += 1
        if self.ewma is None:
            self.ewma = dt
            return None
        report = None
        if self.count > self.warmup_steps and dt > self.threshold * self.ewma:
            report = StragglerReport(step, dt, self.ewma, dt / self.ewma)
            self.flagged.append(report)
            if self.on_straggler is not None:
                self.on_straggler(report)
        # EWMA update excludes flagged outliers (keep the baseline clean)
        if report is None:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return report


class RestartPolicy:
    """Crash-recovery driver logic: how far to restart, when to give up."""

    def __init__(self, max_restarts: int = 3, backoff_s: float = 1.0):
        self.max_restarts = max_restarts
        self.backoff_s = backoff_s
        self.restarts = 0

    def should_restart(self, exc: BaseException) -> bool:
        if self.restarts >= self.max_restarts:
            return False
        self.restarts += 1
        time.sleep(self.backoff_s * self.restarts)
        return True

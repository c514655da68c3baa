"""Queue-depth-driven autoscaling of the fleet's engine count (copy of
`repro.serving.fleet.autoscale`).

The controller is a pure hysteresis loop over one observable — mean
queue depth per accepting engine (router backlog + per-engine queued +
busy slots, over slot capacity).  It recommends +1 / -1 / 0; the router
owns the mechanism (activating a parked engine, draining one for
removal).  Keeping the decision side effect free makes the hysteresis
behaviour directly unit-testable: feed a synthetic load series, assert
the scale events.

A scale-down drains the chosen engine *immediately* through the fault
layer's migration path (`FleetRouter._evacuate_handle`): queued work
re-routes with original arrivals, in-flight slots migrate to the
survivors by teacher-forced refill, and the engine parks with its page
pool verified fully free — rather than lingering half-occupied until
its slowest slot finishes.

Hysteresis has three guards against flapping:

* watermarks — scale up only above ``high_watermark`` occupancy,
  down only below ``low_watermark``;
* patience — the watermark must hold for ``up_patience`` /
  ``down_patience`` *consecutive* observations;
* cooldown — after any scale event, ``cooldown`` observations must
  pass before the next one.
"""
from __future__ import annotations

import dataclasses

__all__ = ["AutoscaleConfig", "Autoscaler"]


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    min_engines: int = 1
    max_engines: int = 4
    high_watermark: float = 1.5   # queue depth per slot: scale up above
    low_watermark: float = 0.25   # scale down below
    up_patience: int = 2          # consecutive high observations needed
    down_patience: int = 4        # consecutive low observations needed
    cooldown: int = 3             # observations to sit out after an event

    def __post_init__(self) -> None:
        if not 1 <= self.min_engines <= self.max_engines:
            raise ValueError("need 1 <= min_engines <= max_engines")
        if self.low_watermark >= self.high_watermark:
            raise ValueError("low_watermark must be < high_watermark")


class Autoscaler:
    """Feed ``observe(occupancy, n_engines)`` once per router epoch;
    it returns the recommended delta in {-1, 0, +1}."""

    def __init__(self, cfg: AutoscaleConfig) -> None:
        self.cfg = cfg
        self._high_streak = 0
        self._low_streak = 0
        self._cooldown = 0
        self.ups = 0
        self.downs = 0

    def observe(self, occupancy: float, n_engines: int) -> int:
        c = self.cfg
        if occupancy >= c.high_watermark:
            self._high_streak += 1
            self._low_streak = 0
        elif occupancy <= c.low_watermark:
            self._low_streak += 1
            self._high_streak = 0
        else:
            self._high_streak = 0
            self._low_streak = 0
        if self._cooldown > 0:
            self._cooldown -= 1
            return 0
        if (self._high_streak >= c.up_patience
                and n_engines < c.max_engines):
            self._high_streak = 0
            self._cooldown = c.cooldown
            self.ups += 1
            return +1
        if (self._low_streak >= c.down_patience
                and n_engines > c.min_engines):
            self._low_streak = 0
            self._cooldown = c.cooldown
            self.downs += 1
            return -1
        return 0

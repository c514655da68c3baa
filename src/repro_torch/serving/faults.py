"""Deterministic, seedable fault injection for the serving fleet (copy of
`repro.serving.faults`, numpy only).

A :class:`FaultPlan` is a frozen description of WHAT goes wrong and
WHEN; a :class:`FaultInjector` is the runtime that engines, the
substrate and the router consult at the named fault sites.  Every
stochastic decision (does THIS transfer fail?) is drawn from a
counter-indexed Philox stream keyed on ``(plan.seed, site)``, so a
chaos run is a pure function of the plan — replaying the same plan
over the same trace reproduces every failure at the same site, in the
same order, regardless of how other sites interleave.  That is what
makes the chaos bit-parity gate testable at all: the recovered run is
deterministic, so its tokens can be compared bit-for-bit against the
fault-free run.

An injected transfer failure is a virtual retry: the stream is issued
once, as on a fault-free run, and only the ledger and the virtual
clock see the failed attempts. It never stands in for a real error:
a failed kernel build, launch or host mapping raises as it would
without a plan.

Fault sites (each opt-in via a plan field; ``FaultPlan()`` is a no-op):

``transfer``   — substrate ``page_out``/``page_in`` stream issues and
                 prefill->decode handoff copies fail with probability
                 ``transfer_fail_rate``; the caller retries with
                 bounded exponential backoff (``backoff_base_s``
                 doubling per attempt up to ``backoff_cap_s``, at most
                 ``max_retries`` retries before the fault is
                 re-raised as fatal), logging every retry in the
                 owning ledger.
``kill``       — engine ``kill_engine`` stops responding permanently
                 once it has taken ``kill_at_step`` decode steps; the
                 router's watchdog declares it dead and recovers its
                 queued + in-flight requests.
``stall``      — engine ``stall_engine`` freezes for ``stall_s`` of
                 virtual time at decode step ``stall_at_step``; a
                 stall longer than the router watchdog is
                 indistinguishable from a kill and is recovered the
                 same way.
``shrink``     — engine ``shrink_engine``'s local page budget is
                 multiplied by ``shrink_frac`` at step
                 ``shrink_at_step`` (a pool-pressure spike: the
                 hotness rebalancer demotes pages to the pool tier to
                 fit the new budget).
``pool_lost``  — engine ``lose_pool_engine`` loses its pool tier at
                 step ``lose_pool_at_step`` and enters degraded mode:
                 all live pages promote to the local tier, the
                 substrate drains its twin, and admission tightens
                 through the existing corridor budget.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Optional

import numpy as np

__all__ = ["FaultPlan", "FaultInjector", "PLANS", "make_plan"]


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Immutable chaos schedule. All sites default off; seed pins the
    per-site Philox streams so the run is exactly replayable."""

    seed: int = 0
    # --- transfer flaking (substrate streams + handoff copies) ---
    transfer_fail_rate: float = 0.0
    max_retries: int = 8
    backoff_base_s: float = 1e-4
    backoff_cap_s: float = 2e-2
    # --- engine kill / stall ---
    kill_engine: Optional[int] = None
    kill_at_step: int = 0
    stall_engine: Optional[int] = None
    stall_at_step: int = 0
    stall_s: float = 0.0
    # --- pool-pressure spike / pool-tier loss ---
    shrink_engine: Optional[int] = None
    shrink_at_step: int = 0
    shrink_frac: float = 0.5
    lose_pool_engine: Optional[int] = None
    lose_pool_at_step: int = 0

    def __post_init__(self) -> None:
        if not 0.0 <= self.transfer_fail_rate < 1.0:
            raise ValueError("transfer_fail_rate must be in [0, 1)")
        if self.max_retries < 1:
            raise ValueError("max_retries must be >= 1")
        if not 0.0 < self.shrink_frac <= 1.0:
            raise ValueError("shrink_frac must be in (0, 1]")

    @property
    def active(self) -> bool:
        return (self.transfer_fail_rate > 0.0
                or self.kill_engine is not None
                or self.stall_engine is not None
                or self.shrink_engine is not None
                or self.lose_pool_engine is not None)


class FaultInjector:
    """Runtime oracle for a :class:`FaultPlan`.

    One injector is shared by every engine/substrate in a fleet run
    (the router builds it); per-site draw streams are independent, so
    the order in which sites consult the injector never perturbs
    another site's sequence of outcomes.
    """

    def __init__(self, plan: FaultPlan) -> None:
        self.plan = plan
        self._streams: Dict[str, np.random.Generator] = {}
        # observability: how many failures each site injected
        self.injected: Dict[str, int] = {}

    def _stream(self, site: str) -> np.random.Generator:
        gen = self._streams.get(site)
        if gen is None:
            key = [self.plan.seed & 0xFFFFFFFF, zlib.crc32(site.encode())]
            gen = np.random.Generator(np.random.Philox(key=key))
            self._streams[site] = gen
        return gen

    # ------------------------------------------------------ transfer
    def transfer_fails(self, site: str) -> bool:
        """One Bernoulli draw from `site`'s private stream: does the
        next transfer attempt at this site fail?"""
        if self.plan.transfer_fail_rate <= 0.0:
            return False
        fail = bool(self._stream(site).random()
                    < self.plan.transfer_fail_rate)
        if fail:
            self.injected[site] = self.injected.get(site, 0) + 1
        return fail

    def backoff_s(self, attempt: int) -> float:
        """Exponential backoff charged to the virtual clock for retry
        `attempt` (1-based)."""
        return min(self.plan.backoff_base_s * (2.0 ** (attempt - 1)),
                   self.plan.backoff_cap_s)

    # ----------------------------------------------------- lifecycle
    def kill_now(self, engine_id: int, step: int) -> bool:
        return (self.plan.kill_engine == engine_id
                and step >= self.plan.kill_at_step)

    def stall_now(self, engine_id: int, step: int) -> Optional[float]:
        """Stall duration if this engine stalls at this step (consumed:
        fires at most once), else None."""
        if (self.plan.stall_engine == engine_id
                and step >= self.plan.stall_at_step
                and "stall" not in self.injected):
            self.injected["stall"] = 1
            return self.plan.stall_s
        return None

    # -------------------------------------------------- pool budgets
    def shrink_now(self, engine_id: int, step: int) -> Optional[float]:
        """Budget multiplier if the shrink site fires here (consumed),
        else None."""
        if (self.plan.shrink_engine == engine_id
                and step >= self.plan.shrink_at_step
                and "shrink" not in self.injected):
            self.injected["shrink"] = 1
            return self.plan.shrink_frac
        return None

    def pool_lost_now(self, engine_id: int, step: int) -> bool:
        """True once when the pool tier drops out from under this
        engine (consumed)."""
        if (self.plan.lose_pool_engine == engine_id
                and step >= self.plan.lose_pool_at_step
                and "pool_lost" not in self.injected):
            self.injected["pool_lost"] = 1
            return True
        return False

    def counters(self) -> Dict[str, int]:
        return dict(self.injected)


# Named plans for CLI/CI lanes (`dev_serve_torch.py --fault-plan NAME`).
PLANS: Dict[str, FaultPlan] = {
    # no-op plan: every site off — a chaos run under "none" must be
    # byte-identical to a run with no injector wired at all
    "none": FaultPlan(),
    # the acceptance-criteria plan: one of two fleet engines killed
    # mid-decode while substrate transfers flake at 10%
    "chaos_smoke": FaultPlan(seed=0, transfer_fail_rate=0.10,
                             kill_engine=1, kill_at_step=3),
    # pure link flaking, no engine loss — isolates the retry path
    "transfer_flake": FaultPlan(seed=0, transfer_fail_rate=0.25),
}


def make_plan(name: str) -> FaultPlan:
    try:
        return PLANS[name]
    except KeyError:
        raise ValueError(f"unknown fault plan {name!r}; choose from "
                         f"{', '.join(sorted(PLANS))}") from None

"""Pluggable placement policies for the rack-scale simulator (copy of
`repro.sched.policies`).

All policies implement the `Policy` protocol: given a job, the cluster and
the simulation clock, return the pool to place it on (or None to leave it
queued). Policies only see submission-time metrics (injected LoI, IC,
sensitivity curve) — never the future of the trace — matching the paper's
§7.2 proposal of shipping the level-3 metrics to the resource manager.

  fcfs     — first open pool in id order; the no-information baseline.
  random   — uniformly random open pool; the paper's Fig 13 baseline.
  aware    — interference-aware (paper §7.2): minimize predicted marginal
             slowdown — the job's own degradation at the pool's current
             LoI plus the degradation it inflicts on the residents.
  binpack  — pool-aware best-fit-decreasing on the R_bw corridor: each
             pool has an aggregate injected-LoI budget (its share of link
             bandwidth it can absorb before queueing explodes); place the
             job in the open pool with the smallest nonnegative headroom
             after placement, falling back to max headroom when nothing
             fits the corridor.
"""

from __future__ import annotations

from typing import List, Optional, Protocol, runtime_checkable

import numpy as np

from repro_torch.core.interference import corridor_budget
from repro_torch.sched.cluster import Cluster, Pool


@runtime_checkable
class Policy(Protocol):
    name: str

    def select(self, job, cluster: Cluster, now: float) -> Optional[Pool]:
        """Pick an open pool for `job`, or None to keep it queued."""
        ...

    def reset(self) -> None:
        """Clear per-run state (e.g. reseed the rng) before a fresh run."""
        ...


class FCFSPolicy:
    """First open pool in id order (packs the cluster front to back)."""

    name = "fcfs"

    def select(self, job, cluster: Cluster, now: float) -> Optional[Pool]:
        for p in cluster.pools:
            if p.is_open:
                return p
        return None

    def reset(self) -> None:
        pass


class RandomPolicy:
    """Uniformly random open pool — the paper's baseline scheduler."""

    name = "random"

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rng = np.random.default_rng(seed)

    def select(self, job, cluster: Cluster, now: float) -> Optional[Pool]:
        open_pools = cluster.open_pools()
        if not open_pools:
            return None
        return open_pools[int(self.rng.integers(len(open_pools)))]

    def reset(self) -> None:
        self.rng = np.random.default_rng(self.seed)


def marginal_colocation_cost(pool, job) -> float:
    """Predicted marginal slowdown of adding `job` to `pool`: the job's
    own degradation at the pool's current aggregate LoI plus the increase
    in every resident's degradation once the job's injected LoI joins the
    link. Duck-typed over both the rack-scale `cluster.Pool` and the toy
    `scheduler.Pool` (needs `pool.jobs` + `pool.background_loi_for`, and
    `.injected_loi` / `.sensitivity` on jobs)."""
    bg_for_new = pool.background_loi_for(job)   # job is not resident yet
    cost = 1.0 / max(job.sensitivity(bg_for_new), 1e-6) - 1.0
    for res in pool.jobs:
        bg_now = pool.background_loi_for(res)
        bg_with = min(1.0, bg_now + job.injected_loi)
        cost += (
            1.0 / max(res.sensitivity(bg_with), 1e-6)
            - 1.0 / max(res.sensitivity(bg_now), 1e-6)
        )
    return cost


class InterferenceAwarePolicy:
    """Greedy minimum-marginal-slowdown placement (paper §7.2).

    Uses `marginal_colocation_cost`: high-IC jobs steer away from pools
    holding high-sensitivity residents and vice versa.
    """

    name = "aware"

    def select(self, job, cluster: Cluster, now: float) -> Optional[Pool]:
        open_pools = cluster.open_pools()
        if not open_pools:
            return None
        return min(open_pools,
                   key=lambda p: marginal_colocation_cost(p, job))

    def reset(self) -> None:
        pass


class CorridorBinPackPolicy:
    """Best-fit bin-packing on the pool's bandwidth corridor.

    The corridor budget is the aggregate injected LoI a pool link absorbs
    before M/D/1 queueing departs the linear regime. It is DERIVED from the
    pool topology by `core.interference.corridor_budget` — the M/D/1 knee
    utilization discounted by `TierTopology.r_bw_pool` (the port's H100
    topology by default; ~0.59 on the reference's emulated v5e pool) —
    rather than hard-coded; pass `loi_budget` to override (trace studies
    / tests). Placement is classic best-fit: the
    open pool whose post-placement headroom is smallest but still
    nonnegative; if the job fits no corridor, the pool with maximum
    headroom (least overflow) — capacity corridors (R_cap) are enforced by
    the node-slot capacity itself.
    """

    name = "binpack"

    def __init__(self, loi_budget: Optional[float] = None, topo=None):
        self.loi_budget = (
            loi_budget if loi_budget is not None else corridor_budget(topo)
        )

    def select(self, job, cluster: Cluster, now: float) -> Optional[Pool]:
        open_pools = cluster.open_pools()
        if not open_pools:
            return None
        headrooms = [
            self.loi_budget - p.total_injected_loi() - job.injected_loi
            for p in open_pools
        ]
        fitting = [(h, i) for i, h in enumerate(headrooms) if h >= 0.0]
        if fitting:
            _, idx = min(fitting)           # tightest fit
        else:
            idx = int(np.argmax(headrooms))  # least overflow
        return open_pools[idx]

    def reset(self) -> None:
        pass


def make_policy(name: str, *, seed: int = 0, **kwargs) -> Policy:
    """Factory used by benchmarks/CLI: fcfs | random | aware | binpack."""
    table = {
        "fcfs": lambda: FCFSPolicy(),
        "random": lambda: RandomPolicy(seed=seed),
        "aware": lambda: InterferenceAwarePolicy(),
        "binpack": lambda: CorridorBinPackPolicy(**kwargs),
    }
    if name not in table:
        raise ValueError(f"unknown policy {name!r}; one of {sorted(table)}")
    return table[name]()


DEFAULT_POLICIES: List[str] = ["fcfs", "random", "aware", "binpack"]

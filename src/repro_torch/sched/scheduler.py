"""Interference-aware job scheduling (paper §7.2; copy of
`repro.sched.scheduler`).

Jobs carry the two level-3 metrics from core.interference — sensitivity
profile and interference coefficient (supplied "at job submission", as the
paper proposes for SLURM). Pools (one per host group) are the contention
domains. The interference-aware scheduler avoids co-locating high-IC jobs
with high-sensitivity jobs on the same pool; the random scheduler is the
paper's baseline.

`simulate_colocation` reproduces the paper's Fig 13 experiment: each
workload runs many times against a background whose LoI changes randomly
every interval; the aware scheduler caps the background range (0-20% vs
0-50%) by keeping loud neighbours away.

This module is the single-pool toy. The rack-scale, event-driven version —
where the background LoI is derived from actual co-residents instead of
assumed — lives in `repro_torch.sched.simulator` (+ `cluster`, `policies`,
`workload`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.core.interference import InterferenceProfile


@dataclasses.dataclass
class Job:
    name: str
    profile: InterferenceProfile
    steps: int = 100

    @property
    def ic(self) -> float:
        return self.profile.interference_coefficient()

    @property
    def injected_loi(self) -> float:
        return self.profile.injected_loi()

    def sensitivity(self, loi: float) -> float:
        return self.profile.sensitivity(loi)


@dataclasses.dataclass
class Pool:
    pool_id: int
    capacity: int                     # jobs per pool (nodes per rack)
    jobs: list = dataclasses.field(default_factory=list)

    def background_loi_for(self, job: Job) -> float:
        return min(1.0, sum(j.injected_loi for j in self.jobs if j is not job))


class RandomScheduler:
    """Paper baseline: first-fit in arrival order (no interference info)."""

    def __init__(self, n_pools: int, capacity: int, seed: int = 0):
        self.pools = [Pool(i, capacity) for i in range(n_pools)]
        self.rng = np.random.default_rng(seed)

    def place(self, job: Job) -> Optional[Pool]:
        open_pools = [p for p in self.pools if len(p.jobs) < p.capacity]
        if not open_pools:
            return None
        p = open_pools[self.rng.integers(len(open_pools))]
        p.jobs.append(job)
        return p


class InterferenceAwareScheduler:
    """Minimize predicted total slowdown: place each job on the pool where
    (its own degradation) + (degradation it inflicts on residents) is
    smallest. Uses only submission-time metrics (IC + sensitivity), per the
    paper's proposal."""

    def __init__(self, n_pools: int, capacity: int):
        self.pools = [Pool(i, capacity) for i in range(n_pools)]

    def place(self, job: Job) -> Optional[Pool]:
        from repro_torch.sched.policies import marginal_colocation_cost

        open_pools = [p for p in self.pools if len(p.jobs) < p.capacity]
        if not open_pools:
            return None
        best = min(open_pools,
                   key=lambda p: marginal_colocation_cost(p, job))
        best.jobs.append(job)
        return best

    def place_all(self, jobs) -> bool:
        """Batch mode: place loudest jobs first so they spread across pools
        before the sensitive ones choose their neighbours (greedy-online is
        myopic under arbitrary arrival order)."""
        ordered = sorted(jobs, key=lambda j: -j.injected_loi)
        return all(self.place(j) is not None for j in ordered)


def simulate_colocation(
    job: Job,
    n_runs: int = 100,
    *,
    loi_range: tuple[float, float] = (0.0, 0.5),
    interval_steps: int = 60,
    seed: int = 0,
) -> np.ndarray:
    """Paper Fig 13: run `job` n_runs times; background LoI resampled
    uniformly from loi_range every `interval_steps` steps. Returns total
    runtimes (seconds)."""
    rng = np.random.default_rng(seed)
    base = job.profile.step_time(0.0)
    runtimes = np.empty(n_runs)
    for r in range(n_runs):
        t = 0.0
        steps_left = job.steps
        while steps_left > 0:
            chunk = min(interval_steps, steps_left)
            loi = rng.uniform(*loi_range)
            t += chunk * base / max(job.sensitivity(loi), 1e-6)
            steps_left -= chunk
        runtimes[r] = t
    return runtimes


def five_number_summary(x: np.ndarray) -> dict:
    return {
        "min": float(np.min(x)),
        "p25": float(np.percentile(x, 25)),
        "median": float(np.median(x)),
        "p75": float(np.percentile(x, 75)),
        "max": float(np.max(x)),
        "mean": float(np.mean(x)),
    }

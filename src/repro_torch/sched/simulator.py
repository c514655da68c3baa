"""Event-driven rack-scale co-location simulator (paper §7.2 at scale;
copy of `repro.sched.simulator`).

Event model
-----------
The simulator advances a continuous clock between two event kinds:

* **arrival** — the next job of the trace submits; the policy picks an
  open pool (or the job joins the FIFO backlog queue);
* **completion** — the running job with the earliest projected finish
  retires, freeing a node slot; backlogged jobs are then re-offered to
  the policy in FIFO order.

Between events nothing changes: each pool's membership — hence each
resident's background LoI (`core.interference.background_lois` over the
residents' injected LoI) and progress rate (`core.interference.
progress_rates`) — is constant, so each running job consumes its remaining
isolated work linearly at `rate = sensitivity(bg_loi)` ∈ (0, 1]. An event
only perturbs the pools it touches; rates are recomputed per affected pool
with vectorized numpy over that pool's residents, and the per-step
slowdown accounting is O(running jobs) per event. 10k-job traces simulate
in a couple of seconds.

Mapping to the paper: each run of a job between membership changes is one
Fig 13 "interval" — except the background LoI is not resampled from a
uniform range, it is *derived* from who the scheduler actually co-located
on the pool. The aware policy reproduces the paper's result (lower
variance, lower tail) as an emergent property instead of an assumed
0-20% LoI cap.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.interference import background_lois, progress_rates
from repro_torch.sched.cluster import Cluster, ClusterSpec
from repro_torch.sched.policies import Policy, make_policy
from repro_torch.sched.workload import TraceJob


@dataclasses.dataclass
class SimResult:
    """Per-job accounting (arrays are indexed like the input job list)."""

    policy: str
    arrival: np.ndarray
    start: np.ndarray
    finish: np.ndarray
    work: np.ndarray
    pool_of: np.ndarray          # pool id each job ran on
    peak_occupancy: np.ndarray   # per pool, max concurrent residents
    n_events: int

    @property
    def wait(self) -> np.ndarray:
        return self.start - self.arrival

    @property
    def slowdown(self) -> np.ndarray:
        """Service slowdown: observed runtime / isolated runtime (>= 1)."""
        return (self.finish - self.start) / self.work

    @property
    def stretch(self) -> np.ndarray:
        """End-to-end stretch including queueing delay."""
        return (self.finish - self.arrival) / self.work

    @property
    def makespan(self) -> float:
        return float(self.finish.max() - self.arrival.min())

    def summary(self) -> Dict[str, float]:
        s = self.slowdown
        return {
            "policy": self.policy,
            "n_jobs": int(len(self.work)),
            "mean_slowdown": float(s.mean()),
            "var_slowdown": float(s.var()),
            "p95_slowdown": float(np.percentile(s, 95)),
            "max_slowdown": float(s.max()),
            "mean_wait_s": float(self.wait.mean()),
            "mean_stretch": float(self.stretch.mean()),
            "makespan_s": self.makespan,
            "events": int(self.n_events),
        }


def simulate(jobs: Sequence[TraceJob], cluster: Cluster, policy: Policy,
             *, reset: bool = True) -> SimResult:
    """Run `jobs` (any order; sorted by arrival internally) through
    `cluster` under `policy`. Deterministic for a fixed (trace, policy
    seed) pair."""
    n = len(jobs)
    if n == 0:
        raise ValueError("empty trace")
    if cluster.total_capacity < 1:
        raise ValueError("cluster has no node slots")
    if reset:
        cluster.reset()
        policy.reset()

    arrival = np.array([j.arrival for j in jobs], dtype=np.float64)
    work = np.array([j.work for j in jobs], dtype=np.float64)
    inj = np.array([j.injected_loi for j in jobs], dtype=np.float64)
    t_pool = np.array([j.t_pool for j in jobs], dtype=np.float64)
    t_local = np.array([j.t_local for j in jobs], dtype=np.float64)
    t_comp = np.array([j.t_compute for j in jobs], dtype=np.float64)
    if np.any(work <= 0):
        raise ValueError("every job needs positive work")

    remaining = work.copy()
    rate = np.zeros(n)
    start = np.full(n, np.nan)
    finish = np.full(n, np.nan)
    pool_of = np.full(n, -1, dtype=np.int64)

    n_pools = len(cluster.pools)
    members: List[List[int]] = [[] for _ in range(n_pools)]
    peak_occ = np.zeros(n_pools, dtype=np.int64)

    order = list(np.argsort(arrival, kind="stable"))
    i_arr = 0
    running: List[int] = []
    backlog: collections.deque = collections.deque()
    now = 0.0
    done = 0
    n_events = 0

    def place(idx: int, pool, t: float) -> None:
        pool.add(jobs[idx])
        pid = pool.pool_id
        members[pid].append(idx)
        assert len(members[pid]) <= pool.capacity, "capacity overrun"
        peak_occ[pid] = max(peak_occ[pid], len(members[pid]))
        pool_of[idx] = pid
        start[idx] = t
        running.append(idx)

    def refresh_rates(pid: int) -> None:
        idx = members[pid]
        if not idx:
            return
        ia = np.asarray(idx, dtype=np.int64)
        bg = background_lois(inj[ia])
        rate[ia] = progress_rates(t_pool[ia], t_local[ia], t_comp[ia], bg)

    while done < n:
        t_arr = arrival[order[i_arr]] if i_arr < n else np.inf
        if running:
            ra = np.asarray(running, dtype=np.int64)
            t_fins = now + remaining[ra] / rate[ra]
            k = int(np.argmin(t_fins))
            t_fin, j_fin = float(t_fins[k]), int(ra[k])
        else:
            t_fin, j_fin = np.inf, -1
        if not np.isfinite(min(t_arr, t_fin)):
            raise RuntimeError(
                "deadlock: backlog non-empty but nothing runs or arrives"
            )

        t_next = min(t_arr, t_fin)
        if running and t_next > now:
            remaining[ra] = np.maximum(
                remaining[ra] - (t_next - now) * rate[ra], 0.0
            )
        now = t_next
        n_events += 1
        changed = set()

        if t_fin <= t_arr:                       # completion frees a slot
            remaining[j_fin] = 0.0
            finish[j_fin] = now
            pid = int(pool_of[j_fin])
            cluster.pool(pid).remove(jobs[j_fin])
            members[pid].remove(j_fin)
            running.remove(j_fin)
            done += 1
            changed.add(pid)
            # FIFO backlog re-offer (backfill-lite: any fitting job goes)
            still_queued = collections.deque()
            while backlog:
                q = backlog.popleft()
                pool = policy.select(jobs[q], cluster, now)
                if pool is not None and pool.is_open:
                    place(q, pool, now)
                    changed.add(pool.pool_id)
                else:
                    still_queued.append(q)
            backlog = still_queued
        else:                                    # arrival
            idx = order[i_arr]
            i_arr += 1
            pool = policy.select(jobs[idx], cluster, now)
            if pool is not None and pool.is_open:
                place(idx, pool, now)
                changed.add(pool.pool_id)
            else:
                backlog.append(idx)

        for pid in changed:
            refresh_rates(pid)

    assert not backlog and not running
    return SimResult(
        policy=policy.name,
        arrival=arrival, start=start, finish=finish, work=work,
        pool_of=pool_of, peak_occupancy=peak_occ, n_events=n_events,
    )


def run_policies(
    jobs: Sequence[TraceJob],
    spec: ClusterSpec,
    policy_names: Sequence[str] = ("fcfs", "random", "aware", "binpack"),
    *,
    seed: int = 0,
) -> Dict[str, SimResult]:
    """Run the same trace under several policies, each on a fresh cluster
    of the same topology."""
    out = {}
    for name in policy_names:
        cluster = Cluster.build(spec)
        out[name] = simulate(jobs, cluster, make_policy(name, seed=seed))
    return out

"""Job streams for the rack-scale simulator (copy of
`repro.sched.workload`: the same numpy draws from the same seed).

A `TraceJob` is a batch job the way the paper's §7.2 SLURM proposal sees
it: at submission time it carries its interference profile (sensitivity
curve + interference coefficient + injected LoI) computed by the
quantitative workflow — `core.quantify` for catalog models, or a synthetic
profile for trace studies. `work` is the job's isolated execution time
(steps x uncontended step time); the simulator stretches it by the
pool-contention slowdown while the job runs.

Two stream generators:

* `synthetic_stream` — fast (no per-job analysis, no model lowering):
  samples profiles across the paper's sensitivity quadrants
  (compute-bound HPL-likes through pool-bound Hypre-likes). 10k jobs
  build in milliseconds, so it backs the perf lane.
* `catalog_stream` — samples the model zoo in `repro_torch.configs`, computing
  each (arch, shape) profile once via `core.quantify.profile_for` and
  reusing it across arrivals (the profile IS per-workload metadata, not
  per-job).

Arrivals are a Poisson process (exponential interarrival times); service
demand is lognormal-ish via a step-count range, matching the open-system
traces used in the CXL-pooling studies (arXiv:2211.02682).

Profiles are priced on the port's H100 topology (`tiers.h100_topology`);
`catalog_stream` prices each cell with `profile_for`'s defaults (one
H100), its compute time from the port's dry-run record of the cell when
`use_dryrun` is set and one exists (`launch.dryrun`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core import tiers as tr
from repro_torch.core.interference import InterferenceProfile


@dataclasses.dataclass
class TraceJob:
    """One submitted job. Metrics are cached at submission (what a
    scheduler plugin would receive) so the hot simulation loop never calls
    back into the profile."""

    job_id: int
    name: str
    profile: InterferenceProfile
    arrival: float              # seconds since trace start
    work: float                 # isolated execution seconds
    # --- submission-time metrics (paper §7.2) ---
    injected_loi: float = dataclasses.field(init=False)
    ic: float = dataclasses.field(init=False)
    t_pool: float = dataclasses.field(init=False)
    t_local: float = dataclasses.field(init=False)
    t_compute: float = dataclasses.field(init=False)

    def __post_init__(self):
        self.injected_loi = self.profile.injected_loi()
        self.ic = self.profile.interference_coefficient()
        self.t_pool = self.profile.t_pool
        self.t_local = self.profile.t_local
        self.t_compute = self.profile.t_compute

    def sensitivity(self, loi: float) -> float:
        return self.profile.sensitivity(loi)


def synthetic_profile(pool_share: float, t_compute: float,
                      traffic: float = 1e9) -> InterferenceProfile:
    """A profile placed anywhere in the paper's Fig 10 sensitivity plane:
    `pool_share` of the per-step traffic crosses the pool link, the rest
    stays in HBM, against `t_compute` seconds of pure compute."""
    topo = tr.emulated(0.5, traffic)
    return InterferenceProfile(
        arch="synthetic", shape="trace",
        pool_traffic=traffic * pool_share,
        local_traffic=traffic * (1.0 - pool_share),
        t_compute=t_compute,
        topo=topo,
    )


def profile_with_injected_loi(r: float, pool_share: float = 0.5,
                              traffic: float = 1e9) -> InterferenceProfile:
    """A profile whose injected LoI is (approximately) `r` in (0, 1): the
    compute time is set to t_pool / r, so the job spends `r` of its step on
    the shared link. Its own sensitivity scales with the same `r` — a job
    that hammers the link is also exposed to it, the paper's injector-is-
    also-victim observation."""
    if not 0.0 < r <= 1.0:
        raise ValueError("injected LoI target must be in (0, 1]")
    topo = tr.emulated(0.5, traffic)
    t_pool = traffic * pool_share / topo.pool.bandwidth
    return InterferenceProfile(
        arch="synthetic", shape="trace",
        pool_traffic=traffic * pool_share,
        local_traffic=traffic * (1.0 - pool_share),
        t_compute=t_pool / r,
        topo=topo,
    )


def synthetic_stream(
    n_jobs: int,
    *,
    seed: int = 0,
    arrival_rate: float = 0.15,     # jobs/s; ~70% load on a 16-slot cluster
    runtime_median_s: float = 60.0,
    runtime_sigma: float = 0.6,
    loud_fraction: float = 0.3,
    loud_loi: tuple = (0.25, 0.6),
    quiet_loi: tuple = (0.01, 0.15),
) -> List[TraceJob]:
    """Mixed trace: ~`loud_fraction` link-heavy jobs (LBench-like
    injectors), the rest compute-bound — co-location policy only matters
    when some neighbours are loud and some are fragile. Isolated runtimes
    are lognormal around `runtime_median_s`; arrivals are Poisson.

    The default arrival rate offers ~70% utilization to the default
    2x2x4 cluster (16 slots / 60 s mean service), the regime where queues
    are short but pools really are shared.
    """
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / arrival_rate, size=n_jobs))
    jobs = []
    for i in range(n_jobs):
        if rng.uniform() < loud_fraction:
            r = rng.uniform(*loud_loi)              # Hypre/NekRS quadrant
        else:
            r = rng.uniform(*quiet_loi)             # HPL/XSBench quadrant
        pool_share = rng.uniform(0.3, 0.9)
        traffic = 10 ** rng.uniform(8.0, 9.5)
        prof = profile_with_injected_loi(r, pool_share, traffic)
        step0 = prof.step_time(0.0)
        target = runtime_median_s * np.exp(runtime_sigma * rng.normal())
        n_steps = max(1, int(round(target / step0)))
        jobs.append(TraceJob(
            job_id=i,
            name=f"job{i}",
            profile=prof,
            arrival=float(arrivals[i]),
            work=n_steps * step0,
        ))
    return jobs


def rescale_load(jobs: List[TraceJob], total_slots: int,
                 utilization: float = 0.7) -> List[TraceJob]:
    """Rescale arrival times in place so the offered load (total isolated
    work / available slot-seconds) is ~`utilization` — the regime where
    queues stay short but pools really are shared."""
    total_work = sum(j.work for j in jobs)
    span_needed = total_work / (total_slots * utilization)
    cur_span = max(j.arrival for j in jobs) or 1.0
    f = span_needed / cur_span
    for j in jobs:
        j.arrival *= f
    return jobs


def serving_stream(
    n_jobs: int,
    profile: InterferenceProfile,
    *,
    seed: int = 0,
    arrival_rate: float = 0.05,
    steps: tuple = (2_000, 20_000),
    name: Optional[str] = None,
) -> List[TraceJob]:
    """Serving instances as simulator jobs — the closed admission<->
    scheduler loop (ROADMAP): `profile` is the engine's MEASURED
    interference profile (`ServingEngine.measured_profile()`, per-step
    pool/local bytes from the pager's exact accounting), so a fleet of
    co-located serving jobs throttles each other in the simulator by the
    LoI each one actually injects — not a catalog prior. `steps` is the
    decode-step count range per instance (long-lived, decode-dominated
    services); isolated work prices each step at the profile's
    uncontended step time.
    """
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / arrival_rate, size=n_jobs))
    step0 = profile.step_time(0.0)
    name = name or f"serve/{profile.arch}"
    return [
        TraceJob(
            job_id=i,
            name=f"{name}#{i}",
            profile=profile,
            arrival=float(arrivals[i]),
            work=int(rng.integers(*steps)) * step0,
        )
        for i in range(n_jobs)
    ]


def fleet_request_stream(
    n: int,
    vocab: int,
    *,
    seed: int = 0,
    loud_fraction: float = 0.3,
    arrival_rate: float = 2.0,
    interactive_buckets: Sequence[int] = (16, 32),
    batch_bucket: int = 64,
    gen_interactive: tuple = (8, 16),
    gen_batch: tuple = (16, 32),
    cancel_fraction: float = 0.0,
    cancel_after: tuple = (0.5, 2.0),
):
    """Rack-sim job stream mapped onto fleet ROUTER traffic — the
    admission<->scheduler loop closed at fleet scale. The generator
    reuses `synthetic_stream`'s quadrant split, but instead of
    `TraceJob`s it emits serving `Request`s: a LOUD (link-heavy,
    Hypre-like) draw becomes a long-prompt priority-1 batch request
    (big KV footprint = the pool injector), a QUIET draw becomes a
    short-prompt priority-0 interactive request (the fragile
    bystander). `cancel_fraction` of requests carry a virtual-time
    `cancel_at` deadline (`arrival + U(*cancel_after)`) — deterministic
    cancellation load for the router's sweep path. Deterministic in
    `seed`; arrivals are the same Poisson process the rack-sim uses."""
    # imported lazily: serving pulls in torch, which synthetic users skip
    from repro_torch.serving.queue import Request

    if not 0.0 <= cancel_fraction <= 1.0:
        raise ValueError("cancel_fraction must be in [0, 1]")
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / arrival_rate, size=n))
    out = []
    for i in range(n):
        loud = rng.uniform() < loud_fraction
        if loud:
            plen = batch_bucket
            gen = int(rng.integers(gen_batch[0], gen_batch[1] + 1))
            prio, tenant = 1, "batch"
        else:
            plen = int(rng.choice(list(interactive_buckets)))
            gen = int(rng.integers(gen_interactive[0],
                                   gen_interactive[1] + 1))
            prio, tenant = 0, "interactive"
        cancel_at = None
        if cancel_fraction and rng.uniform() < cancel_fraction:
            cancel_at = float(arrivals[i] + rng.uniform(*cancel_after))
        out.append(Request(
            request_id=i,
            tokens=rng.integers(0, vocab, size=plen).astype(np.int32),
            max_new_tokens=gen,
            arrival=float(arrivals[i]),
            priority=prio,
            tenant=tenant,
            cancel_at=cancel_at,
        ))
    return out


def catalog_stream(
    n_jobs: int,
    *,
    seed: int = 0,
    arrival_rate: float = 1.0,
    shapes: Sequence[str] = ("decode_32k",),
    archs: Optional[Sequence[str]] = None,
    steps: tuple = (120, 360),
    pool_fraction="auto",
    use_dryrun: bool = False,
    work_scale: float = 1.0,
) -> List[TraceJob]:
    """Stream sampled from the model catalog, uniformly over archs x
    `shapes`. Profiles are computed once per (arch, shape) cell by
    `core.quantify.profile_for` (cached) and shared by every job of that
    cell — submission cost stays O(|zoo|), not O(n_jobs).

    Shape mixing is what populates the paper's sensitivity quadrants from
    the catalog: decode/long cells are link-saturating injectors, while
    train/prefill cells are compute-bound bystanders. `pool_fraction`
    defaults to the pool-by-necessity adoption scenario; pass a float
    (e.g. 0.5) for the paper-style emulated R_cap stress. `work_scale`
    rescales isolated runtimes so short trace studies do not need millions
    of decode steps to reach steady state.
    """
    # imported lazily: quantify pulls in the catalog, which synthetic
    # users skip
    from repro_torch import configs
    from repro_torch.core.quantify import profile_for

    rng = np.random.default_rng(seed)
    archs = list(archs) if archs is not None else configs.list_archs()
    cells = [(a, s) for a in archs for s in shapes]
    profiles = {
        cell: profile_for(cell[0], cell[1], pool_fraction=pool_fraction,
                          use_dryrun=use_dryrun)
        for cell in cells
    }
    arrivals = np.cumsum(rng.exponential(1.0 / arrival_rate, size=n_jobs))
    jobs = []
    for i in range(n_jobs):
        arch, shape = cells[int(rng.integers(len(cells)))]
        prof = profiles[(arch, shape)]
        n_steps = int(rng.integers(*steps))
        jobs.append(TraceJob(
            job_id=i,
            name=f"{arch}:{shape}#{i}",
            profile=prof,
            arrival=float(arrivals[i]),
            work=work_scale * n_steps * prof.step_time(0.0),
        ))
    return jobs

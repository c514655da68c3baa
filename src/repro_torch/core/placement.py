"""Level 2: placement policies and the R_cap <= R_access <= R_bw corridor
(copy of `repro.core.placement`).

Policies: all_local, first_touch, hotness (hottest into HBM — what the KV
pager runs), balanced_bw, capacity. The placement quality metric is the
predicted memory-phase time t = max(local_traffic/B_hbm,
pool_traffic/B_link).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.access import TensorAccess
from repro_torch.core.tiers import TierTopology


@dataclasses.dataclass
class Placement:
    assignment: dict           # name -> "hbm" | "host"
    policy: str
    pool_fraction_target: float
    r_cap_pool: float          # pool share of placed bytes
    r_access_pool: float       # pool share of traffic (paper's R_access)
    r_bw_pool: float           # reference point
    local_bytes: float
    pool_bytes: float
    local_traffic: float
    pool_traffic: float
    t_memory: float            # predicted memory-phase seconds (per step)
    t_memory_all_local: float  # lower bound if everything were in HBM

    @property
    def slowdown(self) -> float:
        return (
            self.t_memory / self.t_memory_all_local
            if self.t_memory_all_local
            else 1.0
        )

    def tier_of(self, name: str) -> str:
        return self.assignment.get(name, "hbm")


def _finalize(assignment, profile, topo: TierTopology, policy: str,
              pool_fraction: float, scale: float = 1.0) -> Placement:
    """scale: global->per-chip byte scale (1/n_shards average)."""
    local_b = pool_b = local_t = pool_t = 0.0
    for a in profile:
        if assignment.get(a.name, "hbm") == "hbm":
            local_b += a.bytes
            local_t += a.traffic
        else:
            pool_b += a.bytes
            pool_t += a.traffic
    total_b = local_b + pool_b or 1.0
    total_t = local_t + pool_t or 1.0
    t_local = scale * local_t / topo.local.bandwidth
    t_pool = scale * pool_t / topo.pool.bandwidth
    t_all = scale * total_t / topo.local.bandwidth
    return Placement(
        assignment=assignment,
        policy=policy,
        pool_fraction_target=pool_fraction,
        r_cap_pool=pool_b / total_b,
        r_access_pool=pool_t / total_t,
        r_bw_pool=topo.r_bw_pool,
        local_bytes=local_b,
        pool_bytes=pool_b,
        local_traffic=local_t,
        pool_traffic=pool_t,
        t_memory=max(t_local, t_pool),
        t_memory_all_local=t_all,
    )


def place(profile: list[TensorAccess], topo: TierTopology, policy: str,
          pool_fraction: float = 0.5, per_chip_scale: float = 1.0
          ) -> Placement:
    total = sum(a.bytes for a in profile)
    local_cap_global = (1.0 - pool_fraction) * total

    if policy == "all_local":
        assignment = {a.name: "hbm" for a in profile}
        return _finalize(assignment, profile, topo, policy, 0.0,
                         per_chip_scale)

    if policy == "first_touch":
        order = list(profile)                 # allocation (tree) order
    elif policy in ("hotness", "balanced_bw", "capacity"):
        order = sorted(profile, key=lambda a: a.touches, reverse=True)
    else:
        raise ValueError(f"unknown policy {policy}")

    assignment = {}
    used = 0.0
    if policy == "balanced_bw":
        # fill HBM hot-first but keep pool traffic share >= R_BW so the pool
        # link contributes bandwidth instead of idling
        total_t = sum(a.traffic for a in profile) or 1.0
        r_bw = topo.r_bw_pool
        pool_t = total_t
        for a in order:
            would_pool_t = pool_t - a.traffic
            if used + a.bytes <= local_cap_global and (
                would_pool_t / total_t
            ) >= r_bw:
                assignment[a.name] = "hbm"
                used += a.bytes
                pool_t = would_pool_t
            else:
                assignment[a.name] = "host"
    elif policy == "capacity":
        # target pool access share ~= pool capacity share (reference only)
        total_t = sum(a.traffic for a in profile) or 1.0
        pool_t = total_t
        for a in order:
            if used + a.bytes <= local_cap_global and (
                pool_t - a.traffic
            ) / total_t >= pool_fraction:
                assignment[a.name] = "hbm"
                used += a.bytes
                pool_t -= a.traffic
            else:
                assignment[a.name] = "host"
    else:
        for a in order:
            if used + a.bytes <= local_cap_global:
                assignment[a.name] = "hbm"
                used += a.bytes
            else:
                assignment[a.name] = "host"

    return _finalize(assignment, profile, topo, policy, pool_fraction,
                     per_chip_scale)


def corridor_check(p: Placement) -> dict:
    """The paper's §5 tuning corridor: R_cap <= R_access <= R_bw."""
    return {
        "r_cap_pool": p.r_cap_pool,
        "r_access_pool": p.r_access_pool,
        "r_bw_pool": p.r_bw_pool,
        "below_capacity_ref": p.r_access_pool < p.r_cap_pool,
        "above_bandwidth_ref": p.r_access_pool > p.r_bw_pool,
        "in_corridor": p.r_cap_pool <= p.r_access_pool <= p.r_bw_pool,
    }

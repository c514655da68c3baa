"""Level 3: the pool-link queueing model the admission controller and the
engine's virtual clock use (copy of the functions of
`repro.core.interference` on the serving path).

The pool link is an M/D/1-style server: at utilization rho the mean
service multiplier is 1 + rho/(2(1-rho)), capped at RHO_CAP.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.tiers import TierTopology, h100_topology

RHO_CAP = 0.95      # links time-slice: a victim is never fully starved
LOI_SHARE_FLOOR = 0.1


def queueing_slowdown(rho):
    """M/D/1 mean service multiplier at utilization rho (capped at the
    time-slicing limit). Broadcasts over numpy arrays."""
    rho = np.clip(rho, 0.0, RHO_CAP)
    return 1.0 + rho / (2.0 * (1.0 - rho))


def mdl_knee(max_excess: float = 0.75) -> float:
    """Utilization rho* where the M/D/1 queueing excess reaches
    `max_excess`: rho = 2e/(1+2e) (0.6 at the default 0.75)."""
    if max_excess <= 0.0:
        raise ValueError("max_excess must be positive")
    return 2.0 * max_excess / (1.0 + 2.0 * max_excess)


def corridor_budget(topo: Optional[TierTopology] = None,
                    max_excess: float = 0.75) -> float:
    """Aggregate injected-LoI budget of one pool link: the M/D/1 knee
    utilization, discounted by the pool tier's share of the aggregate
    bandwidth (`TierTopology.r_bw_pool`)."""
    topo = topo or h100_topology()
    return mdl_knee(max_excess) * (1.0 - topo.r_bw_pool)


def step_time_vec(t_pool, t_local, t_compute, loi, overlap: bool = True):
    """Victim-side step time under background LoI, broadcasting over any
    argument: the victim's pool transfers lose bandwidth share and queue
    behind the background stream."""
    loi = np.asarray(loi, dtype=np.float64)
    t_pool_eff = (
        t_pool * queueing_slowdown(loi)
        / np.maximum(1.0 - loi, LOI_SHARE_FLOOR)
    )
    if overlap:
        return np.maximum(np.maximum(t_compute, t_local), t_pool_eff)
    return t_compute + t_local + t_pool_eff

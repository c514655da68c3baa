"""Level 3: memory interference on the pooled tier (paper §3.2, §6; copy
of `repro.core.interference`, priced by default with the port's H100
topology).

The pool link (PCIe to pinned host DRAM here; UPI/CXL in the paper) is
shared by `chips_per_pool` cards. Co-running jobs inject traffic; the
victim sees an effective link bandwidth reduction plus queueing delay. The
link is modeled as an M/D/1-style server, the same queueing-theory
approach as Tudor et al. [45] that the paper builds on:

    utilization rho = (victim + background) demand / link capacity
    effective service time multiplier  ~ 1 + rho/(2(1-rho))  (capped)

`LoI` (level of interference) is the background traffic as a fraction of
peak link bandwidth, dialed by LBench's flops/element knob exactly as in
the paper. Sensitivity and the interference coefficient (IC) are derived
from a workload's tier access profile:

  * sensitivity(LoI): relative step time when the pool link carries LoI
    background traffic — HIGH pool access ratio + LOW arithmetic intensity
    -> sensitive (the paper's Hypre/NekRS quadrant);
  * IC: traffic the job itself injects relative to peak link bandwidth —
    what a scheduler needs for co-location decisions (paper §6.2).

The model's constants are the reference's, unchanged: `lbench_loi` prices
a probe's compute at 2e-10 s per flop per element, so on the H100
topology's 64 GB/s link nflop=1 gives LoI 0.625, not the 1.0 it gives on
the reference's 16 GB/s v5e link.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.placement import Placement
from repro_torch.core.tiers import TierTopology, h100_topology


# ------------------------------------------------------------ link model
RHO_CAP = 0.95      # links time-slice: a victim is never fully starved
LOI_SHARE_FLOOR = 0.1


def queueing_slowdown(rho):
    """M/D/1 mean service multiplier at utilization rho (capped at the
    time-slicing limit — beyond ~95% the fabric arbiters round-robin).
    Broadcasts over numpy arrays; scalars come back as numpy scalars."""
    rho = np.clip(rho, 0.0, RHO_CAP)
    return 1.0 + rho / (2.0 * (1.0 - rho))


def mdl_knee(max_excess: float = 0.75) -> float:
    """Utilization rho* where the M/D/1 queueing excess reaches
    `max_excess`: solve 1 + rho/(2(1-rho)) = 1 + e  ->  rho = 2e/(1+2e).
    The default excess of 0.75 puts the knee at rho* = 0.6, the elbow of
    `queueing_slowdown` where delay departs the linear regime."""
    if max_excess <= 0.0:
        raise ValueError("max_excess must be positive")
    return 2.0 * max_excess / (1.0 + 2.0 * max_excess)


def corridor_budget(topo: Optional[TierTopology] = None,
                    max_excess: float = 0.75) -> float:
    """Aggregate injected-LoI budget of one pool link (the R_bw corridor).

    Derived, not hard-coded: the M/D/1 knee utilization of the shared link,
    discounted by the pool tier's share of the aggregate bandwidth diet
    (`TierTopology.r_bw_pool`) — that share of the link must stay clear for
    the residents' own foreground pool traffic, so only the remainder is
    available to absorb background injection before queueing explodes.
    """
    topo = topo or h100_topology()
    return mdl_knee(max_excess) * (1.0 - topo.r_bw_pool)


def step_time_vec(t_pool, t_local, t_compute, loi, overlap: bool = True):
    """Victim-side step time under background LoI — the single source of
    truth for the contention model, broadcasting over any argument.

    The background stream occupies `loi` of the shared link; the victim's
    own transfers are pipelined (they never queue against themselves) but
    they lose bandwidth share and queue behind the background stream. The
    rack-scale simulator calls this with whole-pool arrays of per-job
    (t_pool, t_local, t_compute) against each job's background LoI.
    """
    loi = np.asarray(loi, dtype=np.float64)
    t_pool_eff = (
        t_pool * queueing_slowdown(loi)
        / np.maximum(1.0 - loi, LOI_SHARE_FLOOR)
    )
    if overlap:
        return np.maximum(np.maximum(t_compute, t_local), t_pool_eff)
    return t_compute + t_local + t_pool_eff


def background_lois(injected) -> np.ndarray:
    """Per-victim background LoI inside one shared-link contention domain:
    the sum of everyone ELSE's injected traffic, capped at saturation."""
    injected = np.asarray(injected, dtype=np.float64)
    return np.minimum(1.0, injected.sum() - injected)


def progress_rates(t_pool, t_local, t_compute, bg_loi) -> np.ndarray:
    """Per-job progress rate (fraction of isolated speed, in (0, 1]) at the
    given background LoI. Vectorized over co-resident jobs."""
    base = np.maximum(np.maximum(t_compute, t_local), t_pool)
    base = np.maximum(base, 1e-12)
    return base / step_time_vec(t_pool, t_local, t_compute, bg_loi)


def lbench_loi(nflop: int, n_elements: int, topo: TierTopology,
               t_compute_floor: float = 0.0) -> float:
    """LoI produced by an LBench instance with `nflop` flops/element.

    LBench streams its array over the pool link; its achievable traffic is
    min(link bw, flops_capability-limited rate). Low nflop -> link-saturating
    (LoI -> 100%); high nflop -> compute-bound, lower LoI. Mirrors paper
    Fig 11-left (linear in configured intensity until saturation).
    """
    bytes_per_elem = 8.0  # f32 read + write
    flops_per_elem = max(nflop, 1)
    # time per element on the link vs in compute (1 core-ish probe)
    t_link = bytes_per_elem / topo.pool.bandwidth
    t_comp = flops_per_elem * 2e-10 + t_compute_floor
    achieved_bw = bytes_per_elem / max(t_link, t_comp)
    return min(1.0, achieved_bw / topo.pool.bandwidth)


# --------------------------------------------------------- app metrics
@dataclasses.dataclass
class InterferenceProfile:
    arch: str
    shape: str
    pool_traffic: float          # bytes per step per chip on the pool link
    local_traffic: float         # bytes per step per chip in HBM
    t_compute: float             # seconds of pure compute per step
    topo: TierTopology

    @property
    def t_pool(self) -> float:
        return self.pool_traffic / self.topo.pool.bandwidth

    @property
    def t_local(self) -> float:
        return self.local_traffic / self.topo.local.bandwidth

    def step_time(self, loi: float = 0.0, overlap: bool = True) -> float:
        """Predicted step time at background interference level `loi`
        (scalar entry point into `step_time_vec`)."""
        return float(
            step_time_vec(self.t_pool, self.t_local, self.t_compute, loi,
                          overlap)
        )

    def step_time_no_pool(self) -> float:
        return max(self.t_compute, self.t_local)

    def sensitivity(self, loi: float) -> float:
        """Relative performance at LoI vs LoI=0 (paper Fig 10; 1.0 = no
        degradation)."""
        return self.step_time(0.0) / self.step_time(loi)

    def sensitivity_vec(self, lois) -> np.ndarray:
        """`sensitivity` broadcast over an array of LoI values."""
        return self.step_time(0.0) / step_time_vec(
            self.t_pool, self.t_local, self.t_compute, lois
        )

    def _raw_base(self) -> float:
        return max(self.t_compute, self.t_local, self.t_pool, 1e-12)

    def interference_coefficient(self) -> float:
        """IC: the slowdown this job inflicts on a 1-thread LBench probe
        (paper §3.2) — driven by the job's pool-link utilization."""
        util = self.t_pool / self._raw_base()
        return float(queueing_slowdown(util))

    def injected_loi(self) -> float:
        return min(1.0, self.t_pool / self._raw_base())


def profile_from_placement(arch: str, shape: str, placement: Placement,
                           t_compute: float, topo: TierTopology
                           ) -> InterferenceProfile:
    return InterferenceProfile(
        arch=arch,
        shape=shape,
        pool_traffic=placement.pool_traffic,
        local_traffic=placement.local_traffic,
        t_compute=t_compute,
        topo=topo,
    )


# ------------------------------------------------------ LBench validation
def lbench_intensity_sweep(topo: TierTopology, nflops=(1, 2, 4, 8, 16, 32,
                                                       64, 128)):
    """Paper Fig 11-middle: measured traffic saturates at link bw while
    contention (IC) keeps rising below 8 flops/element."""
    rows = []
    for nf in nflops:
        loi = lbench_loi(nf, 1 << 20, topo)
        raw_bw = min(
            topo.pool.bandwidth,
            loi * topo.pool.bandwidth,
        )
        ic = float(queueing_slowdown(loi))
        rows.append({
            "nflop": nf,
            "loi": loi,
            "pcm_bw": raw_bw,          # what raw counters would show
            "ic": ic,                  # what LBench can still distinguish
        })
    return rows

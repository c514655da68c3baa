"""Roofline models (port of `repro.core.roofline`).

Two layers:

1. The 3-term *dry-run roofline* of a step (`report`), from the cost
   model of `profiler.cost` (the port's counterpart of the reference's
   HLO cost model):
       compute    = flops       / peak_flops          (per card)
       memory     = bytes       / hbm_bw              (per card)
       collective = wire_bytes  / link_bw             (per card)
   The dominant term is the bottleneck; the attainable step time is
   ~max(terms) under perfect overlap and ~sum under none; both bounds are
   reported. On one card no collective runs, so the third term is 0 s.

2. The paper's §3.4/§5 *memory roofline* extended to multiple tiers:
   attainable bandwidth given an access split r_i over tiers with
   bandwidths B_i is 1 / max_i(r_i / B_i), maximized when r_i ∝ B_i (the
   paper's "balanced access" reference point R_bw).
"""

from __future__ import annotations

import dataclasses

from repro_torch.common import hw


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    flops: float                # per device
    hbm_bytes: float            # per device
    wire_bytes: float           # per device
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    model_flops: float          # 6*N*D useful flops (global)
    model_flops_per_device: float
    useful_ratio: float         # model_flops / flops (per device basis)
    bound_overlap: float        # max(terms)
    bound_serial: float         # sum(terms)
    roofline_fraction: float    # useful work time / attainable bound
    collective_by_kind: dict
    warnings: list

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_train(n_active_params: int, tokens: int) -> float:
    """6*N*D — the canonical useful-flops estimate for LM training."""
    return 6.0 * n_active_params * tokens


def model_flops_decode(n_active_params: int, tokens: int) -> float:
    """2*N per generated token (forward only)."""
    return 2.0 * n_active_params * tokens


def report(arch: str, shape: str, mesh_name: str, cost, n_devices: int,
           model_flops: float, chip: hw.ChipSpec = hw.H100
           ) -> RooflineReport:
    """The 3-term roofline of a step whose per-device `cost` has `flops`,
    `hbm_bytes`, `wire_bytes`, `collective_by_kind` and `warnings`
    (`profiler.cost.CostModel`). Wire bytes leave the card over its
    links (`chip.link_bw`, one direction); with none (one card) the
    term is 0 s."""
    t_c = cost.flops / chip.peak_flops_bf16
    t_m = cost.hbm_bytes / chip.hbm_bw
    t_x = cost.wire_bytes / chip.link_bw if cost.wire_bytes else 0.0
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    dominant = max(terms, key=terms.get)
    mf_dev = model_flops / n_devices
    useful = mf_dev / cost.flops if cost.flops else 0.0
    bound_overlap = max(terms.values())
    bound_serial = sum(terms.values())
    # roofline fraction: time the useful flops NEED at peak vs the time the
    # step NEEDS under perfect overlap; 1.0 iff compute-bound with zero
    # waste
    t_useful = mf_dev / chip.peak_flops_bf16
    frac = t_useful / bound_overlap if bound_overlap else 0.0
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name,
        flops=cost.flops, hbm_bytes=cost.hbm_bytes,
        wire_bytes=cost.wire_bytes,
        t_compute=t_c, t_memory=t_m, t_collective=t_x,
        dominant=dominant,
        model_flops=model_flops, model_flops_per_device=mf_dev,
        useful_ratio=useful,
        bound_overlap=bound_overlap, bound_serial=bound_serial,
        roofline_fraction=frac,
        collective_by_kind=dict(cost.collective_by_kind),
        warnings=list(cost.warnings),
    )


# ------------------------------------------------- paper's memory roofline
def multi_tier_bandwidth(access_ratios, bandwidths) -> float:
    """Attainable aggregate bandwidth for an access split over tiers.

    time per byte = max_i r_i/B_i  (each tier streams its share in
    parallel); attainable BW = 1 / that. Balanced access (r_i = B_i/sum B)
    attains sum(B_i) — the paper's point that tiers ADD bandwidth when used
    in balance.
    """
    worst = max(
        (r / b) for r, b in zip(access_ratios, bandwidths) if b > 0
    )
    return 1.0 / worst if worst > 0 else 0.0


def attainable_flops(ai: float, access_ratios, bandwidths,
                     chip: hw.ChipSpec = hw.H100) -> float:
    """Roofline P = min(F, AI * B_eff(r)) with the multi-tier B_eff."""
    beff = multi_tier_bandwidth(access_ratios, bandwidths)
    return min(chip.peak_flops_bf16, ai * beff)

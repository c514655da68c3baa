"""Roofline models (the pieces of `repro.core.roofline` that need no HLO
cost model; the dry-run roofline `report`/`RooflineReport` ports with
ROADMAP A15).

Useful-flop counts, and the paper's §3.4/§5 memory roofline extended to
multiple tiers: attainable bandwidth given an access split r_i over tiers
with bandwidths B_i is 1 / max_i(r_i / B_i), maximized when r_i ∝ B_i
(the paper's "balanced access" reference point R_bw).
"""

from __future__ import annotations

from repro_torch.common import hw


def model_flops_train(n_active_params: int, tokens: int) -> float:
    """6*N*D — the canonical useful-flops estimate for LM training."""
    return 6.0 * n_active_params * tokens


def model_flops_decode(n_active_params: int, tokens: int) -> float:
    """2*N per generated token (forward only)."""
    return 2.0 * n_active_params * tokens


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

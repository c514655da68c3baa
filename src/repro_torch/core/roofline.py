"""Useful-flop counts for the engine's virtual clock (the piece of
`repro.core.roofline` the serving path uses; the HLO-driven dry-run
roofline ports with ROADMAP A15)."""

from __future__ import annotations


def model_flops_decode(n_active_params: int, tokens: int) -> float:
    """2*N per generated token (forward only)."""
    return 2.0 * n_active_params * tokens

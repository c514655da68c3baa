"""Tier topology — Level 2 of the paper's methodology (copy of
`repro.core.tiers`, priced with the port's H100 data-sheet constants).

A `TierTopology` describes the per-card memory system: the fast HBM tier
and the pooled host tier behind the PCIe link (the paper's rack-scale pool
behind CXL). `emulated(pool_fraction, working_set)` mirrors the paper's
evaluation method: rather than changing hardware, the *available*
fast-tier capacity is restricted so that the pool holds `pool_fraction`
of the working set (R_cap^remote = 25/50/75%).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.common import hw


@dataclasses.dataclass(frozen=True)
class TierSpec:
    name: str                 # "hbm" | "host"
    capacity: float           # bytes per card
    bandwidth: float          # bytes/s per card (stream)
    latency: float            # seconds
    memory_kind: Optional[str]   # "device" | "pinned_host"


@dataclasses.dataclass(frozen=True)
class TierTopology:
    tiers: tuple
    shared_link_bw: float     # host<->cards contention domain (bytes/s)
    chips_per_pool: int

    @property
    def local(self) -> TierSpec:
        return self.tiers[0]

    @property
    def pool(self) -> TierSpec:
        return self.tiers[1]

    @property
    def r_bw_pool(self) -> float:
        """The paper's R_BW reference: pool share of aggregate bandwidth."""
        total = sum(t.bandwidth for t in self.tiers)
        return self.pool.bandwidth / total

    def r_cap_pool(self) -> float:
        total = sum(t.capacity for t in self.tiers)
        return self.pool.capacity / total


def h100_topology(chip: hw.ChipSpec = hw.H100,
                  host: hw.HostSpec = hw.H100_HOST) -> TierTopology:
    """HBM local tier + pinned host DRAM behind PCIe Gen5 (data sheet;
    the latencies are the reference topology's modeled values)."""
    return TierTopology(
        tiers=(
            TierSpec("hbm", chip.hbm_bytes, chip.hbm_bw, 1e-7, "device"),
            TierSpec(
                "host",
                host.dram_bytes / host.chips_per_host,
                host.pcie_bw,
                2e-6,
                "pinned_host",
            ),
        ),
        shared_link_bw=host.pcie_shared_bw,
        chips_per_pool=host.chips_per_host,
    )


def emulated(pool_fraction: float, working_set: float,
             base: Optional[TierTopology] = None) -> TierTopology:
    """Paper-style emulation: restrict local capacity so the pool must hold
    `pool_fraction` of the working set (per card). `base` defaults to
    `h100_topology()`."""
    base = base or h100_topology()
    local_cap = min(base.local.capacity, (1.0 - pool_fraction) * working_set)
    pool_cap = max(base.pool.capacity, pool_fraction * working_set)
    return TierTopology(
        tiers=(
            dataclasses.replace(base.local, capacity=local_cap),
            dataclasses.replace(base.pool, capacity=pool_cap),
        ),
        shared_link_bw=base.shared_link_bw,
        chips_per_pool=base.chips_per_pool,
    )

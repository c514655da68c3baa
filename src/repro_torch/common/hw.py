"""Hardware constants for the port's target, one NVIDIA H100 SXM, and the
host memory pool behind its PCIe link.

Every number here is a DATA-SHEET value (NVIDIA H100 Tensor Core GPU data
sheet and Hopper architecture white paper for the chip; DGX H100 data
sheet for the host), not a measurement: they price the engine's virtual
clock (`serving.engine`), the tier topology (`core.tiers`) and the
admission corridor (`core.interference`) until a chip run measures them.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """One accelerator card."""

    name: str
    peak_flops_bf16: float      # flop/s, dense bf16 tensor cores
    hbm_bytes: float            # bytes of device memory
    hbm_bw: float               # bytes/s device-memory bandwidth
    link_bw: float              # bytes/s NVLink to the other cards, one way
    num_sms: int                # streaming multiprocessors
    smem_per_block: int         # bytes of shared memory one block may use
    l2_bytes: float             # bytes of L2 cache


@dataclasses.dataclass(frozen=True)
class HostSpec:
    """The host a group of cards shares — the 'rack-scale memory pool' of
    the paper, here pinned host DRAM reached over PCIe."""

    dram_bytes: float           # pool capacity per host
    pcie_bw: float              # bytes/s per card to pinned host memory
    pcie_shared_bw: float       # bytes/s total host<->cards (contention domain)
    chips_per_host: int
    nic_bw: float               # bytes/s per card across hosts


# H100 SXM5 80 GB (data sheet): 989 TFLOP/s dense bf16, 80 GB HBM3 at
# 3.35 TB/s, NVLink 900 GB/s total (450 GB/s each way), 132 SMs, 227 KB of
# shared memory per block, 50 MB L2.
H100 = ChipSpec(
    name="h100-sxm",
    peak_flops_bf16=989e12,
    hbm_bytes=80e9,
    hbm_bw=3.35e12,
    link_bw=450e9,
    num_sms=132,
    smem_per_block=232_448,
    l2_bytes=50e6,
)

# DGX H100 host (data sheet): 2 TB of system memory for 8 cards, each on a
# PCIe Gen5 x16 link (64 GB/s each way); the 8-card board hangs two cards
# off each host PCIe switch uplink, so the shared domain is modeled as half
# the per-card sum. 8x 400 Gb/s ConnectX-7 (50 GB/s per card) across hosts.
H100_HOST = HostSpec(
    dram_bytes=2e12,
    pcie_bw=64e9,
    pcie_shared_bw=8 * 64e9 / 2,
    chips_per_host=8,
    nic_bw=50e9,
)

DTYPE_BYTES = {
    "float32": 4,
    "bfloat16": 2,
    "float16": 2,
    "int8": 1,
    "uint8": 1,
    "int32": 4,
    "uint32": 4,
    "int64": 8,
    "bool": 1,
    "float64": 8,
}


def dtype_size(dtype) -> int:
    """Bytes per element of a torch dtype, numpy dtype or dtype name."""
    name = str(getattr(dtype, "name", dtype))
    return DTYPE_BYTES[name.removeprefix("torch.")]

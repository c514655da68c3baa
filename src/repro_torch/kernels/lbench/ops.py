"""Public LBench op: a CUDA tensor launches the CUDA kernel
(`lbench.py`, float32 only), a CPU tensor takes the plain version."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.kernels.lbench import ref


def lbench(a: torch.Tensor, nflop: int, alpha: float = 0.5, *,
           impl: Optional[str] = None) -> torch.Tensor:
    """The FMA chain of `ref.lbench` over every element of `a`, out of
    place; returns a tensor shaped like `a`."""
    if nflop < 0:
        raise ValueError(f"nflop must be >= 0, got {nflop}")
    if kernels.select_impl(a, impl) == "reference":
        kernels.REFERENCE_CALLS["lbench"] += 1
        return ref.lbench(a, nflop, alpha)
    from repro_torch.kernels.lbench import lbench as kl

    return kl.lbench_cuda(a.contiguous(), nflop, alpha)


flops = ref.flops
bytes_moved = ref.bytes_moved

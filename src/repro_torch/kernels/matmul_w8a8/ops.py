"""Public W8A8 int8 matmul op: a CUDA tensor launches the CUDA kernel
(`matmul_w8a8.py`), a CPU tensor takes the plain version. The kernel
masks ragged M, N and K itself, so nothing is padded."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.kernels.matmul_w8a8 import ref
from repro_torch.kernels.matmul_w8a8.ref import quantize_rows  # noqa: F401


def matmul_w8a8(a8: torch.Tensor, b8: torch.Tensor, sa: torch.Tensor,
                sb: torch.Tensor, *, block_m: int = 128, block_n: int = 128,
                block_k: int = 128,
                impl: Optional[str] = None) -> torch.Tensor:
    """int8 activation/weight matmul with symmetric per-row / per-column
    scales: a8 (M, K) int8, b8 (K, N) int8, sa (M,) float32, sb (N,)
    float32 -> (M, N) float32. Quantize fp operands with
    `quantize_rows`: ``quantize_rows(a)`` reduces each activation row
    over K; ``quantize_rows(w, axis=0)`` reduces each weight column over
    K. `block_m/n/k` keep the reference's signature; the kernel picks
    its own tiles."""
    del block_m, block_n, block_k
    if kernels.select_impl(a8, impl) == "reference":
        kernels.REFERENCE_CALLS["matmul_w8a8"] += 1
        return ref.matmul_w8a8(a8, b8, sa, sb)
    from repro_torch.kernels.matmul_w8a8 import matmul_w8a8 as mm

    return mm.matmul_w8a8_cuda(a8.contiguous(), b8.contiguous(),
                               sa.float().contiguous(),
                               sb.float().contiguous())

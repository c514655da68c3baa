"""Plain PyTorch version of the W8A8 int8 matmul cell
(`repro.kernels.matmul_w8a8.ref`, same semantics).

Symmetric per-row / per-column quantization: activations carry one
float32 scale per row (reduced over K), weights one per output column, so
the int32 accumulator dequantizes with a rank-1 outer product of scales
in the epilogue. `MIN_SCALE` keeps all-zero rows exact (q == 0 -> 0.0),
as `kernels.quant` does.

The int32 accumulator is exact on every device: torch has an int32
matrix product on the CPU but none on CUDA, where the product runs in
float64 instead, which is exact while |acc| < 2^53 (127 * 127 * K is far
below it for any K that fits in memory).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.quant import INT8_QMAX, MIN_SCALE


def quantize_rows(x: torch.Tensor, axis: int = -1):
    """Symmetric int8 quantization of ``x`` with one scale per slice
    along ``axis``: scale = max|x| / 127 (floored at MIN_SCALE), a true
    division and round half to even, as the reference. Returns
    ``(q8, scale)`` with ``scale`` shaped like ``x`` minus ``axis``."""
    x = x.float()
    scale = torch.clamp_min(x.abs().amax(dim=axis) / INT8_QMAX, MIN_SCALE)
    q = torch.round(x / scale.unsqueeze(axis))
    return torch.clamp(q, -INT8_QMAX, INT8_QMAX).to(torch.int8), scale


def int_matmul(a8: torch.Tensor, b8: torch.Tensor,
               via: Optional[str] = None) -> torch.Tensor:
    """The exact int32 product a8 (M, K) @ b8 (K, N) of int8 operands.
    `via` "int32" (an int32 product, the CPU's) or "float64" (exact
    while |acc| < 2^53, the product torch has on CUDA); by default the
    device decides."""
    via = via or ("int32" if a8.device.type == "cpu" else "float64")
    if via == "int32":
        return a8.to(torch.int32) @ b8.to(torch.int32)
    if via == "float64":
        return (a8.double() @ b8.double()).to(torch.int32)
    raise ValueError(f"unknown product {via!r}")


def matmul_w8a8(a8: torch.Tensor, b8: torch.Tensor, sa: torch.Tensor,
                sb: torch.Tensor, dtype=torch.float32,
                via: Optional[str] = None) -> torch.Tensor:
    """int8 x int8 -> int32 -> scaled float: a8 (M, K), b8 (K, N), sa
    (M,) per-row activation scales, sb (N,) per-column weight scales.
    Returns (M, N) in ``dtype``: float32(acc) * sa[m] * sb[n]."""
    acc = int_matmul(a8, b8, via)
    out = acc.to(torch.float32) * sa.float()[:, None] * sb.float()[None, :]
    return out.to(dtype)

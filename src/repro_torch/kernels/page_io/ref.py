"""Plain PyTorch version of the page writer (`repro.kernels.page_io.ref`)."""

from __future__ import annotations

import torch


def write_pages(pool: torch.Tensor, tiles: torch.Tensor,
                phys: torch.Tensor) -> torch.Tensor:
    """pool (nb, P_phys, ...), tiles (nb, n_wp, ...), phys (n_wp,) int:
    `pool[:, phys[j]] = tiles[:, j]`, in place. Returns `pool`."""
    return pool.index_copy_(1, phys.long(), tiles.to(pool.dtype))

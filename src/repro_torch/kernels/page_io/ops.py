"""Public page-writer op: land page tiles in the physical pool, in place.

A CUDA pool goes through the CUDA page writer (`page_io.py`); a CPU pool
takes the plain `index_copy_` (`ref.py`). Arbitrary trailing page dims
are copied as bytes by the kernel."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.kernels.page_io import ref


def write_pages(pool: torch.Tensor, tiles: torch.Tensor, phys: torch.Tensor,
                *, impl: Optional[str] = None) -> torch.Tensor:
    """pool (nb, P_phys, *page_dims), tiles (nb, n_wp, *page_dims), phys
    (n_wp,) unique physical page ids (live block-table entries). Lands
    the tiles at their physical pages in place (where the reference
    returns a new aliased pool) and returns `pool`."""
    tiles = tiles.to(pool.dtype)
    if kernels.select_impl(pool, impl) == "reference":
        kernels.REFERENCE_CALLS["write_pages"] += 1
        return ref.write_pages(pool, tiles, phys)
    from repro_torch.kernels.page_io import page_io

    return page_io.write_pages_cuda(
        pool, tiles.contiguous(), phys.to(torch.int32).contiguous())

"""Plain PyTorch versions of the page writer (`repro.kernels.page_io.ref`)
and of the substrate's page streams."""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def write_pages(pool: torch.Tensor, tiles: torch.Tensor,
                phys: torch.Tensor) -> torch.Tensor:
    """pool (nb, P_phys, ...), tiles (nb, n_wp, ...), phys (n_wp,) int:
    `pool[:, phys[j]] = tiles[:, j]`, in place; an id outside [0, P_phys)
    is dropped, as the kernel drops it. Returns `pool`.

    Departs from the reference (`pool.at[:, phys].set`) on negative ids:
    JAX wraps -1 to page P_phys - 1 and writes it, the port drops it, so
    a stale table entry can never overwrite a live page. Ids at or past
    P_phys are dropped by both."""
    phys = phys.long().to(pool.device)
    keep = (phys >= 0) & (phys < pool.shape[1])
    tiles = tiles.to(pool.dtype)
    if not bool(keep.all()):
        phys, tiles = phys[keep], tiles[:, keep.to(tiles.device)]
    return pool.index_copy_(1, phys, tiles)


def copy_pages(dst: Sequence[torch.Tensor], dst_ids: Optional[torch.Tensor],
               src: Sequence[torch.Tensor],
               src_ids: Optional[torch.Tensor]) -> None:
    """`dst[k][:, dst_ids[j]] = src[k][:, src_ids[j]]` for every leaf k
    (ids None: page j): `index_select`, then `index_copy_`."""
    for d, s in zip(dst, src, strict=True):
        rows = s if src_ids is None else s.index_select(
            1, src_ids.long().to(s.device))
        rows = rows.to(d.device)
        if dst_ids is None:
            d[:, :rows.shape[1]].copy_(rows)
        else:
            d.index_copy_(1, dst_ids.long().to(d.device), rows)

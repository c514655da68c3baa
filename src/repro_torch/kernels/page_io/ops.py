"""Public page-copy ops: land page tiles in the physical pool in place
(`write_pages`, `write_pages_group`) and move pages between the pool and
its host twin (`copy_pages`, the substrate's page_out / page_in streams)
or between two engines' pools (`copy_pages`, the fleet's prefill->decode
handoff), and stream a stacked layer leaf into a device buffer one layer
ahead (`copy_pages`, the `layer_in` stream of `prefetch.static`), and
move the tiered train step's pool-tier leaves between pinned host
memory and the card (`copy_pages`, the `state_in` / `state_out` streams
of `runtime.tiering`).

A CUDA pool goes through the grouped CUDA page copy (`page_io.py`); a CPU
pool takes the plain `index_copy_` / `index_select` (`ref.py`).
Arbitrary trailing page dims are copied as bytes by the kernel."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch import kernels
from repro_torch.kernels.page_io import ref

STREAMS = ("page_out", "page_in", "handoff", "layer_in", "state_in",
           "state_out")


def write_pages(pool: torch.Tensor, tiles: torch.Tensor, phys: torch.Tensor,
                *, impl: Optional[str] = None) -> torch.Tensor:
    """pool (nb, P_phys, *page_dims), tiles (nb, n_wp, *page_dims), phys
    (n_wp,) unique physical page ids (live block-table entries). Lands
    the tiles at their physical pages in place (where the reference
    returns a new aliased pool) and returns `pool`."""
    write_pages_group([pool], [tiles], phys, impl=impl)
    return pool


def write_pages_group(pools: Sequence[torch.Tensor],
                      tiles: Sequence[torch.Tensor], phys: torch.Tensor, *,
                      impl: Optional[str] = None) -> None:
    """`write_pages` of several leaves that share one id vector (k, k_sz,
    v, v_sz of an admission) in ONE kernel launch, in place."""
    tiles = [t.to(p.dtype) for p, t in zip(pools, tiles, strict=True)]
    if kernels.select_impl(pools[0], impl) == "reference":
        kernels.REFERENCE_CALLS["write_pages"] += 1
        for p, t in zip(pools, tiles):
            ref.write_pages(p, t, phys)
        return
    from repro_torch.kernels.page_io import page_io

    page_io.write_pages_cuda(
        pools, [t.contiguous() for t in tiles],
        phys.to(device=pools[0].device, dtype=torch.int32).contiguous())


def copy_pages(dst, dst_ids: Optional[torch.Tensor], src,
               src_ids: Optional[torch.Tensor], *, name: str = "page_out",
               impl: Optional[str] = None) -> None:
    """`dst[k][:, dst_ids[j]] = src[k][:, src_ids[j]]` for each leaf k of
    `dst` / `src` (tensors or sequences of tensors; ids None: page j), in
    one launch. page_out is `copy_pages(twin, ids, pool, ids)`, page_in
    `copy_pages(scratch, None, twin, ids)`, the handoff `copy_pages(
    dst_pool, dst_ids, src_pool, src_ids)` (device to device, between two
    engines' pools), layer_in `copy_pages(buf[None, None], None,
    leaf[None], ids[i:i + 1])` (layer i of a pinned stacked leaf into a
    device buffer, `prefetch.static.scan_with_prefetch`), state_in /
    state_out `copy_pages(dst_leaves, None, src_leaves, None)` (whole
    leaves of the train state, `runtime.tiering`). The device side
    decides: a
    CUDA tensor among them launches the kernel, which reaches a pinned
    host tensor through its mapped address (a host tensor that is not
    pinned raises); all-CPU tensors take the plain version. `name`
    (one of `STREAMS`) is the stream counted. Under the cost mode, meta
    tensors make one unit of the stream: each page read once and written
    once, and the id vectors read."""
    if name not in STREAMS:
        raise ValueError(f"unknown page stream {name!r}")
    dst = [dst] if isinstance(dst, torch.Tensor) else list(dst)
    src = [src] if isinstance(src, torch.Tensor) else list(src)
    if kernels.costed(dst[0]):
        ids = [i for i in (dst_ids, src_ids) if i is not None]
        # pages copied per level: the id vector's, else all of src's
        n = ids[0].shape[0] if ids else None
        moved = sum(2 * (n or s.shape[1]) * s.shape[0]
                    * math.prod(s.shape[2:]) * s.element_size() for s in src)
        kernels.record_unit(name, 0, moved + sum(4 * i.numel() for i in ids),
                            src + ids, dst)
        return
    anchor = next((t for t in (*dst, *src) if t.is_cuda), dst[0])
    if kernels.select_impl(anchor, impl) == "reference":
        kernels.REFERENCE_CALLS[name] += 1
        ref.copy_pages(dst, dst_ids, src, src_ids)
        return
    from repro_torch.kernels.page_io import page_io

    dev = anchor.device

    def ids32(ids):
        return None if ids is None else ids.to(
            device=dev, dtype=torch.int32).contiguous()

    d_ids = ids32(dst_ids)
    s_ids = d_ids if src_ids is dst_ids else ids32(src_ids)
    page_io.copy_pages_cuda(dst, d_ids, src, s_ids, name=name)

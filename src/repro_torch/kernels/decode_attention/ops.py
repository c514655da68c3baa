"""Public decode-attention ops (the serving hot loop): a CUDA tensor
launches the flash-decode kernel (contiguous cache) or the paged
flash-decode kernel (page pool through a block table), a CPU tensor takes
the plain version."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.kernels.decode_attention import ref


def decode_cost(q_shape, k_shape, n_keys: int, itemsize: int = 2,
                lse: bool = False) -> tuple[int, int]:
    """(operations, bytes) of one flash_decode call that reads `n_keys`
    keys in all (the sum over rows of min(length, S)): q.K and p.V over
    every head (4 D operations a key and head), K and V of those keys,
    q and out at `itemsize` bytes, the int32 lengths. The kernels
    table's bound (`chip_smoke.py`, from the run's lengths) and the
    dry-run's unit (`profiler.cost`, every row at the full extent: a
    meta tensor has no lengths) both read it. `lse`: the float32
    log-sum-exp is written too, B * H * 4 bytes."""
    B, H, D = q_shape
    KV = k_shape[2]
    nbytes = 2 * n_keys * KV * D * itemsize + 2 * B * H * D * itemsize \
        + B * 4 + (B * H * 4 if lse else 0)
    return 4 * D * H * n_keys, nbytes


def decode_mha(q, k, v, length, *, scale: Optional[float] = None,
               impl: Optional[str] = None, return_lse: bool = False):
    """q (B,H,D) vs a contiguous cache k/v (B,S,KV,D) with valid
    `length` (scalar or (B,); values past S read the whole cache). With
    `return_lse` returns (out, lse): lse (B,H) float32 the log-sum-exp of
    each row's scaled logits, -1e30 for a row of length 0, by which
    `merge_blocks` merges the outputs of disjoint key blocks. Under the
    cost mode a meta call is one unit of flash_decode."""
    lengths = torch.as_tensor(length, dtype=torch.int32,
                              device=q.device).broadcast_to((q.shape[0],))
    if kernels.costed(q):
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
        kernels.record_unit("flash_decode", *decode_cost(
            q.shape, k.shape, q.shape[0] * k.shape[1], q.element_size(),
            lse=return_lse), (q, k, v, lengths),
            (out, lse) if return_lse else (out,))
        return (out, lse) if return_lse else out
    if kernels.select_impl(q, impl) == "reference":
        kernels.REFERENCE_CALLS["decode_mha"] += 1
        return ref.decode_mha(q, k, v, lengths, scale=scale,
                              return_lse=return_lse)
    from repro_torch.kernels.decode_attention import decode_attention as da

    return da.flash_decode_cuda(q.contiguous(), k, v, lengths.contiguous(),
                                scale=scale, return_lse=return_lse)


def merge_blocks(outs, lses, dtype=None) -> torch.Tensor:
    """The decode over the union of disjoint key blocks from each
    block's `decode_mha(..., return_lse=True)`: outs (r, B, H, D), lses
    (r, B, H). In float32, block by block in order: with m = max_r lse_r
    and w_r = e^(lse_r - m), sum_r w_r out_r / sum_r w_r, cast to `dtype`
    (outs' by default). A block of length 0 (lse -1e30) weighs exactly 0;
    at least one block must hold a key."""
    m = lses.amax(dim=0)
    num = den = None
    for o, l in zip(outs, lses):
        w = torch.exp(l - m)
        t = w[..., None] * o.float()
        num = t if num is None else num + t
        den = w if den is None else den + w
    return (num / den[..., None]).to(dtype or outs.dtype)


def clamp_dead_entries(block_tables: torch.Tensor, n_pages: int, page: int,
                       frontier: torch.Tensor) -> torch.Tensor:
    """Clamp block-table entries at/past the per-sequence `frontier`
    (valid token count) to physical page 0 so every gather stays in
    bounds; the length masks keep them out of the math."""
    live = (torch.arange(n_pages, dtype=torch.int32,
                         device=block_tables.device)[None, :] * page
            < frontier[:, None])
    return torch.where(live, block_tables.to(torch.int32), 0)


def paged_decode_mha(q, k_pages, v_pages, block_tables, lengths, *,
                     k_sz=None, v_sz=None, scale: Optional[float] = None,
                     impl: Optional[str] = None) -> torch.Tensor:
    """q (B,H,D) vs a PAGED cache: k/v (P_phys, page, KV, D) physical page
    pool + (B, n_logical) block tables (`KVPager.block_table` layout) with
    per-sequence valid `lengths` (scalar or (B,)). `k_sz`/`v_sz` float32
    switch the pool to int8 block quantization, per page (P_phys, KV, 2)
    or per token (P_phys, page, KV, 2). The plain version gathers every
    table entry, so it clamps the dead ones first; the kernel never
    dereferences an entry at or past a slot's length and takes the table
    as it is."""
    lengths = torch.as_tensor(lengths, dtype=torch.int32,
                              device=q.device).broadcast_to((q.shape[0],))
    if kernels.select_impl(q, impl) == "reference":
        kernels.REFERENCE_CALLS["paged_decode_mha"] += 1
        block_tables = clamp_dead_entries(block_tables, block_tables.shape[1],
                                          k_pages.shape[1], lengths)
        return ref.paged_decode_mha(q, k_pages, v_pages, block_tables,
                                    lengths, k_sz=k_sz, v_sz=v_sz,
                                    scale=scale)
    from repro_torch.kernels.decode_attention import paged

    return paged.paged_flash_decode_cuda(
        q.contiguous(), k_pages, v_pages,
        block_tables.to(torch.int32).contiguous(), lengths.contiguous(),
        k_sz=k_sz, v_sz=v_sz, scale=scale)

"""Plain PyTorch versions of dense and paged GQA attention (the
counterpart of `repro.kernels.flash_attention.ref`), with the Pallas
kernels' masking semantics: masked logits are -1e30, not -inf, and the
softmax denominator is clamped at 1e-30, so a fully masked row stays
finite.

The paged chunked-prefill versions include the UNFUSED insert-then-attend
sequence that the fused chunk kernels collapse into one pass: the chunk's
pages are scattered into the pool (in place, where the reference returns
a new array), then the gather-only attention runs. int8 pools dequantize
to float32, as the kernels do."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention.ref import (
    gather_pages,
    gather_pages_q8,
)

NEG_INF = -1e30


def _masked_attention(q, k, v, mask, scale, return_lse=False):
    """float32 masked-softmax GQA attention: q (B,Sq,H,D), k/v
    (B,Skv,KV,D), `mask` None or broadcastable to (B,H,Sq,Skv). Output in
    q's dtype (and the (B,H,Sq) lse)."""
    H, D = q.shape[2], q.shape[3]
    KV = k.shape[2]
    if H % KV:
        raise ValueError(f"num_heads {H} not a multiple of kv heads {KV}")
    rep = H // KV
    scale = scale if scale is not None else D ** -0.5
    kq = k.repeat_interleave(rep, dim=2).float()      # GQA: kv -> q heads
    vq = v.repeat_interleave(rep, dim=2).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kq) * scale
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l_safe = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    out = torch.einsum("bhqk,bkhd->bhqd", p, vq) / l_safe
    out = out.permute(0, 2, 1, 3).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l_safe))[..., 0]
    return out


def mha(
    q: torch.Tensor,          # (B, Sq, H, D)
    k: torch.Tensor,          # (B, Skv, KV, D)
    v: torch.Tensor,          # (B, Skv, KV, D)
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    kv_offset: int = 0,      # absolute position of q[0] relative to k[0]
    return_lse: bool = False,
):
    """Masked-softmax attention in float32. Returns the output in q's
    dtype, and with `return_lse` also the (B, H, Sq) float32 log-sum-exp
    the flash kernel writes."""
    Sq, Skv = q.shape[1], k.shape[1]
    mask = None
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None] + kv_offset
        kpos = torch.arange(Skv, device=q.device)[None, :]
        mask = qpos >= kpos
    return _masked_attention(q, k, v, mask, scale, return_lse)


# ------------------------------------------------ paged chunked prefill
def _chunk_phys(block_tables, c0, n_wp: int, page_tokens: int):
    """(B, n_wp) physical pages the table assigns to the page-aligned
    chunks starting at `c0` (B,)."""
    pages = (c0.long()[:, None] // page_tokens
             + torch.arange(n_wp, device=c0.device)[None, :])
    return torch.gather(block_tables.long(), 1, pages)


def scatter_chunk_pages(pool: torch.Tensor, new: torch.Tensor, block_tables,
                        c0, page_tokens: int) -> torch.Tensor:
    """Write a page-aligned chunk `new` (B, C, ...) into the physical pool
    (P_phys, page_tokens, ...) at the pages `block_tables` (B, n_pages)
    assigns to [c0, c0+C), in place; returns `pool`. `c0` (B,)
    page-aligned chunk starts; the chunks' pages must be uniquely
    owned."""
    B, C = new.shape[:2]
    n_wp = C // page_tokens
    phys = _chunk_phys(block_tables, c0, n_wp, page_tokens)
    tiles = new.reshape((B, n_wp, page_tokens) + tuple(new.shape[2:]))
    pool[phys] = tiles.to(pool.dtype)
    return pool


def scatter_chunk_sz(pool_sz: torch.Tensor, sz_new: torch.Tensor,
                     block_tables, c0, page_tokens: int) -> torch.Tensor:
    """Scatter the chunk's per-page (scale, zero) rows (B, n_wp, KV, 2)
    into the pool-wide (P_phys, KV, 2), in place; returns `pool_sz`."""
    n_wp = sz_new.shape[1]
    phys = _chunk_phys(block_tables, c0, n_wp, page_tokens)
    pool_sz[phys] = sz_new.to(pool_sz.dtype)
    return pool_sz


def paged_prefill_mha(q, k_pages, v_pages, block_tables, c0, *,
                      k_sz=None, v_sz=None,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Gather the page pool to a dense cache (dequantizing int8 pools
    through `k_sz`/`v_sz`, per page or per token), then causal attention
    of the chunk q (B, C, H, D) at absolute positions [c0[b], c0[b]+C)
    against it. `c0` (B,) stays on the device: the causal mask is built
    per batch row. Every block-table entry must name a real page (ops
    clamps the ones above the frontier)."""
    C = q.shape[1]
    if k_sz is not None:
        k = gather_pages_q8(k_pages, k_sz, block_tables)
        v = gather_pages_q8(v_pages, v_sz, block_tables)
    else:
        k = gather_pages(k_pages, block_tables)    # (B, Skv, KV, D)
        v = gather_pages(v_pages, block_tables)
    Skv = k.shape[1]
    qpos = (c0.long()[:, None]
            + torch.arange(C, device=q.device)[None, :])       # (B, C)
    mask = qpos[:, :, None] >= torch.arange(Skv, device=q.device)
    return _masked_attention(q, k, v, mask[:, None], scale)


def paged_prefill_insert_mha(q, k_pages, v_pages, k_new, v_new,
                             block_tables, c0, *,
                             scale: Optional[float] = None):
    """UNFUSED version of the fused fp insert+attend kernel: scatter the
    chunk's K/V (B, C, KV, D) into the pools in place, then gather-attend.
    Returns (o, k_pages, v_pages)."""
    page = k_pages.shape[1]
    scatter_chunk_pages(k_pages, k_new, block_tables, c0, page)
    scatter_chunk_pages(v_pages, v_new, block_tables, c0, page)
    o = paged_prefill_mha(q, k_pages, v_pages, block_tables, c0,
                          scale=scale)
    return o, k_pages, v_pages


def paged_prefill_insert_mha_q8(q, k_pages, v_pages, k_sz, v_sz,
                                k8_new, v8_new, ksz_new, vsz_new,
                                block_tables, c0, *,
                                scale: Optional[float] = None):
    """UNFUSED version of the fused int8 insert+attend kernel: scatter the
    payload and its per-page (scale, zero) rows in place, then
    dequant-gather-attend. Returns (o, k_pages, v_pages, k_sz, v_sz)."""
    page = k_pages.shape[1]
    scatter_chunk_pages(k_pages, k8_new, block_tables, c0, page)
    scatter_chunk_pages(v_pages, v8_new, block_tables, c0, page)
    scatter_chunk_sz(k_sz, ksz_new, block_tables, c0, page)
    scatter_chunk_sz(v_sz, vsz_new, block_tables, c0, page)
    o = paged_prefill_mha(q, k_pages, v_pages, block_tables, c0,
                          k_sz=k_sz, v_sz=v_sz, scale=scale)
    return o, k_pages, v_pages, k_sz, v_sz

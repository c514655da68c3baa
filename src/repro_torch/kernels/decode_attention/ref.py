"""Plain PyTorch version of single-token decode attention against a paged
KV pool (the counterpart of `repro.kernels.decode_attention.ref`).

It follows the Pallas kernel's arithmetic: pages are gathered through the
block table and dequantized to float32 (`q * scale + zero` per page or
per token), logits past each sequence's length are -1e30 (not -inf) and
the softmax denominator is clamped at 1e-30.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import quant

NEG_INF = -1e30


def gather_pages(pages: torch.Tensor, block_tables: torch.Tensor
                 ) -> torch.Tensor:
    """Dense (B, S, KV, D) cache from a physical page pool
    (P_phys, page, KV, D) through (B, n_logical) block tables."""
    g = pages[block_tables.long()]          # (B, n_logical, page, KV, D)
    B, n, page, KV, D = g.shape
    return g.reshape(B, n * page, KV, D)


def gather_pages_q8(pages: torch.Tensor, sz: torch.Tensor,
                    block_tables: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """`gather_pages` for an int8 pool, dequantized through ``sz``:
    per-page (P_phys, KV, 2) or per-token (P_phys, page, KV, 2)."""
    bt = block_tables.long()
    g = pages[bt]                           # (B, n_logical, page, KV, D)
    s = sz[bt]
    if sz.dim() == pages.dim():             # per-token sub-scales
        d = quant.dequantize_tokens(g, s, dtype=dtype)
    else:                                   # per-page (B, n, KV, 2)
        d = quant.dequantize_pages(g, s, dtype=dtype)
    B, n, page, KV, D = d.shape
    return d.reshape(B, n * page, KV, D)


def decode_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lengths: torch.Tensor, *, scale: Optional[float] = None,
               return_lse: bool = False):
    """q (B, H, D) vs a dense cache k/v (B, S, KV, D) with per-sequence
    valid `lengths` (B,); float32 softmax, output in q's dtype. With
    `return_lse` also the (B, H) float32 log-sum-exp m + log(l) of the
    scaled logits (a row of length 0: -1e30, whose log(S) is below
    float32's spacing there)."""
    B, H, D = q.shape
    _, S, KV, _ = k.shape
    R = H // KV
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, KV, R, D).float()
    logits = torch.einsum("bgrd,bsgd->bgrs", qg, k.float()) * scale
    mask = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bgrs,bsgd->bgrd", p, v.float()) / torch.clamp_min(
        l, 1e-30)
    out = out.reshape(B, H, D).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l)).reshape(B, H)
    return out


def paged_decode_mha(q, k_pages, v_pages, block_tables, lengths, *,
                     k_sz=None, v_sz=None, scale=None) -> torch.Tensor:
    """Gather the pool to dense (dequantizing int8 pools), then the dense
    masked softmax. `block_tables` must already name real pages for every
    entry (ops clamps dead entries to page 0)."""
    if k_sz is not None:
        k = gather_pages_q8(k_pages, k_sz, block_tables)
        v = gather_pages_q8(v_pages, v_sz, block_tables)
    else:
        k = gather_pages(k_pages, block_tables)
        v = gather_pages(v_pages, block_tables)
    return decode_mha(q, k, v, lengths, scale=scale)

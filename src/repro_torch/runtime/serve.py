"""Engine cells of the continuous-batching serving engine (port of the
meshless paged path of `repro.runtime.serve.make_engine_cells`).

The cells are plain functions over tensors: one greedy decode cell over
the whole slot batch with per-slot positions, one prefill cell per prompt
bucket, one paged insert cell per bucket, a copy-on-write page copy and,
with `prefill_chunk` set, a chunked-prefill cell that runs one
page-aligned prompt chunk through the paged-prefill kernels (the chunk's
K/V write is fused into the kernel on per-page pools).
The self-attention KV cache IS a physical page pool (nb, n_slots *
n_pages, page_tokens, KV, hd) and every cell takes the live
(n_slots, n_pages) block table from `serving.kv_pager.KVPager`. PyTorch
runs eagerly, so there is no compile step; the cells write the pool in
place where the reference's jitted cells donate and return it.

Not ported yet: the contiguous layout (`paged=False`, ROADMAP A7b),
speculative verify/draft cells (A8) and mesh sharding (A16).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import resolve_device
from repro_torch.kernels import quant
from repro_torch.kernels.page_io import ops as page_ops
from repro_torch.models import blocks as blk
from repro_torch.models import model as M


def chunked_prefill_supported(cfg: ModelConfig) -> bool:
    """Chunked prefill needs a pure-attention decoder with no frontend
    prefix and no encoder: an SSM/conv layer's prompt pass is a
    sequential reduction that cannot restart mid-stream from paged KV
    alone."""
    if cfg.num_encoder_layers or cfg.frontend:
        return False
    return all(cfg.is_attn_layer(j) for j in range(blk.super_period(cfg)))


def build_prefill_greedy(cfg: ModelConfig, bucket: int):
    """Prefill cell for one prompt bucket: returns the request's decode
    caches (seq extent `bucket`) and its greedy first token. Prompts must
    be exactly `bucket` long (see serving.batcher)."""

    def cell(params, batch):
        caches, logits = M.prefill(params, batch, cfg, max_seq=bucket)
        return caches, torch.argmax(logits, dim=-1).to(torch.int32)

    return cell


def build_decode_greedy_paged(cfg: ModelConfig, page_tokens: int):
    """Greedy decode cell over the PAGED caches: one token per slot, the
    argmax and a per-slot finiteness flag computed on the device (argmax
    of NaN logits would otherwise turn a numerical blow-up into silently
    wrong tokens; parked slots carry garbage, so the engine masks them).
    `torch.argmax` takes the first maximum, as `jnp.argmax` does."""

    def cell(params, token, caches, t, block_table):
        logits, caches = M.decode_step(
            params, token, caches, t, cfg,
            block_table=block_table, page_tokens=page_tokens,
        )
        finite = torch.isfinite(logits).all(dim=-1)
        return torch.argmax(logits, dim=-1).to(torch.int32), finite, caches

    return cell


def build_paged_cache_insert(bucket_total: int, page_tokens: int,
                             pool_dtype: str = "fp",
                             sz_granularity: str = "page"):
    """Land a prefilled request's caches in the PAGED layout: its
    `bucket_total` tokens of K/V go whole-page into the pool at the pages
    the block table assigns to the slot, through the page writer
    (`kernels.page_io.write_pages`, in place). int8 pools quantize the
    prompt pages first (`quant.quantize_pages`, or `quantize_tokens` for
    per-token sub-scales) and the (scale, zero) rows land through the
    same writer. The partial last page is zero-padded: masked out of
    attention, and under int8 it cannot widen the page's range."""
    n_wp = -(-bucket_total // page_tokens)     # pages the prompt spans
    pad = n_wp * page_tokens - bucket_total
    quantized = pool_dtype == "int8"
    per_token = quantized and sz_granularity == "token"

    def page_tiles(small):
        sm = small[:, 0]                       # (nb, bucket_total, KV, hd)
        sm = torch.nn.functional.pad(sm, (0, 0, 0, 0, 0, pad))
        nb, _, kv, hd = sm.shape
        return sm.reshape(nb, n_wp, page_tokens, kv, hd)

    def insert(caches, slot_caches, slot, block_table):
        phys = block_table[int(slot), :n_wp]
        for pos, c in caches.items():
            for key in ("k", "v"):
                tiles = page_tiles(slot_caches[pos][key])
                if quantized:
                    q8, sz_rows = (quant.quantize_tokens(tiles) if per_token
                                   else quant.quantize_pages(tiles))
                    page_ops.write_pages(c[key], q8, phys)
                    page_ops.write_pages(c[key + "_sz"], sz_rows, phys)
                else:
                    page_ops.write_pages(c[key], tiles, phys)
        return caches

    return insert


def build_page_copy():
    """Copy one PHYSICAL page (payload + int8 scale/zero rows) to another,
    in place — the copy-on-write cell behind shared prefix pages."""

    def copy(caches, src, dst):
        for c in caches.values():
            for key in ("k", "v", "k_sz", "v_sz"):
                if key in c:
                    c[key][:, int(dst)] = c[key][:, int(src)]
        return caches

    return copy


def build_prefill_chunk(cfg: ModelConfig, page_tokens: int):
    """Chunked-prefill cell: one page-aligned chunk of one request's
    prompt against the global PAGED caches — no per-request caches, no
    insert step; the chunk's K/V goes straight through the slot's block
    row into the pool, in place. Returns the chunk's last-token greedy
    pick (the engine uses it only on the final chunk)."""

    def cell(params, tokens, caches, slot, chunk_idx, block_table):
        row = block_table[int(slot):int(slot) + 1]      # (1, n_pages)
        logits, caches = M.prefill_chunk(
            params, tokens, caches, chunk_idx, cfg, row, page_tokens)
        return torch.argmax(logits, dim=-1).to(torch.int32), caches

    return cell


@dataclasses.dataclass
class EngineCells:
    """The cells of the continuous-batching engine (paged layout).

    `decode_fn(params, tok (S,), caches, t (S,), bt) -> (next_tok (S,),
    finite (S,), caches)`; `prefill_fns[bucket](params, batch) ->
    (slot_caches, tok (1,))`; `insert_fns[bucket](caches, slot_caches,
    slot, bt) -> caches`; `copy_fn(caches, src, dst) -> caches`;
    `chunk_fn(params, tokens (1, C), caches, slot, chunk_idx, bt) ->
    (tok (1,), caches)` when chunked prefill is on. Caches are written in
    place."""

    decode_fn: Any
    prefill_fns: Dict[int, Any]
    insert_fns: Dict[int, Any]
    copy_fn: Any
    abstract_caches: Any           # the cache tree on the meta device
    n_prefix: int                  # frontend prefix tokens (none ported)
    max_seq_total: int             # cache seq extent incl. n_prefix
    device: torch.device
    paged: bool = True
    page_tokens: int = 0
    n_pages: int = 0               # logical pages per slot
    pool_dtype: str = "fp"
    sz_granularity: str = "page"
    chunk_fn: Any = None           # chunked-prefill cell
    chunk: int = 0                 # tokens per prefill chunk


def make_engine_cells(cfg: ModelConfig, *, n_slots: int, max_seq: int,
                      buckets: Sequence[int], paged: bool = True,
                      page_tokens: int = 16, prefill_chunk: int = 0,
                      pool_dtype: str = "fp", sz_granularity: str = "page",
                      speculative: str = "off", device=None) -> EngineCells:
    """Build the engine's cells for `device` (the card by default).
    `prefill_chunk > 0` (paged, attention-only archs) adds the
    chunked-prefill cell."""
    blk.check_supported(cfg)
    blk.pool_kv_dtype(cfg, pool_dtype)         # validate early
    if prefill_chunk and not paged:
        raise ValueError("chunked prefill requires the paged layout")
    if not paged:
        raise NotImplementedError(
            "the contiguous cache layout (paged=False) is not ported yet "
            "(ROADMAP A7b)")
    if prefill_chunk:
        if not chunked_prefill_supported(cfg):
            raise ValueError(
                f"{cfg.name}: chunked prefill needs an attention-only "
                "decoder without frontend/encoder"
            )
        if prefill_chunk % page_tokens:
            raise ValueError(
                f"prefill_chunk {prefill_chunk} must be a multiple of "
                f"page_tokens {page_tokens} (chunks write whole pages)"
            )
        bad = [b for b in buckets if b % prefill_chunk]
        if bad:
            raise ValueError(
                f"prefill_chunk {prefill_chunk} must divide every prompt "
                f"bucket (got {bad}): prompts advance whole chunks"
            )
    if speculative != "off":
        raise NotImplementedError(
            "speculative decoding is not ported yet (ROADMAP A8)")
    if sz_granularity not in ("page", "token"):
        raise ValueError(f"unknown sz_granularity {sz_granularity!r}")
    if sz_granularity == "token" and pool_dtype != "int8":
        raise ValueError("sz_granularity='token' applies to int8 pools only")
    device = resolve_device(device)
    npfx = 0
    max_seq_total = max_seq + npfx
    n_pages = -(-max_seq_total // page_tokens)
    acaches = M.make_paged_decode_caches(
        cfg, n_slots, max_seq_total, page_tokens, pool_dtype=pool_dtype,
        sz_granularity=sz_granularity, device="meta",
    )
    prefills, inserts = {}, {}
    for b in sorted(set(buckets)):
        prefills[b] = build_prefill_greedy(cfg, b)
        inserts[b] = build_paged_cache_insert(b + npfx, page_tokens,
                                              pool_dtype, sz_granularity)
    return EngineCells(
        decode_fn=build_decode_greedy_paged(cfg, page_tokens),
        prefill_fns=prefills,
        insert_fns=inserts,
        copy_fn=build_page_copy(),
        abstract_caches=acaches,
        n_prefix=npfx,
        max_seq_total=max_seq_total,
        device=device,
        page_tokens=page_tokens,
        n_pages=n_pages,
        pool_dtype=pool_dtype,
        sz_granularity=sz_granularity,
        chunk_fn=(build_prefill_chunk(cfg, page_tokens) if prefill_chunk
                  else None),
        chunk=prefill_chunk,
    )

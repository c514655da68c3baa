"""GQA self-attention for prefill, chunked prefill and decode over the
contiguous or the paged cache, and cross-attention for the
encoder-decoder arch (port of the serving path of
`repro.models.attention`).

The contraction is delegated to `kernels.flash_attention` (bucket and
chunked prefill, the encoder and prefill-time cross-attention) and
`kernels.decode_attention` (contiguous and paged decode, decode-time
cross-attention against the fixed encoder K/V), which launch the CUDA
kernels on CUDA tensors and the plain versions on CPU tensors.

The KV caches are updated IN PLACE where the reference's jitted cells
return new (donated) arrays: every insert below writes into the cache or
pool tensor it is given and returns that same tensor.

Over a mesh (`ctx`, `common.parallel`) the weights are the rank's local
shards: wq / wk / wv column-parallel over their heads, wo row-parallel
with a sum over the model axis; which is sharded is read off the local
shapes against the config's head counts. A rank attends with its own
query heads to the KV heads its GQA groups need (`sharded_mha`); the
paged pool holds the rank's KV heads (`runtime.sharding.
paged_cache_pspec`). Where the heads cannot be split into whole groups
the rank gathers every query head and attends whole, as the reference
keeps such heads whole.

In training (`self_attention(..., local_batch=True)`: x holds the rank's
rows) a split of the query heads is a TP region: x enters it through
`parallel.enter_region`, and K / V weights replicated over the model
axis (the `group` and `whole` layouts, where each rank attends with its
own groups only) enter it too, so their gradients sum the ranks' parts.
Every weight's embed dim split over the fsdp axis is gathered after the
cast (`parallel.gather_param`).
"""

from __future__ import annotations

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.parallel import (
    SINGLE,
    ParallelCtx,
    all_gather,
    enter_region,
    gather_param,
    psum,
)
from repro_torch.kernels import quant
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import apply_rope
from repro_torch.models.module import Initializer, torch_dtype


def attn_init(init: Initializer, cfg: ModelConfig, cross: bool = False):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    init.param("wq", (d, h, hd), ("embed", "qheads", "head_dim"))
    init.param("wk", (d, kv, hd), ("embed", "kvheads", "head_dim"))
    init.param("wv", (d, kv, hd), ("embed", "kvheads", "head_dim"))
    init.param("wo", (h, hd, d), ("qheads", "head_dim", "embed"))
    if cfg.qkv_bias and not cross:
        init.param("bq", (h, hd), ("qheads", "head_dim"), init="zeros")
        init.param("bk", (kv, hd), ("kvheads", "head_dim"), init="zeros")
        init.param("bv", (kv, hd), ("kvheads", "head_dim"), init="zeros")


def _qkv(params, x, cfg: ModelConfig, positions, rope: bool,
         ctx: ParallelCtx = SINGLE):
    dt, d = x.dtype, x.shape[-1]
    q, k, v = (torch.einsum("bsd,dhk->bshk", x, gather_param(
        params[n].to(dt), ctx, 0, d)) for n in ("wq", "wk", "wv"))
    if "bq" in params:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _groups(H: int, KV: int, H_loc: int, ctx: ParallelCtx):
    """How a rank holding query heads [s*H_loc, (s+1)*H_loc) of H reaches
    its KV heads: ("local", g0, G) when they are whole GQA groups
    g0..g0+G-1, ("group", g0, 1) when they sit inside one group, and
    ("whole", 0, KV) when neither holds (every query head is gathered and
    attention runs whole)."""
    R = H // KV
    s = ctx.index(ctx.tp_axis)
    if H_loc % R == 0:
        return "local", (s * H_loc) // R, H_loc // R
    if R % H_loc == 0:
        return "group", (s * H_loc) // R, 1
    return "whole", 0, KV


def sharded_mha(q, k, v, ctx: ParallelCtx = SINGLE, *, causal: bool = True,
                heads=None, local_batch: bool = False):
    """Flash attention of the rank's shard (the counterpart of the
    reference's `shard_map` body). q (B, S, H_q, D) holds the rank's
    query heads, k / v (B, S, KV_k, D) the KV heads it computed; `heads`
    = (H, KV), the config's global counts (default: q's and k's own, no
    head split). Heads go over the tp axis with local GQA group slicing:
    the rank's KV heads are exactly its groups, or it slices the one
    group it needs from replicated KV, or (heads not on whole or aligned
    groups) it gathers every query head, attends whole and keeps its
    own. The batch goes over the dp axes when B divides by their size
    (rows gathered back after), unless `local_batch` says q already
    holds only this rank's rows (training). Returns (B, S, H_q, D)."""
    B = q.shape[0]
    H, KV = heads or (q.shape[2], k.shape[2])
    if ctx.mesh is None:
        return flash_ops.mha(q, k, v, causal=causal)
    r0, r1 = (0, B) if local_batch else ctx.batch_rows(B)
    split = (r0, r1) != (0, B)
    if split:
        q, k, v = q[r0:r1], k[r0:r1], v[r0:r1]
    H_loc = q.shape[2]
    if H_loc == H:
        out = flash_ops.mha(q, k, v, causal=causal)
    else:
        mode, g0, G = _groups(H, KV, H_loc, ctx)
        if mode == "whole":
            s = ctx.index(ctx.tp_axis)
            full = all_gather(q, ctx, ctx.tp_axis, 2)
            out = flash_ops.mha(full, k, v, causal=causal)
            out = out[:, :, s * H_loc:(s + 1) * H_loc]
        else:
            if k.shape[2] != G:             # replicated KV: take the groups
                k = k[:, :, g0:g0 + G]
                v = v[:, :, g0:g0 + G]
            out = flash_ops.mha(q, k, v, causal=causal)
    if split:
        out = all_gather(out, ctx, ctx.dp_axes, 0)
    return out


def _out_proj(out, params, ctx: ParallelCtx, eq: str, cfg: ModelConfig):
    """The output projection: row-parallel (a partial sum, reduced over
    the tp axis) when wo holds a shard of the query heads."""
    wo = gather_param(params["wo"].to(out.dtype), ctx, 2, cfg.d_model)
    y = torch.einsum(eq, out, wo)
    if params["wo"].shape[0] != cfg.num_heads:
        y = psum(y, ctx, ctx.tp_axis)
    return y


def self_attention(params, x, cfg: ModelConfig, positions=None,
                   causal: bool = True, rope: bool = True,
                   return_kv: bool = False, ctx: ParallelCtx = SINGLE,
                   local_batch: bool = False):
    """Full-sequence self-attention (training, prefill): x (B, S, d).
    Over a mesh the returned k / v hold the rank's KV heads;
    `local_batch`: x holds only this rank's rows (the train step's)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    if params["wq"].shape[1] != cfg.num_heads:      # heads split: TP region
        x = enter_region(x, ctx, ctx.tp_axis)
        if params["wk"].shape[1] == cfg.num_kv_heads:   # KV replicated
            params = dict(params, **{
                n: enter_region(params[n], ctx, ctx.tp_axis)
                for n in ("wk", "wv", "bk", "bv") if n in params})
    q, k, v = _qkv(params, x, cfg, positions, rope, ctx)
    out = sharded_mha(q, k, v, ctx, causal=causal,
                      heads=(cfg.num_heads, cfg.num_kv_heads),
                      local_batch=local_batch)
    out = _out_proj(out, params, ctx, "bshk,hkd->bsd", cfg)
    if return_kv:
        return out, (k, v)
    return out


def cross_attention(params, x, enc_kv, cfg: ModelConfig,
                    ctx: ParallelCtx = SINGLE, local_batch: bool = False):
    """Decoder states x (B, Sq, d) against the encoder's K/V
    (B, Senc, KV, hd) each, precomputed by `encode_cross_kv`; no RoPE, no
    mask. Over a mesh wq is column-parallel (the rank's query heads), the
    K/V hold the rank's KV heads (`encode_cross_kv`), attention runs as
    `sharded_mha(causal=False)` and wo is row-parallel. A split of the
    query heads is a TP region, which x enters."""
    dt, d = x.dtype, x.shape[-1]
    if params["wq"].shape[1] != cfg.num_heads:
        x = enter_region(x, ctx, ctx.tp_axis)
    q = torch.einsum("bsd,dhk->bshk", x,
                     gather_param(params["wq"].to(dt), ctx, 0, d))
    k, v = enc_kv
    out = sharded_mha(q, k, v, ctx, causal=False,
                      heads=(cfg.num_heads, cfg.num_kv_heads),
                      local_batch=local_batch)
    return _out_proj(out, params, ctx, "bshk,hkd->bsd", cfg)


def encode_cross_kv(params, enc_out, cfg: ModelConfig,
                    ctx: ParallelCtx = SINGLE):
    """Cross-attention K/V from the encoder output (once per request); over
    a mesh the rank's KV heads where wk / wv split them. Where wq splits
    the query heads the K/V feed the rank's heads only (a TP region, as
    in `self_attention`): enc_out enters it, and wk / wv too where they
    are replicated."""
    dt, d = enc_out.dtype, enc_out.shape[-1]
    if params["wq"].shape[1] != cfg.num_heads:
        enc_out = enter_region(enc_out, ctx, ctx.tp_axis)
        if params["wk"].shape[1] == cfg.num_kv_heads:   # KV replicated
            params = dict(params, **{n: enter_region(params[n], ctx,
                                                     ctx.tp_axis)
                                     for n in ("wk", "wv")})
    k, v = (torch.einsum("bsd,dhk->bshk", enc_out,
                         gather_param(params[n].to(dt), ctx, 0, d))
            for n in ("wk", "wv"))
    return k, v


def decode_cross_attention(params, x, cross_kv, cfg: ModelConfig,
                           ctx: ParallelCtx = SINGLE,
                           seq_split: bool = False):
    """Decode-time cross-attention of x (B, 1, d) against the fixed
    encoder K/V (B, S_enc, KV, hd): every row attends to all S_enc keys,
    through the contiguous decode op.

    Over a mesh the K/V are the rank's shard of the slot-resident
    cross-KV. In the paged layout (`paged_cache_pspec`) they hold the
    rank's KV heads at every encoder position (every KV head where they
    do not divide over tp); in the contiguous one (`cache_pspec`) every
    KV head, at every encoder position where S_enc does not divide over
    tp. The rank decodes its query heads against them (`_pool_heads`:
    every query head, gathered, where they hold every KV head and its
    heads are not whole GQA groups of them). Where the contiguous layout
    splits S_enc (`seq_split`, read from the leaf's spec) the K/V hold
    every KV head at the rank's block of
    S_enc / tp encoder positions, every one of them live: q is gathered
    over tp, the rank decodes its block with the log-sum-exp and the
    ranks' blocks merge by it (`_merge_over_tp`, as
    `decode_self_attention` does). wo is row-parallel."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    k, v = cross_kv
    if seq_split and ctx.axis_size(ctx.tp_axis) > 1:
        H_loc = q.shape[2]
        if H_loc != cfg.num_heads:
            q = all_gather(q, ctx, ctx.tp_axis, 2)
        out, lse = decode_ops.decode_mha(q[:, 0], k, v, k.shape[1],
                                         return_lse=True)
        out = _merge_over_tp(out, lse, ctx, H_loc, q.dtype)
    else:
        q, unshard = _pool_heads(q[:, 0], ctx, cfg, k)
        out = decode_ops.decode_mha(q, k, v, k.shape[1])
        if unshard is not None:
            out = unshard(out)
    return _out_proj(out, params, ctx, "bhk,hkd->bd", cfg)[:, None, :]


def make_kv_cache(cfg: ModelConfig, batch: int, max_seq: int,
                  n_layers: int, dtype=None, device=None):
    """Stacked zero K/V caches (n_layers, batch, max_seq, KV, hd) for the
    attention layers of a model, in cfg.dtype unless `dtype` is given."""
    dtype = torch_dtype(dtype or cfg.dtype)
    shape = (n_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _cache_insert(cache, new, t, base: int = 0):
    """Write `new` (B, 1, KV, hd) into the contiguous cache (B, S, KV, hd)
    at position(s) t — a scalar shared by the batch or a (B,) vector of
    per-slot positions — in place. A position >= S writes nothing
    (parked slots), as the reference's iota mask does: the row at the
    clamped position is read back and rewritten unchanged, so no host
    sync is needed to find the live rows. Over a mesh whose tp axis
    splits the sequence the cache holds the rank's block of positions,
    starting at `base`, and t is global: a position outside the block
    writes nothing (the reference's iota mask on the sharded cache).
    Returns `cache`."""
    B, S = cache.shape[0], cache.shape[1]
    t_vec = _t_vec(t, B, cache.device) - base
    pos = t_vec.clamp(0, S - 1)
    rows = torch.arange(B, device=cache.device)
    live = ((t_vec >= 0) & (t_vec < S))[:, None, None]
    cache[rows, pos] = torch.where(live, new[:, 0].to(cache.dtype),
                                   cache[rows, pos])
    return cache


def decode_self_attention(params, x, cfg: ModelConfig, k_cache, v_cache, t,
                          rope: bool = True, ctx: ParallelCtx = SINGLE,
                          seq_split: bool = False):
    """Single-token decode against the contiguous caches: insert the new
    K/V at position(s) t (in place), then attend to the prefix through
    the decode op with valid lengths t + 1. x (B, 1, d); k/v_cache
    (B, S_max, KV, hd); t scalar or (B,) — per-slot positions and length
    masks for the serving engine's slot batch. Returns (out (B, 1, d),
    (k_cache, v_cache)).

    Over a mesh (`runtime.sharding.cache_pspec`) x, t and the caches
    hold the rank's slots, and the caches every KV head. The new token's
    k and v are gathered over tp on their head dim where wk / wv split
    it. Where the caches' extent does not divide over tp (`seq_split`
    False, read from the leaves' spec) they hold every position: the
    rank writes k and v at t and decodes every query head, gathered over
    tp, against them, keeping its own (`_pool_heads`; no log-sum-exp, no
    merge). Where it divides (`seq_split`), rank r holds positions
    [r S_loc, (r + 1) S_loc): q is gathered over tp too, the rank writes
    k and v where t
    falls in its block, decodes its block with lengths clamp(t + 1 - r
    S_loc, 0, S_loc) and the log-sum-exp, and the ranks' outputs merge
    by it (`decode_ops.merge_blocks`: one gather of (out, lse) over tp,
    float32, in rank order). Rank 0 holds position 0, so every row has a
    block with a key. The rank keeps its own query heads for the
    row-parallel wo and its sum over tp. With tp 1 this is the meshless
    decode, op for op."""
    B = x.shape[0]
    t_vec = _t_vec(t, B, x.device)
    q, k, v = _qkv(params, x, cfg, t_vec[:, None], rope)
    if k.shape[2] != cfg.num_kv_heads:
        k, v = all_gather(torch.stack([k, v]), ctx, ctx.tp_axis, 3)
    if not seq_split or ctx.axis_size(ctx.tp_axis) == 1:
        _cache_insert(k_cache, k, t_vec)
        _cache_insert(v_cache, v, t_vec)
        q, unshard = _pool_heads(q[:, 0], ctx, cfg, k_cache)
        out = decode_ops.decode_mha(q, k_cache, v_cache, t_vec + 1)
        if unshard is not None:
            out = unshard(out)
    else:
        H_loc = q.shape[2]
        if H_loc != cfg.num_heads:
            q = all_gather(q, ctx, ctx.tp_axis, 2)
        S_loc = k_cache.shape[1]
        base = ctx.index(ctx.tp_axis) * S_loc
        _cache_insert(k_cache, k, t_vec, base)
        _cache_insert(v_cache, v, t_vec, base)
        length = (t_vec + 1 - base).clamp(0, S_loc)
        out, lse = decode_ops.decode_mha(q[:, 0], k_cache, v_cache, length,
                                         return_lse=True)
        out = _merge_over_tp(out, lse, ctx, H_loc, q.dtype)
    out = _out_proj(out, params, ctx, "bhk,hkd->bd", cfg)
    return out[:, None, :], (k_cache, v_cache)


def _merge_over_tp(out, lse, ctx: ParallelCtx, H_loc: int, dtype):
    """The decode over the union of the tp ranks' key blocks from each
    rank's (out (B, H, D), lse (B, H)) of every query head: one gather of
    (out, lse) over tp in float32, merged in rank order
    (`decode_ops.merge_blocks`); the rank keeps its own H_loc heads for
    the row-parallel wo (all of them where wq does not split them)."""
    both = all_gather(torch.cat([out.float(), lse[..., None]], -1)[None],
                      ctx, ctx.tp_axis, 0)
    out = decode_ops.merge_blocks(both[..., :-1], both[..., -1],
                                  dtype=dtype)
    if H_loc != out.shape[1]:
        s = ctx.index(ctx.tp_axis)
        out = out[:, s * H_loc:(s + 1) * H_loc]
    return out


def _t_vec(t, B: int, device) -> torch.Tensor:
    """Per-slot positions (B,) int64 from a scalar or a (B,) vector."""
    return torch.as_tensor(t, device=device).to(torch.int64).broadcast_to(
        (B,))


# ------------------------------------------------------- paged KV cache
def _page_coords(t_vec, block_table, page_tokens: int):
    """Per-slot (physical page, in-range mask, in-page offset) of write
    position(s) `t_vec` through the block table."""
    n_pages = block_table.shape[1]
    pidx = t_vec // page_tokens
    off = t_vec % page_tokens
    in_range = pidx < n_pages
    phys = torch.gather(block_table, 1,
                        pidx.clamp(0, n_pages - 1)[:, None])[:, 0]
    return phys.to(torch.int64), in_range, off


def _live_rows(in_range: torch.Tensor) -> torch.Tensor:
    """Indices of the slots whose write lands inside the table. Parked
    slots (cursor past the table) are dropped, as the reference's
    `mode="drop"` scatter drops them: an out-of-range index would raise
    on the CPU and assert on the card. On a CUDA tensor this waits for
    the device (one host sync per call)."""
    return in_range.nonzero()[:, 0]


def paged_cache_insert(pool, new, t, block_table, page_tokens: int):
    """Write one token of K or V per slot into a PHYSICAL page pool, in
    place. pool (P_phys, page, KV, hd); new (B, 1, KV, hd); t scalar or
    (B,) absolute position(s); block_table (B, n_pages). The write lands
    at pool[bt[b, t//page], t%page]; parked positions write nothing."""
    t_vec = _t_vec(t, new.shape[0], pool.device)
    phys, in_range, off = _page_coords(t_vec, block_table, page_tokens)
    rows = _live_rows(in_range)
    pool[phys[rows], off[rows]] = new[rows, 0].to(pool.dtype)
    return pool


def paged_quant_cache_insert(pool, sz, new, t, block_table,
                             page_tokens: int):
    """int8 twin of `paged_cache_insert`, in place. Per-page (scale, zero)
    quantization cannot splice one int8 row into a page whose range it
    may move, so the insert is a read-modify-write of the slot's tail
    page: dequantize it, zero the rows past the write cursor, land the
    token, requantize with a fresh (scale, zero). With per-token
    sub-scales (`sz` ranked like the pool) the token row quantizes on
    its own and lands as a plain scatter. Returns (pool, sz)."""
    B = new.shape[0]
    t_vec = _t_vec(t, B, pool.device)
    phys, in_range, off = _page_coords(t_vec, block_table, page_tokens)
    rows = _live_rows(in_range)
    if sz.dim() == pool.dim():               # per-token sub-scales
        q8, tsz = quant.quantize_tokens(new[:, 0].float())
        pool[phys[rows], off[rows]] = q8[rows]
        sz[phys[rows], off[rows]] = tsz[rows]
        return pool, sz
    phys_r = torch.where(in_range, phys, 0)  # safe gather, discarded
    page_f = quant.dequantize_pages(pool[phys_r], sz[phys_r])
    iota = torch.arange(page_tokens, device=pool.device)[None, :, None, None]
    off_b = off[:, None, None, None]
    page_f = torch.where(iota < off_b, page_f, 0.0)
    page_f = torch.where(iota == off_b, new.float(), page_f)
    q8, new_sz = quant.quantize_pages(page_f)
    pool[phys[rows]] = q8[rows]
    sz[phys[rows]] = new_sz[rows]
    return pool, sz


def paged_chunk_insert(pool, new, c0, block_row, page_tokens: int):
    """Write a page-aligned CHUNK of K or V (or its per-token (scale,
    zero) rows) through the block table, in place. pool (P_phys, page,
    ...); new (1, C, ...) with C a multiple of `page_tokens`; c0 the
    chunk start (device scalar or (1,), page-aligned); block_row
    (1, n_pages) the prefilling slot's table row. Whole pages land at
    once. Returns `pool`."""
    C = new.shape[1]
    n_wp = C // page_tokens
    p0 = torch.as_tensor(c0, device=pool.device).reshape(-1)[:1].long() \
        // page_tokens
    phys = block_row[0].long()[p0 + torch.arange(n_wp, device=pool.device)]
    tiles = new[0].reshape((n_wp, page_tokens) + tuple(new.shape[2:]))
    pool[phys] = tiles.to(pool.dtype)
    return pool


def _pool_heads(q, ctx: ParallelCtx, cfg: ModelConfig, pool):
    """The query heads a rank attends its pool with, and how to get its
    own heads back from the result: (q, unshard). q (..., H_q, D) along
    dim -2. The pool holds the rank's KV heads when its query heads are
    whole GQA groups; otherwise it holds every KV head (its head count
    does not divide the tp axis) and the rank attends with every query
    head, gathered."""
    H, H_loc = cfg.num_heads, q.shape[-2]
    if H_loc == H or pool.shape[-2] * (H // cfg.num_kv_heads) == H_loc:
        return q, None
    s = ctx.index(ctx.tp_axis)
    full = all_gather(q, ctx, ctx.tp_axis, q.dim() - 2)
    return full, (lambda out: out[..., s * H_loc:(s + 1) * H_loc, :])


def paged_prefill_chunk_attention(params, x, cfg: ModelConfig, cache, c0,
                                  block_row, page_tokens: int,
                                  rope: bool = True,
                                  ctx: ParallelCtx = SINGLE):
    """One prompt chunk x (1, C, d) at positions [c0, c0+C) against the
    paged cache, through the paged-prefill kernels. `c0` is a device
    tensor (scalar or (1,)), read by the kernels on the device; C and c0
    are page-aligned (the engine enforces `prefill_chunk % page_tokens ==
    0`). Three branches, by the pool:

    * int8 with per-token sub-scales (`k_sz` ranked like the pool): each
      chunk row quantizes on its own, payload and sz rows are scattered
      whole-page, then the gather-only kernel attends;
    * int8 with per-page (scale, zero): the chunk quantizes by page
      (`quant.quantize_pages`, elementwise), and the fused int8 kernel
      writes payload and rows while it attends;
    * fp: the fused kernel writes the chunk's K/V while it attends.

    The pool tensors in `cache` are written in place. Returns
    (out (1, C, d), cache)."""
    B, C, _ = x.shape
    c0 = torch.as_tensor(c0, device=x.device).to(torch.int32).reshape(-1)
    positions = c0[:, None].long() + torch.arange(C, device=x.device)[None]
    q, k, v = _qkv(params, x, cfg, positions.expand(B, C), rope)
    q, unshard = _pool_heads(q, ctx, cfg, cache["k"])
    if "k_sz" in cache and cache["k_sz"].dim() == cache["k"].dim():
        k8, ksz = quant.quantize_tokens(k.float())
        v8, vsz = quant.quantize_tokens(v.float())
        for key, val in (("k", k8), ("v", v8), ("k_sz", ksz),
                         ("v_sz", vsz)):
            paged_chunk_insert(cache[key], val, c0, block_row, page_tokens)
        out = flash_ops.paged_prefill_mha(
            q, cache["k"], cache["v"], block_row, c0,
            k_sz=cache["k_sz"], v_sz=cache["v_sz"])
    elif "k_sz" in cache:
        n_wp = C // page_tokens
        KV, hd = k.shape[2], k.shape[3]
        k8, ksz = quant.quantize_pages(k.reshape(B, n_wp, page_tokens, KV,
                                                 hd))
        v8, vsz = quant.quantize_pages(v.reshape(B, n_wp, page_tokens, KV,
                                                 hd))
        out = flash_ops.paged_prefill_insert_mha_q8(
            q, cache["k"], cache["v"], cache["k_sz"], cache["v_sz"],
            k8.reshape(B, C, KV, hd), v8.reshape(B, C, KV, hd), ksz, vsz,
            block_row, c0)[0]
    else:
        out = flash_ops.paged_prefill_insert_mha(
            q, cache["k"], cache["v"], k, v, block_row, c0)[0]
    if unshard is not None:
        out = unshard(out)
    return _out_proj(out, params, ctx, "bshk,hkd->bsd", cfg), cache


def paged_decode_self_attention(params, x, cfg: ModelConfig, cache, t,
                                block_table, page_tokens: int,
                                rope: bool = True,
                                ctx: ParallelCtx = SINGLE):
    """Single-token decode against the paged cache: insert the new K/V
    through the block table (in place), then gather-attend through the
    paged decode op. x (B, 1, d); cache {"k", "v"} pools
    (P_phys, page, KV, hd) plus "k_sz"/"v_sz" when int8; t scalar or
    (B,). Returns (out (B, 1, d), cache).

    Over a mesh whose dp axes split the slots, x holds only this rank's
    rows of the (n_slots, n_pages) `block_table` (and t covers every
    slot): the new K/V rows of every slot are gathered over the dp axes
    and land in the rank's pool, which every dp rank holds whole, so the
    replicas stay equal; the rank then attends for its own slots."""
    B = block_table.shape[0]
    t_all = _t_vec(t, B, x.device)
    r0, r1 = ctx.batch_rows(B) if x.shape[0] != B else (0, B)
    t_vec, bt = t_all[r0:r1], block_table[r0:r1]
    q, k, v = _qkv(params, x, cfg, t_vec[:, None], rope)
    if x.shape[0] != B:
        k, v = all_gather(torch.stack([k, v]), ctx, ctx.dp_axes, 1)
    q, unshard = _pool_heads(q, ctx, cfg, cache["k"])
    if "k_sz" in cache:
        paged_quant_cache_insert(cache["k"], cache["k_sz"], k, t_all,
                                 block_table, page_tokens)
        paged_quant_cache_insert(cache["v"], cache["v_sz"], v, t_all,
                                 block_table, page_tokens)
        out = decode_ops.paged_decode_mha(
            q[:, 0], cache["k"], cache["v"], bt, t_vec + 1,
            k_sz=cache["k_sz"], v_sz=cache["v_sz"],
        )
    else:
        paged_cache_insert(cache["k"], k, t_all, block_table, page_tokens)
        paged_cache_insert(cache["v"], v, t_all, block_table, page_tokens)
        out = decode_ops.paged_decode_mha(
            q[:, 0], cache["k"], cache["v"], bt, t_vec + 1)
    if unshard is not None:
        out = unshard(out)
    out = _out_proj(out, params, ctx, "bhk,hkd->bd", cfg)
    return out[:, None, :], cache

"""Engine cells of the continuous-batching serving engine (port of the
meshless path of `repro.runtime.serve.make_engine_cells`).

The cells are plain functions over tensors: one greedy decode cell over
the whole slot batch with per-slot positions, one prefill cell per prompt
bucket and one insert cell per bucket. PyTorch runs eagerly, so there is
no compile step; the cells write the caches in place where the
reference's jitted cells donate and return them.

Two cache layouts:

* paged (the default): the self-attention KV cache IS a physical page
  pool (nb, n_slots * n_pages, page_tokens, KV, hd), and every cell takes
  the live (n_slots, n_pages) block table from `serving.kv_pager.KVPager`
  — decode through the paged decode kernel, the insert through the page
  writer, a copy-on-write page copy and, with `prefill_chunk` set, a
  chunked-prefill cell that runs one page-aligned prompt chunk through
  the paged-prefill kernels;
* contiguous (`paged=False`): per-slot caches (nb, n_slots, max_seq, KV,
  hd); decode through the flash-decode kernel, the insert a slice copy.

SPECULATIVE DECODING (paged only): `build_decode_verify_paged` scores k
candidate tokens per slot in ONE paged-decode call by flattening (S, k)
candidates to S*k decode rows with positions t[s]+j and k-repeated
block-table rows; the "draft" proposer decodes a draft model against its
own contiguous scratch caches (`build_decode_draft`), whose seeded
weights live on the `EngineCells`. int8 pools must use per-token
sub-scales there (`sz_granularity="token"`), so a slot's k rows land in
its tail page without a per-page requantize.

Frontend archs: the vision prefix (`cfg.num_prefix_tokens` patch
embeddings) occupies the first cache rows of every slot, so the paged
insert lands `bucket + n_prefix` rows; an enc-dec arch keeps its
encoder's K/V slot-resident (extent `enc_len`, one prompt bucket).

The serve bundle (`make_bundle`: `build_prefill`, `build_decode` and
the meta params and caches, over one device or a mesh) is what the
dry-run traces.

MESH-SHARDED SERVING (`make_engine_cells(ctx=..., mesh=...)`): one
process per rank of a `DeviceMesh`, every cell running the rank's shard.
The parameters' specs come from the sharding rules (default
`ShardingRules.for_serving(data_axis=ctx.fsdp_axis, tp_axis=ctx.tp_axis)`),
the paged pool's from `runtime.sharding.paged_cache_pspec`: KV heads
over `model` (the int8 (scale, zero) leaves with them), the page axis
unsharded, so each `data` rank holds the whole pool of its heads; the
block tables, tokens and positions stay replicated (every rank runs the
same host loop). The decode cell splits the slots over the dp axes and
gathers the greedy tokens back; prefill (batch 1) and chunked prefill
run whole on every dp rank. The engine cuts its weights and pool into
the rank's shards with `runtime.sharding.shard_tree` (`EngineCells.
param_pspecs` / `cache_pspecs`). The contiguous layout over a mesh keeps
the caches of `runtime.sharding.cache_pspec`, the serve bundle's: slots
over the dp axes and, where the extent divides over `model`, the
sequence over it (every KV head at the rank's block of positions),
decided per leaf (`seq_split_leaves`): its decode merges the ranks'
blocks by their log-sum-exp (`models.attention.decode_self_attention`);
an extent that does not divide stays whole (every KV head at every
position), decoded with every query head gathered over `model` (the
rank keeps its own) and no merge. Its
insert turns a prefill's KV heads into the rank's block of positions or
the whole extent (`build_cache_insert`). Every stack of the catalog
serves over a mesh on either layout: dense, MoE, the vision prefix, SSM
(mamba2), hybrid (jamba) and encoder-decoder (seamless). Their
slot-resident leaves are the rank's shard of the same specs: its slots
over the dp axes; the SSM state its heads over `model` (every head,
where the rules cut a head across two ranks: `models.ssm`, trap (d)),
each conv tail its block of the channels; cross_k / cross_v its KV
heads in the paged layout and, in the contiguous one, every head at its
block of the encoder positions (at every position where they do not
divide) (the inserts cut a prefill's leaves to these shards:
`_resident_shard`). Speculative decoding runs over a mesh on
the paged layout: the verify cell's S*k rows split over the dp axes as
their slots do, and its (S, k) greedy picks come back gathered; the
draft model is replicated and runs whole on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import resolve_device
from repro_torch.common.parallel import SINGLE, ParallelCtx, all_gather
from repro_torch.kernels import quant
from repro_torch.kernels.page_io import ops as page_ops
from repro_torch.models import blocks as blk
from repro_torch.models import model as M
from repro_torch.models.module import cast_params
from repro_torch.runtime import sharding as shd


def abstract_params(cfg: ModelConfig, serve_dtype: bool = True,
                    with_axes: bool = False):
    """The parameter tree on the meta device (shapes and dtypes, nothing
    allocated); serving uses inference dtype (cfg.dtype) weights. Same
    leaf names, shapes and dtypes as the reference's `abstract_params`;
    `with_axes` returns (params, axes) as the reference does, the
    logical-axis tree beside them."""
    params, axes = M.init_model(cfg, device="meta", with_axes=True)
    if serve_dtype:
        params = cast_params(params, cfg.dtype)
    return (params, axes) if with_axes else params


def abstract_caches(cfg: ModelConfig, batch: int, max_seq: int,
                    enc_len: int = 0) -> dict:
    """The contiguous decode caches (batch slots of extent max_seq; cross-KV
    of extent enc_len for enc-dec archs) on the meta device."""
    return M.make_decode_caches(cfg, batch, max_seq, enc_len,
                                device="meta")


def build_prefill(cfg: ModelConfig, max_seq: int,
                  ctx: ParallelCtx = SINGLE):
    """prefill_step(params, batch) -> (caches, last-token logits): the
    model's prompt pass over a batch of equal-length prompts, its caches
    of seq extent `max_seq` (plus the vision prefix)."""

    def prefill_step(params, batch):
        return M.prefill(params, batch, cfg, max_seq, ctx)

    return prefill_step


def build_decode(cfg: ModelConfig, ctx: ParallelCtx = SINGLE,
                 seq_split=None):
    """decode_step(params, token, caches, t) -> (logits, caches): one
    decode step over the contiguous caches at position(s) t, the caches
    written in place. Over a mesh (`ctx.mesh`) params and caches are the
    rank's shards (the specs of `make_bundle`; `seq_split` the caches'
    `seq_split_leaves`), token and t every slot's or the rank's, and the
    logits the rank's slots' (`M.decode_step`)."""

    def decode_step(params, token, caches, t):
        return M.decode_step(params, token, caches, t, cfg, ctx=ctx,
                             seq_split=seq_split)

    return decode_step


@dataclasses.dataclass
class ServeBundle:
    """The serve steps and the meta trees they take; over a mesh also the
    params' and caches' specs (the reference's shardings), which cut the
    global trees into the rank's shards the steps take."""

    prefill_fn: Any
    decode_fn: Any
    abstract_params: Any
    abstract_caches: Any
    param_pspecs: Any = None
    cache_pspecs: Any = None


def _check_mesh(ctx: Optional[ParallelCtx], mesh):
    """The parallel context of a mesh build: `ctx` (its mesh must be
    `mesh`) or, given only the mesh, `launch.mesh.ctx_for_mesh`'s."""
    if mesh is None:
        if ctx is not None and ctx.mesh is not None:
            return ctx, ctx.mesh
        return ctx or SINGLE, None
    if not hasattr(mesh, "get_group"):
        raise TypeError(f"mesh must be a torch DeviceMesh or a "
                        f"launch.mesh.AbstractMesh, got "
                        f"{type(mesh).__name__}")
    if ctx is None:
        from repro_torch.launch.mesh import ctx_for_mesh

        ctx = ctx_for_mesh(mesh, remat="none")
    if ctx.mesh is not mesh:
        raise ValueError("ctx.mesh is not the mesh given")
    return ctx, mesh


def make_bundle(cfg: ModelConfig, *, batch: int, max_seq: int,
                enc_len: int = 0, mesh=None, rules=None,
                ctx: Optional[ParallelCtx] = None) -> ServeBundle:
    """The prefill and decode steps and the meta params and caches (the
    reference's `make_bundle`). With a mesh (a `DeviceMesh`, or a
    `launch.mesh.AbstractMesh` for the dry-run; `ctx` defaults to
    `ctx_for_mesh(mesh)`): the params' specs from `rules` (default
    `for_serving(ctx.fsdp_axis, ctx.tp_axis)`), the caches' from
    `cache_pspec` (each attention leaf's sequence over the tp axis where
    it divides, whole where it does not), and both steps over the rank's
    shards. The prefill step's caches are the mesh prefill's (every
    prompt, the rank's KV heads, the whole sequence);
    `prefill_cache_shards` turns them into the decode step's shards."""
    ctx, mesh = _check_mesh(ctx, mesh)
    if mesh is None:
        if rules is not None:
            raise ValueError("rules shard over a mesh; none was given")
        return ServeBundle(build_prefill(cfg, max_seq), build_decode(cfg),
                           abstract_params(cfg),
                           abstract_caches(cfg, batch, max_seq, enc_len))
    rules = rules or shd.ShardingRules.for_serving(
        data_axis=ctx.fsdp_axis, tp_axis=ctx.tp_axis)
    aparams, axes = abstract_params(cfg, with_axes=True)
    acaches = abstract_caches(cfg, batch, max_seq, enc_len)
    cache_pspecs = shd.cache_pspec(acaches, ctx.dp_axes, ctx.tp_axis, mesh)
    return ServeBundle(
        build_prefill(cfg, max_seq, ctx),
        build_decode(cfg, ctx, seq_split_leaves(cache_pspecs)), aparams,
        acaches,
        param_pspecs=shd.pspecs_for_tree(aparams, axes, rules, mesh),
        cache_pspecs=cache_pspecs)


def _seq_split(seq_split, ctx: ParallelCtx) -> dict:
    """`seq_split` ({leaf name: bool}) of a contiguous decode or insert,
    required where a tp axis of size > 1 may split the caches' positions
    (it says which leaves it splits: `seq_split_leaves`)."""
    if seq_split is None:
        if ctx.axis_size(ctx.tp_axis) > 1:
            raise ValueError("the contiguous caches over a tp axis need "
                             "seq_split (seq_split_leaves of their specs)")
        return {}
    return seq_split


def seq_split_leaves(cache_pspecs) -> dict:
    """{leaf name: True where the contiguous caches' spec splits its
    positions over an axis} for the attention leaves ("k", "v",
    "cross_k", "cross_v") of a `cache_pspec` tree: the decode reads each
    such leaf as the rank's block of positions or, where `cache_pspec`
    keeps an extent that does not divide over tp whole, as every
    position."""
    return {key: c[key][2] is not None for c in cache_pspecs.values()
            for key in _SEQ_LEAVES if key in c}


def prefill_cache_shards(caches, ctx: ParallelCtx, n_kv: int,
                         seq_split: dict):
    """The rank's shard (`cache_pspec`) of the contiguous caches a mesh
    prefill returned (every prompt; the rank's KV heads of `n_kv` over
    the whole sequence or encoder; the rank's SSM heads, or every head
    where the rules cut one, and `tail_x` channels; `tail_B` / `tail_C`
    whole): its rows over the dp axes, and over the tp axis every KV
    head at its block of positions where `seq_split` (the caches'
    `seq_split_leaves`) names the leaf and at every position where it
    does not, its block of the tails' channels (`_resident_shard`)."""
    tp = ctx.axis_size(ctx.tp_axis)
    out = {}
    for pos, c in caches.items():
        out[pos] = {}
        for key, x in c.items():
            r0, r1 = ctx.batch_rows(x.shape[1])
            x = x[:, r0:r1]
            C, S = x.shape[-1], x.shape[2]
            split = seq_split.get(key, False)
            out[pos][key] = _resident_shard(
                key, x, ctx, C // tp if C % tp == 0 else C,
                seq=(n_kv, S // tp if split else S, split)).contiguous()
    return out


# the contiguous layout's leaves whose sequence (or encoder positions)
# the tp axis splits where it divides, and the leaves a prefill returns
# whole while the decode shard holds its block of their channels over tp
_SEQ_LEAVES = ("k", "v", "cross_k", "cross_v")
_CHANNEL_LEAVES = ("tail_B", "tail_C")


def _resident_shard(key, x, ctx: ParallelCtx, C_loc: int, seq=None):
    """A prefill's leaf `x` (its slot rows kept) as the decode shard's
    layout past the rows: on the contiguous layout (`seq` = (n_kv, S_loc,
    split)) a K / V leaf as every one of the n_kv KV heads at the rank's
    S_loc positions, or at the first S_loc where `split` is False (the
    leaf's extent stays whole) (`_kv_block`, a collective over tp where
    wk / wv split the heads); `tail_B` / `tail_C` as the rank's block of
    C_loc channels; every other leaf (the SSM state and `tail_x`, already
    the rank's heads and channels, or every head where the rules cut
    one; the paged layout's cross-KV, already its KV heads) as it is."""
    if seq is not None and key in _SEQ_LEAVES \
            and ctx.axis_size(ctx.tp_axis) > 1:
        return _kv_block(x, ctx, *seq)
    if key in _CHANNEL_LEAVES and x.shape[-1] != C_loc:
        c0 = ctx.index(ctx.tp_axis) * C_loc
        return x[..., c0:c0 + C_loc]
    return x


def _kv_block(x, ctx: ParallelCtx, n_kv: int, S_loc: int, split: bool):
    """A prefill's K or V leaf (nb, B, S, KV_loc, hd) as every one of the
    `n_kv` KV heads (gathered over tp where wk / wv split them: every
    rank of the axis calls it) at the rank's block [r S_loc, (r + 1)
    S_loc) of the sequence (`split`), or at its first S_loc positions
    (the whole extent); positions past S are not there."""
    if x.shape[3] != n_kv:
        x = all_gather(x, ctx, ctx.tp_axis, 3)
    base = ctx.index(ctx.tp_axis) * S_loc if split else 0
    return x[:, :, base:base + S_loc]


def chunked_prefill_supported(cfg: ModelConfig) -> bool:
    """Chunked prefill needs a pure-attention decoder with no frontend
    prefix and no encoder: an SSM/conv layer's prompt pass is a
    sequential reduction that cannot restart mid-stream from paged KV
    alone."""
    if cfg.num_encoder_layers or cfg.frontend:
        return False
    return all(cfg.is_attn_layer(j) for j in range(blk.super_period(cfg)))


def build_prefill_greedy(cfg: ModelConfig, bucket: int,
                         ctx: ParallelCtx = SINGLE):
    """Prefill cell for one prompt bucket: returns the request's decode
    caches (seq extent `bucket` plus the frontend prefix; cross-KV extent
    follows the frames in the batch) and its greedy first token. The
    batch holds "tokens" and, for frontend archs, "patches" or "frames".
    Prompts must be exactly `bucket` long (see serving.batcher)."""

    def cell(params, batch):
        caches, logits = M.prefill(params, batch, cfg, max_seq=bucket,
                                   ctx=ctx)
        return caches, torch.argmax(logits, dim=-1).to(torch.int32)

    return cell


def build_decode_greedy(cfg: ModelConfig, ctx: ParallelCtx = SINGLE,
                        seq_split=None):
    """Greedy decode cell over the CONTIGUOUS caches: one token per slot,
    the argmax and a per-slot finiteness flag computed on the device
    (parked slots carry garbage, so the engine masks them). Over a mesh
    the rank decodes the slots its caches hold (`seq_split`: the caches'
    `seq_split_leaves`) and the tokens and flags of every slot are
    gathered over the dp axes, as the paged cell does."""

    def cell(params, token, caches, t):
        logits, caches = M.decode_step(params, token, caches, t, cfg,
                                       ctx=ctx, seq_split=seq_split)
        return (*_greedy_rows(logits, token.shape[0], ctx), caches)

    return cell


def _greedy_rows(logits, n: int, ctx: ParallelCtx):
    """(tokens (n,) int32, finite (n,)) of the rows' logits: the argmax
    (the first maximum, as `jnp.argmax`) and the finiteness flag, the
    rank's rows gathered over the dp axes where it holds fewer than n."""
    finite = torch.isfinite(logits).all(dim=-1)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    if tok.shape[0] != n:
        both = all_gather(torch.stack([tok, finite.to(torch.int32)]),
                          ctx, ctx.dp_axes, 1)
        tok, finite = both[0], both[1].bool()
    return tok, finite


def build_decode_greedy_paged(cfg: ModelConfig, page_tokens: int,
                              ctx: ParallelCtx = SINGLE):
    """Greedy decode cell over the PAGED caches: one token per slot, the
    argmax and a per-slot finiteness flag computed on the device (argmax
    of NaN logits would otherwise turn a numerical blow-up into silently
    wrong tokens; parked slots carry garbage, so the engine masks them).
    `torch.argmax` takes the first maximum, as `jnp.argmax` does. Over a
    mesh the rank decodes its block of the slots and the tokens and flags
    of every slot are gathered over the dp axes, so every rank returns
    the same (S,) vectors."""

    def cell(params, token, caches, t, block_table):
        logits, caches = M.decode_step(
            params, token, caches, t, cfg,
            block_table=block_table, page_tokens=page_tokens, ctx=ctx,
        )
        return (*_greedy_rows(logits, token.shape[0], ctx), caches)

    return cell


def build_decode_verify_paged(cfg: ModelConfig, page_tokens: int, k: int,
                              ctx: ParallelCtx = SINGLE):
    """SPECULATIVE VERIFY cell: score k candidate tokens per slot in ONE
    paged-decode call. `cand` (S, k) int32 with cand[s, 0] the slot's
    last emitted (not yet inserted) token and cand[s, 1:] the proposer's
    drafts; `t` (S,) the position cand[s, 0] will occupy. The (S, k)
    batch flattens to S*k decode rows: row j of slot s feeds cand[s, j]
    at position t[s]+j against the slot's own block-table row (repeated
    k times), so the insert lands all k candidates before attention and
    row j's length t+j+1 lets it see candidates 0..j. Returns (greedy
    (S, k) int32, finite (S,), caches), greedy[s, j] being the model's
    pick for position t[s]+j+1.

    Over a mesh the rows are slot-major, so where the dp axes split the
    S slots a rank decodes its slots' k rows each (`M.decode_step` takes
    its block of the S*k rows); the picks and flags of every row come
    back gathered over the dp axes (`_greedy_rows`), the same on every
    rank."""

    def cell(params, cand, caches, t, block_table):
        S = cand.shape[0]
        tok_flat = cand.reshape(S * k)
        t_flat = (t[:, None] + torch.arange(k, dtype=t.dtype,
                                            device=t.device)[None, :]
                  ).reshape(S * k)
        bt_flat = torch.repeat_interleave(block_table, k, dim=0)
        logits, caches = M.decode_step(
            params, tok_flat, caches, t_flat, cfg,
            block_table=bt_flat, page_tokens=page_tokens, ctx=ctx,
        )
        greedy, finite = _greedy_rows(logits, S * k, ctx)
        return greedy.reshape(S, k), finite.reshape(S, k).all(dim=1), caches

    return cell


def build_cache_insert(ctx: ParallelCtx = SINGLE, n_slots: int = 0,
                       seq_split=None):
    """Copy a prefilled request's caches (batch 1, seq extent `bucket`)
    into the CONTIGUOUS slot caches at slot index `slot`, positions
    [0, bucket), in place.

    Over a mesh the slot caches are the rank's shard of `cache_pspec`
    (its block of the `n_slots` slots over the dp axes, every KV head at
    its block of positions (encoder positions for the cross-KV) over tp
    where `seq_split` (the caches' `seq_split_leaves`) names the leaf and
    at every position where it does not, the SSM state's heads and the
    tails' channels over tp), while the prefill's caches hold the rank's
    KV heads over the whole bucket: the KV heads are gathered over tp
    (every rank calls it) and each rank keeps the positions of its block
    or all of them, and its tail channels (`_resident_shard`), on the dp
    rank that holds the slot."""
    row_of = _slot_row(ctx, n_slots)
    split = _seq_split(seq_split, ctx)

    def insert(caches, slot_caches, slot):
        row = row_of(slot)
        for pos, c in caches.items():
            for key, big in c.items():
                small = _resident_shard(key, slot_caches[pos][key], ctx,
                                        big.shape[-1],
                                        seq=(big.shape[3], big.shape[2],
                                             split.get(key, False)))
                if row is not None:
                    big[:, row, :small.shape[2]] = small[:, 0].to(big.dtype)
        return caches

    return insert


def _slot_row(ctx: ParallelCtx, n_slots: int):
    """slot -> its row in the rank's block of the `n_slots` slots over the
    dp axes, None on a rank that does not hold it (the slot itself where
    the dp axes do not split the slots)."""
    r0, r1 = ctx.batch_rows(n_slots)

    def row_of(slot):
        row = int(slot)
        if (r0, r1) != (0, n_slots):        # the dp axes split the slots
            return row - r0 if r0 <= row < r1 else None
        return row

    return row_of


def build_decode_draft(cfg: ModelConfig):
    """Draft-model decode cell for the speculative "draft" proposer: one
    greedy token per slot against the draft's own CONTIGUOUS caches (the
    draft prefix is short-lived scratch, so it skips the paged pool).
    The finite flag is dropped: a non-finite draft can only propose
    tokens the verify cell rejects. Over a mesh the draft's weights and
    caches are replicated and every rank runs this cell whole."""

    def cell(params, token, caches, t):
        logits, caches = M.decode_step(params, token, caches, t, cfg)
        return torch.argmax(logits, dim=-1).to(torch.int32), caches

    return cell


def build_paged_cache_insert(bucket_total: int, page_tokens: int,
                             pool_dtype: str = "fp",
                             sz_granularity: str = "page",
                             ctx: ParallelCtx = SINGLE, n_slots: int = 0):
    """Land a prefilled request's caches in the PAGED layout: its
    `bucket_total` tokens of K/V go whole-page into the pool at the pages
    the block table assigns to the slot, through the grouped page writer
    (`kernels.page_io.write_pages_group`, in place): k, v and the int8
    (scale, zero) rows of every attention position in ONE launch. int8
    pools quantize the prompt pages first (`quant.quantize_pages`, or
    `quantize_tokens` for per-token sub-scales). The partial last page is
    zero-padded: masked out of attention, and under int8 it cannot widen
    the page's range. Resident leaves (SSM state, conv tails, cross-KV)
    are copied densely into the slot. Over a mesh (`paged_cache_pspec`)
    the pool holds the rank's KV heads, which its prefill computed, and
    every dp rank writes it; a resident leaf holds the rank's block of
    the `n_slots` slots over the dp axes, so only the rank that holds the
    slot writes it, at its local row, `tail_B` / `tail_C` cut to its
    channel block (`_resident_shard`)."""
    n_wp = -(-bucket_total // page_tokens)     # pages the prompt spans
    pad = n_wp * page_tokens - bucket_total
    quantized = pool_dtype == "int8"
    per_token = quantized and sz_granularity == "token"

    def page_tiles(small):
        sm = small[:, 0]                       # (nb, bucket_total, KV, hd)
        sm = torch.nn.functional.pad(sm, (0, 0, 0, 0, 0, pad))
        nb, _, kv, hd = sm.shape
        return sm.reshape(nb, n_wp, page_tokens, kv, hd)

    row_of = _slot_row(ctx, n_slots)

    def insert(caches, slot_caches, slot, block_table):
        phys = block_table[int(slot), :n_wp]
        row = row_of(slot)
        pools, writes = [], []
        for pos, c in caches.items():
            for key, big in c.items():
                if key not in blk.PAGED_LEAF_NAMES and row is not None:
                    small = _resident_shard(key, slot_caches[pos][key],
                                            ctx, big.shape[-1])
                    big[:, row] = small[:, 0].to(big.dtype)
            if "k" not in c:
                continue
            for key in ("k", "v"):
                tiles = page_tiles(slot_caches[pos][key])
                if quantized:
                    q8, sz_rows = (quant.quantize_tokens(tiles) if per_token
                                   else quant.quantize_pages(tiles))
                    pools += [c[key], c[key + "_sz"]]
                    writes += [q8, sz_rows]
                else:
                    pools.append(c[key])
                    writes.append(tiles)
        if pools:
            page_ops.write_pages_group(pools, writes, phys)
        return caches

    return insert


def build_page_copy():
    """Copy one PHYSICAL page (payload + int8 scale/zero rows) to another,
    in place — the copy-on-write cell behind shared prefix pages."""

    def copy(caches, src, dst):
        for c in caches.values():
            for key in blk.PAGED_LEAF_NAMES:
                if key in c:
                    c[key][:, int(dst)] = c[key][:, int(src)]
        return caches

    return copy


def build_prefill_chunk(cfg: ModelConfig, page_tokens: int,
                        ctx: ParallelCtx = SINGLE):
    """Chunked-prefill cell: one page-aligned chunk of one request's
    prompt against the global PAGED caches — no per-request caches, no
    insert step; the chunk's K/V goes straight through the slot's block
    row into the pool, in place. Returns the chunk's last-token greedy
    pick (the engine uses it only on the final chunk)."""

    def cell(params, tokens, caches, slot, chunk_idx, block_table):
        row = block_table[int(slot):int(slot) + 1]      # (1, n_pages)
        logits, caches = M.prefill_chunk(
            params, tokens, caches, chunk_idx, cfg, row, page_tokens, ctx)
        return torch.argmax(logits, dim=-1).to(torch.int32), caches

    return cell


@dataclasses.dataclass
class EngineCells:
    """The cells of the continuous-batching engine.

    `decode_fn(params, tok (S,), caches, t (S,)[, bt]) -> (next_tok (S,),
    finite (S,), caches)` — the block table only on the paged layout;
    `prefill_fns[bucket](params, batch) -> (slot_caches, tok (1,))`;
    `insert_fns[bucket](caches, slot_caches, slot[, bt]) -> caches`;
    paged only: `copy_fn(caches, src, dst) -> caches`, `chunk_fn(params,
    tokens (1, C), caches, slot, chunk_idx, bt) -> (tok (1,), caches)`
    when chunked prefill is on, and with speculation `verify_fn(params,
    cand (S, k), caches, t (S,), bt) -> (greedy (S, k), finite (S,),
    caches)`; with the draft proposer `draft_fn(params, tok (S,), caches,
    t (S,)) -> (tok (S,), caches)`. Caches are written in place.

    Over a mesh (`ctx.mesh`): `param_pspecs` / `cache_pspecs` give the
    rank's shard of the global params and caches (`runtime.sharding.
    shard_tree`), and `abstract_caches` stays the global tree, whose
    bytes the pager prices."""

    decode_fn: Any
    prefill_fns: Dict[int, Any]
    insert_fns: Dict[int, Any]
    abstract_caches: Any           # the cache tree on the meta device
    n_prefix: int                  # frontend prefix tokens (vision)
    max_seq_total: int             # cache seq extent incl. n_prefix
    device: torch.device
    paged: bool = True
    page_tokens: int = 0
    n_pages: int = 0               # logical pages per slot (paged)
    pool_dtype: str = "fp"
    sz_granularity: str = "page"
    copy_fn: Any = None            # COW page copy (paged)
    chunk_fn: Any = None           # chunked-prefill cell
    chunk: int = 0                 # tokens per prefill chunk
    verify_fn: Any = None          # speculative verify cell
    spec_k: int = 0                # candidate tokens per verify call
    draft_fn: Any = None           # draft-proposer decode cell
    draft_params: Any = None       # draft weights (seed 0, draft dtype)
    draft_cfg: Any = None          # draft ModelConfig (sizes its caches)
    ctx: ParallelCtx = SINGLE      # the mesh the cells run over
    param_pspecs: Any = None       # (mesh) specs of the params' shards
    cache_pspecs: Any = None       # (mesh) specs of the caches' shards


def make_engine_cells(cfg: ModelConfig, *, n_slots: int, max_seq: int,
                      buckets: Sequence[int], enc_len: int = 0,
                      paged: bool = True,
                      page_tokens: int = 16, prefill_chunk: int = 0,
                      pool_dtype: str = "fp", sz_granularity: str = "page",
                      speculative: str = "off", spec_k: int = 4,
                      draft_cfg: ModelConfig | None = None,
                      device=None, ctx: Optional[ParallelCtx] = None,
                      mesh=None, rules=None) -> EngineCells:
    """Build the engine's cells for `device` (the card by default).
    `paged=False` builds the contiguous layout's cells; `prefill_chunk >
    0` (paged, attention-only archs) adds the chunked-prefill cell;
    `speculative` ("off" | "ngram" | "draft") adds the k-candidate verify
    cell and, for "draft", the draft cell and its weights (seed 0, cast
    to `draft_cfg.dtype`). `enc_len` sizes the slot-resident cross-KV of
    enc-dec archs, whose single prompt bucket fixes it.

    With `mesh` (a `DeviceMesh`; `ctx` defaults to `ctx_for_mesh(mesh)`)
    the cells run the rank's shard (module docstring): the params' specs
    from `rules` (default `ShardingRules.for_serving(data_axis=
    ctx.fsdp_axis, tp_axis=ctx.tp_axis)`), the pool's from
    `paged_cache_pspec`, the contiguous caches' from `cache_pspec` (each
    attention leaf's positions over the tp axis where its extent divides,
    every position where it does not)."""
    ctx, mesh = _check_mesh(ctx, mesh)
    if mesh is None and rules is not None:
        raise ValueError("rules shard over a mesh; none was given")
    blk.pool_kv_dtype(cfg, pool_dtype)         # validate early
    if pool_dtype != "fp" and not paged:
        raise ValueError("pool_dtype applies to the paged layout only")
    if sz_granularity not in ("page", "token"):
        raise ValueError(f"unknown sz_granularity {sz_granularity!r}")
    if sz_granularity == "token" and pool_dtype != "int8":
        raise ValueError("sz_granularity='token' applies to int8 pools only")
    if speculative not in ("off", "ngram", "draft"):
        raise ValueError(f"unknown speculative mode {speculative!r}")
    if speculative != "off":
        if not paged:
            raise ValueError("speculative decoding requires the paged layout")
        if not chunked_prefill_supported(cfg):
            raise ValueError(
                f"{cfg.name}: speculative decoding needs an attention-only "
                "decoder without frontend/encoder (the verify cell batches "
                "S*k rows, which SSM/conv state cannot follow)"
            )
        if spec_k < 2:
            raise ValueError("spec_k must be >= 2 (k=1 is plain greedy)")
        if pool_dtype == "int8" and sz_granularity != "token":
            raise ValueError(
                "speculative + int8 pools need sz_granularity='token': the "
                "per-page requantize round trip would make a slot's k "
                "candidate rows read-modify-write the same tail page"
            )
        if speculative == "draft" and draft_cfg is None:
            raise ValueError("speculative='draft' needs a draft_cfg")
    npfx = cfg.num_prefix_tokens if cfg.frontend == "vision_stub" else 0
    if cfg.num_encoder_layers and len(set(buckets)) != 1:
        raise ValueError(
            "enc-dec archs need a single prefill bucket (cross-KV extent "
            "is fixed by the encoder length)"
        )
    if prefill_chunk:
        if not paged:
            raise ValueError("chunked prefill requires the paged layout")
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
    device = resolve_device(device)
    max_seq_total = max_seq + npfx
    prefills = {b: build_prefill_greedy(cfg, b, ctx)
                for b in sorted(set(buckets))}
    if not paged:
        acaches = abstract_caches(cfg, n_slots, max_seq_total, enc_len)
        param_pspecs = cache_pspecs = split = None
        if mesh is not None:
            rules = rules or shd.ShardingRules.for_serving(
                data_axis=ctx.fsdp_axis, tp_axis=ctx.tp_axis)
            aparams, axes = abstract_params(cfg, with_axes=True)
            param_pspecs = shd.pspecs_for_tree(aparams, axes, rules, mesh)
            cache_pspecs = shd.cache_pspec(acaches, ctx.dp_axes,
                                           ctx.tp_axis, mesh)
            split = seq_split_leaves(cache_pspecs)
        return EngineCells(
            decode_fn=build_decode_greedy(cfg, ctx, split),
            prefill_fns=prefills,
            insert_fns={b: build_cache_insert(ctx, n_slots, split)
                        for b in prefills},
            abstract_caches=acaches,
            n_prefix=npfx,
            max_seq_total=max_seq_total,
            device=device,
            paged=False,
            ctx=ctx,
            param_pspecs=param_pspecs,
            cache_pspecs=cache_pspecs,
        )
    n_pages = -(-max_seq_total // page_tokens)
    acaches = M.make_paged_decode_caches(
        cfg, n_slots, max_seq_total, page_tokens, enc_len,
        pool_dtype=pool_dtype,
        sz_granularity=sz_granularity, device="meta",
    )
    inserts = {b: build_paged_cache_insert(b + npfx, page_tokens, pool_dtype,
                                           sz_granularity, ctx, n_slots)
               for b in prefills}
    param_pspecs = cache_pspecs = None
    if mesh is not None:
        rules = rules or shd.ShardingRules.for_serving(
            data_axis=ctx.fsdp_axis, tp_axis=ctx.tp_axis)
        aparams, axes = abstract_params(cfg, with_axes=True)
        param_pspecs = shd.pspecs_for_tree(aparams, axes, rules, mesh)
        cache_pspecs = shd.paged_cache_pspec(acaches, ctx.dp_axes,
                                             ctx.tp_axis, mesh)
        _check_kv_heads(param_pspecs, cache_pspecs, mesh)
    draft_fn = draft_params = None
    if speculative == "draft":
        # seeded like the reference's PRNGKey(0) tree (other numbers, the
        # same role): one deterministic draft tree per cell set
        draft_fn = build_decode_draft(draft_cfg)
        draft_params = cast_params(
            M.init_model(draft_cfg, device=device, seed=0), draft_cfg.dtype)
    return EngineCells(
        decode_fn=build_decode_greedy_paged(cfg, page_tokens, ctx),
        prefill_fns=prefills,
        insert_fns=inserts,
        abstract_caches=acaches,
        n_prefix=npfx,
        max_seq_total=max_seq_total,
        device=device,
        page_tokens=page_tokens,
        n_pages=n_pages,
        pool_dtype=pool_dtype,
        sz_granularity=sz_granularity,
        copy_fn=build_page_copy(),
        chunk_fn=(build_prefill_chunk(cfg, page_tokens, ctx)
                  if prefill_chunk else None),
        chunk=prefill_chunk,
        verify_fn=(build_decode_verify_paged(cfg, page_tokens, spec_k, ctx)
                   if speculative != "off" else None),
        spec_k=spec_k if speculative != "off" else 0,
        draft_fn=draft_fn,
        draft_params=draft_params,
        draft_cfg=draft_cfg if speculative == "draft" else None,
        ctx=ctx,
        param_pspecs=param_pspecs,
        cache_pspecs=cache_pspecs,
    )


def _check_kv_heads(param_pspecs, cache_pspecs, mesh) -> None:
    """The pool splits KV heads over the tp axis exactly where the rules
    split wk / wv (an axis of size 1 splits nothing): a rank writes the
    heads it computes."""
    sizes = shd.axis_sizes(mesh)

    def split(entry):
        return entry if entry is not None and sizes[entry] > 1 else None

    for pos, c in cache_pspecs.items():
        if "k" not in c:
            continue
        attn = param_pspecs["blocks"][pos]["attn"]
        for w in ("wk", "wv"):
            if split(attn[w][2]) != split(c["k"][3]):
                raise ValueError(
                    f"{pos}: the rules put {w}'s KV heads on "
                    f"{attn[w][2]!r}, the paged pool on {c['k'][3]!r}")

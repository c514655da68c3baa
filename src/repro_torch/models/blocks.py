"""Layer pattern, stacked init and the layer loops (port of the serving
path of `repro.models.blocks`).

Parameters and caches keep the reference's stacked layout: every block
leaf carries a leading `nb` layer axis under `pos{j}` (j = position in the
layer-pattern period). Where the reference `lax.scan`s over that axis,
the port runs a Python loop; decode updates the `pool[layer]` views of the
caches in place instead of rebuilding a stacked tree.

Every stack of the reference's catalog runs: dense and MoE attention
decoders, SSM stacks (mamba2), hybrid attention + SSM + MoE stacks
(jamba), the vision-prefix decoder and the encoder-decoder (its encoder
stack non-causal, its decoder layers with cross-attention). Without a
mesh an MoE layer is `moe.moe_dense`, as in the reference. The layer
loops take the parallel context `ctx` (`common.parallel`) and hand it to
self- and cross-attention, the SSM block, the MLP and `moe.moe_ep`;
`SINGLE` (no mesh) is the default, so a meshless caller is unchanged.
Slot-resident decode state never enters the page pool: an SSM layer's
`state`, `tail_x`, `tail_B`, `tail_C` and a decoder layer's
cross-attention `cross_k` / `cross_v` (extent `enc_len`); over a mesh
each rank holds its shard of them (`runtime.sharding.cache_pspec` /
`paged_cache_pspec`).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.parallel import SINGLE, ParallelCtx
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import mlp, mlp_init, rmsnorm, rmsnorm_init
from repro_torch.models.module import Initializer, layer_slice, torch_dtype


@dataclasses.dataclass(frozen=True)
class LayerDesc:
    kind: str            # "attn" | "ssm"
    moe: bool
    cross: bool = False  # enc-dec decoder layer with cross-attention
    causal: bool = True


def super_period(cfg: ModelConfig) -> int:
    p = 1
    if cfg.num_experts:
        p = math.lcm(p, cfg.moe_layer_period)
    if cfg.family == "hybrid" and cfg.attn_layer_period:
        p = math.lcm(p, cfg.attn_layer_period)
    return p


def pattern(cfg: ModelConfig, cross: bool = False, causal: bool = True):
    per = super_period(cfg)
    if cfg.num_layers % per:
        raise ValueError(f"num_layers {cfg.num_layers} not a multiple of "
                         f"the layer period {per}")
    return [
        LayerDesc(
            kind="attn" if cfg.is_attn_layer(j) else "ssm",
            moe=cfg.is_moe_layer(j),
            cross=cross,
            causal=causal,
        )
        for j in range(per)
    ]


# ------------------------------------------------------------------ init
def stack_init(generator: torch.Generator, cfg: ModelConfig, *,
               cross: bool = False, n_layers: int | None = None):
    """All layers' parameters, stacked by position-in-period on a leading
    `nb` axis, and their logical-axis tree. `cross` gives every layer a
    cross-attention block (the enc-dec decoder); `n_layers` other than
    cfg.num_layers sizes the encoder stack. Returns (params, axes)."""
    descs = pattern(cfg, cross)
    n_layers = n_layers if n_layers is not None else cfg.num_layers
    nb = n_layers // len(descs)
    params, axes = {}, {}
    for j, desc in enumerate(descs):
        init = Initializer(generator, torch_dtype(cfg.param_dtype),
                           lead=(nb,))
        rmsnorm_init(init.child("pre_norm"), cfg.d_model)
        if desc.kind == "attn":
            attn.attn_init(init.child("attn"), cfg)
        else:
            ssm_mod.ssm_init(init.child("ssm"), cfg)
        if desc.cross:
            rmsnorm_init(init.child("cross_norm"), cfg.d_model)
            attn.attn_init(init.child("cross"), cfg, cross=True)
        rmsnorm_init(init.child("ffn_norm"), cfg.d_model)
        if desc.moe:
            moe_mod.moe_init(init.child("moe"), cfg)
        elif cfg.d_ff:
            mlp_init(init.child("mlp"), cfg)
        params[f"pos{j}"] = init.collect()
        axes[f"pos{j}"] = init.axes()
    return params, axes


def _ffn(p, h, cfg: ModelConfig, desc: LayerDesc,
         ctx: ParallelCtx = SINGLE, local_batch: bool = False):
    """The layer's feed-forward on the normed h: MoE (dense oracle
    without a mesh), the dense MLP, or nothing. `local_batch`: h holds
    only this rank's rows of a batch split over the dp axes. Returns
    (out, aux)."""
    if desc.moe:
        return moe_mod.moe_ep(p["moe"], h, cfg, ctx, local_batch=local_batch)
    if cfg.d_ff:
        return mlp(p["mlp"], h, cfg, ctx), None
    return torch.zeros_like(h), None


def _apply_layer_train(p, x, cfg: ModelConfig, desc: LayerDesc,
                       enc_out=None, ctx: ParallelCtx = SINGLE,
                       local_batch: bool = False):
    """One layer over the full sequence (training, the encoder's pass).
    Returns (x, aux), aux the layer's MoE load-balance loss (float32
    scalar, 0 for a dense layer). `local_batch`: x holds the rank's rows
    of a batch split over the dp axes (the train step over a mesh)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(p["pre_norm"], x, cfg.norm_eps, ctx)
    if desc.kind == "attn":
        h = attn.self_attention(p["attn"], h, cfg, causal=desc.causal,
                                ctx=ctx, local_batch=local_batch)
    else:
        h = ssm_mod.ssm_block(p["ssm"], h, cfg, ctx=ctx)
    x = x + h
    if desc.cross:
        h = rmsnorm(p["cross_norm"], x, cfg.norm_eps, ctx)
        enc_kv = attn.encode_cross_kv(p["cross"], enc_out, cfg, ctx)
        x = x + attn.cross_attention(p["cross"], h, enc_kv, cfg, ctx,
                                     local_batch)
    h, a = _ffn(p, rmsnorm(p["ffn_norm"], x, cfg.norm_eps, ctx), cfg, desc,
                ctx, local_batch)
    if a is not None:
        aux = aux + a
    return x + h, aux


def stack_apply(params, x, cfg: ModelConfig, *, cross: bool = False,
                causal: bool = True, enc_out=None,
                n_layers: int | None = None, remat: str = "none",
                ctx: ParallelCtx = SINGLE, local_batch: bool = False):
    """Full-sequence stack without caches (training and the encoder's
    pass): x (B, S, d) -> (x, aux), aux the sum of the layers' MoE
    load-balance losses (float32 scalar). `remat="block"` recomputes each
    super-period of layers in the backward instead of keeping its
    activations (`torch.utils.checkpoint`, non-reentrant), as the
    reference's `jax.checkpoint(body, nothing_saveable)` over one
    scanned super-block; over a mesh the recompute issues the layers'
    collectives (the FSDP gathers among them) again, in the same order
    on every rank. `local_batch`: x holds the rank's rows (training over
    a mesh)."""
    from torch.utils.checkpoint import checkpoint

    descs = pattern(cfg, cross, causal)
    n_layers = n_layers if n_layers is not None else cfg.num_layers

    def body(i, x, aux, enc_out):
        for j, desc in enumerate(descs):
            x, a = _apply_layer_train(layer_slice(params[f"pos{j}"], i), x,
                                      cfg, desc, enc_out, ctx, local_batch)
            aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_layers // len(descs)):
        if remat == "block" and torch.is_grad_enabled():
            x, aux = checkpoint(body, i, x, aux, enc_out,
                                use_reentrant=False)
        else:
            x, aux = body(i, x, aux, enc_out)
    return x, aux


# --------------------------------------------------------------- caches
# an SSM layer's slot-resident decode state, in the reference's order
_SSM_LEAVES = ("state", "tail_x", "tail_B", "tail_C")
# the physical-page-pool leaves of a paged cache tree; everything else
# (SSM state, conv tails, cross-KV) is slot-resident and never pooled
PAGED_LEAF_NAMES = ("k", "v", "k_sz", "v_sz")

# pool payload dtypes: "fp" stores cfg.dtype exactly, "bf16" a 2-byte
# cast, "int8" adds per-page float32 (scale, zero) tensors ("k_sz"/"v_sz",
# `kernels.quant` layout), quantize-on-insert and dequantize-in-kernel
POOL_DTYPES = ("fp", "bf16", "int8")


def pool_kv_dtype(cfg: ModelConfig, pool_dtype: str) -> torch.dtype:
    """The K/V payload dtype of a pool-dtype name."""
    if pool_dtype not in POOL_DTYPES:
        raise ValueError(f"unknown pool_dtype {pool_dtype!r}; "
                         f"expected one of {POOL_DTYPES}")
    if pool_dtype == "fp":
        return torch_dtype(cfg.dtype)
    return {"bf16": torch.bfloat16, "int8": torch.int8}[pool_dtype]


def init_caches(cfg: ModelConfig, batch: int, max_seq: int, *,
                cross: bool = False, enc_len: int = 0, kv_shape=None,
                kv_dtype=None, kv_sz_shape=None, device=None) -> dict:
    """Decode caches mirroring the stacked params. `kv_shape`/`kv_dtype`
    override the K/V leaf shape and dtype (the paged pool layout);
    `kv_sz_shape` adds the float32 (scale, zero) tensors of an int8
    pool. SSM layers hold the float32 state (nb, batch, H, P, N) and the
    conv tails (nb, batch, W-1, C) instead of K/V; with `cross` every
    layer also holds the encoder's K/V `cross_k` / `cross_v` (nb, batch,
    enc_len, KV, hd) in cfg.dtype."""
    descs = pattern(cfg, cross)
    nb = cfg.num_layers // len(descs)
    dtype = torch_dtype(cfg.dtype)
    caches = {}
    for j, desc in enumerate(descs):
        if desc.kind != "attn":
            state, tails = ssm_mod.make_ssm_state(cfg, batch, nb,
                                                  device=device)
            c = dict(zip(_SSM_LEAVES, (state, *tails)))
        else:
            shape = kv_shape or (nb, batch, max_seq, cfg.num_kv_heads,
                                 cfg.head_dim)
            c = {
                "k": torch.zeros(shape, dtype=kv_dtype or dtype,
                                 device=device),
                "v": torch.zeros(shape, dtype=kv_dtype or dtype,
                                 device=device),
            }
            if kv_sz_shape is not None:
                c["k_sz"] = torch.zeros(kv_sz_shape, dtype=torch.float32,
                                        device=device)
                c["v_sz"] = torch.zeros(kv_sz_shape, dtype=torch.float32,
                                        device=device)
        if desc.cross:
            shape = (nb, batch, enc_len, cfg.num_kv_heads, cfg.head_dim)
            c["cross_k"] = torch.zeros(shape, dtype=dtype, device=device)
            c["cross_v"] = torch.zeros(shape, dtype=dtype, device=device)
        caches[f"pos{j}"] = c
    return caches


def init_paged_caches(cfg: ModelConfig, n_slots: int, max_seq: int,
                      page_tokens: int, *, cross: bool = False,
                      enc_len: int = 0, pool_dtype: str = "fp",
                      sz_granularity: str = "page", device=None) -> dict:
    """Decode caches with self-attention K/V laid out as a PHYSICAL page
    pool (nb, n_slots * n_pages, page_tokens, KV, hd); int8 pools add
    (nb, P_phys, KV, 2) per-page or (nb, P_phys, page_tokens, KV, 2)
    per-token (scale, zero) tensors. SSM state and cross-KV stay
    per-slot."""
    if sz_granularity not in ("page", "token"):
        raise ValueError(f"unknown sz_granularity {sz_granularity!r}; "
                         "expected 'page' or 'token'")
    nb = cfg.num_layers // len(pattern(cfg))
    n_pages = -(-max_seq // page_tokens)       # ceil
    p_phys = n_slots * n_pages
    if pool_dtype != "int8":
        sz_shape = None
    elif sz_granularity == "token":
        sz_shape = (nb, p_phys, page_tokens, cfg.num_kv_heads, 2)
    else:
        sz_shape = (nb, p_phys, cfg.num_kv_heads, 2)
    return init_caches(
        cfg, n_slots, max_seq, cross=cross, enc_len=enc_len,
        kv_shape=(nb, p_phys, page_tokens, cfg.num_kv_heads, cfg.head_dim),
        kv_dtype=pool_kv_dtype(cfg, pool_dtype),
        kv_sz_shape=sz_shape, device=device,
    )


def init_pool_twin(caches: dict, *, pinned: bool = False) -> dict:
    """Pool-resident twin of the PAGED leaves of `caches`: a same-shape
    zeros tree holding only the physical page pool tensors (k/v payload
    plus the int8 (scale, zero) leaves). `pinned=True` puts it in pinned
    host memory (the substrate's physical mode; the kernels reach it
    through its mapped device address), else on each leaf's own device
    (emulated mode). The serving substrate (`serving.substrate`) mirrors
    pool-tiered pages into it. Returns {} for cache trees with no paged
    leaves (SSM-only stacks)."""
    twin = {}
    for pos, c in caches.items():
        sub = {}
        for name in PAGED_LEAF_NAMES:
            if name not in c:
                continue
            leaf = c[name]
            if pinned:
                sub[name] = torch.zeros(leaf.shape, dtype=leaf.dtype,
                                        pin_memory=True)
            else:
                sub[name] = torch.zeros_like(leaf)
        if sub:
            twin[pos] = sub
    return twin


# ------------------------------------------------------------------ apply
def _apply_layer_decode(p, c, x, t, cfg: ModelConfig, desc: LayerDesc,
                        block_table, page_tokens: int, attn_override=None,
                        ctx: ParallelCtx = SINGLE, seq_split=None):
    """One layer, one token per slot (or, via `attn_override`, one prompt
    chunk), against the cache views `c` (updated in place): the paged
    pool through `block_table`, or the contiguous per-slot caches when
    it is None; an SSM layer steps its slot-resident state and conv
    tails (parked slots step garbage, which the next admission's insert
    overwrites); a cross layer attends to its slot-resident encoder K/V.
    Returns x. `attn_override(p_attn, h, c) -> (h, c)` swaps the
    attention contraction while the rest of the layer body stays shared,
    so the chunked and the decode streams cannot diverge in a layer
    change. Over a mesh x may hold only this rank's rows of the slots
    (`block_table` has them all; see `attention.
    paged_decode_self_attention`), and `seq_split` ({leaf name: bool},
    the contiguous caches' only) says which attention leaves hold the
    rank's block of positions over tp."""
    split = seq_split or {}
    h = rmsnorm(p["pre_norm"], x, cfg.norm_eps)
    if desc.kind != "attn":
        h, (state, tails) = ssm_mod.ssm_decode_step(
            p["ssm"], h, cfg, c["state"],
            tuple(c[k] for k in _SSM_LEAVES[1:]), ctx=ctx)
        for key, leaf in zip(_SSM_LEAVES, (state, *tails)):
            c[key].copy_(leaf)
    elif attn_override is not None:
        h, _ = attn_override(p["attn"], h, c)
    elif block_table is not None:
        h, _ = attn.paged_decode_self_attention(
            p["attn"], h, cfg, c, t, block_table, page_tokens, ctx=ctx)
    else:
        h, _ = attn.decode_self_attention(p["attn"], h, cfg, c["k"], c["v"],
                                          t, ctx=ctx,
                                          seq_split=split.get("k", False))
    x = x + h
    if desc.cross:
        h = rmsnorm(p["cross_norm"], x, cfg.norm_eps)
        x = x + attn.decode_cross_attention(
            p["cross"], h, (c["cross_k"], c["cross_v"]), cfg, ctx,
            seq_split=block_table is None and split.get("cross_k", False))
    # the contiguous caches over a mesh hold the rank's slots: x holds
    # them (all of them where the dp axes do not split the slots)
    local = (x.shape[0] != block_table.shape[0] if block_table is not None
             else ctx.mesh is not None)
    h, _ = _ffn(p, rmsnorm(p["ffn_norm"], x, cfg.norm_eps), cfg, desc, ctx,
                local_batch=local)
    return x + h


def stack_decode(params, caches, x, t, cfg: ModelConfig, block_table,
                 page_tokens: int, cross: bool = False,
                 ctx: ParallelCtx = SINGLE, seq_split=None):
    """One decode step through the whole stack, x (B, 1, d), against the
    caches (written in place, layer by layer): the paged pool through
    `block_table`, or the contiguous (nb, B, S, KV, hd) caches when
    `block_table` is None. Over a mesh x may hold only this rank's rows
    of the block table's slots, or of the contiguous caches' slots, whose
    attention leaves named True in `seq_split` hold the rank's block of
    positions over tp (`attention.decode_self_attention`) and the others
    every position: over a tp axis the contiguous decode needs it."""
    if block_table is None and seq_split is None \
            and ctx.axis_size(ctx.tp_axis) > 1:
        raise ValueError("the contiguous decode over a tp axis needs "
                         "seq_split (runtime.serve.seq_split_leaves of the "
                         "caches' specs)")
    descs = pattern(cfg, cross)
    nb = cfg.num_layers // len(descs)
    for i in range(nb):
        for j, desc in enumerate(descs):
            c = layer_slice(caches[f"pos{j}"], i)
            x = _apply_layer_decode(layer_slice(params[f"pos{j}"], i), c,
                                    x, t, cfg, desc, block_table,
                                    page_tokens, ctx=ctx,
                                    seq_split=seq_split)
    return x, caches


def stack_prefill_chunk(params, caches, x, c0, cfg: ModelConfig, block_row,
                        page_tokens: int, ctx: ParallelCtx = SINGLE):
    """One page-aligned prompt chunk x (1, C, d) through the whole stack
    against the PAGED caches: each attention layer writes the chunk's KV
    through the block row (in place) and attends to everything prefilled
    so far. `c0` is the chunk start as a device tensor. Only
    attention-only decoder stacks chunk (see
    `runtime.serve.chunked_prefill_supported`)."""
    descs = pattern(cfg)
    if any(d.kind != "attn" or d.cross for d in descs):
        raise ValueError("chunked prefill needs an attention-only stack")

    def chunk_attn(p_attn, h, c):
        return attn.paged_prefill_chunk_attention(
            p_attn, h, cfg, c, c0, block_row, page_tokens, ctx=ctx)

    nb = cfg.num_layers // len(descs)
    for i in range(nb):
        for j, desc in enumerate(descs):
            c = layer_slice(caches[f"pos{j}"], i)
            x = _apply_layer_decode(layer_slice(params[f"pos{j}"], i), c,
                                    x, None, cfg, desc, None, page_tokens,
                                    attn_override=chunk_attn, ctx=ctx)
    return x, caches


def stack_prefill(params, x, cfg: ModelConfig, max_seq: int, *,
                  cross: bool = False, enc_out=None,
                  ctx: ParallelCtx = SINGLE):
    """Prefill: full-sequence forward that also materializes the per-slot
    decode caches, stacked over layers: {"k", "v"} of shape (nb, B,
    max_seq, KV, hd), zero-padded past the prompt, for attention layers;
    the final SSM state and conv tails for SSM layers; with `cross`, the
    encoder K/V `cross_k` / `cross_v` (nb, B, S_enc, KV, hd) of every
    layer. The MoE layers' load-balance loss is dropped, as serving does
    in the reference."""
    descs = pattern(cfg, cross)
    nb = cfg.num_layers // len(descs)
    B, S, _ = x.shape
    leaves = [{} for _ in descs]
    for i in range(nb):
        for j, desc in enumerate(descs):
            p = layer_slice(params[f"pos{j}"], i)
            h = rmsnorm(p["pre_norm"], x, cfg.norm_eps)
            if desc.kind == "attn":
                h, (k, v) = attn.self_attention(p["attn"], h, cfg,
                                                causal=desc.causal,
                                                return_kv=True, ctx=ctx)
                pad = (0, 0, 0, 0, 0, max_seq - S)
                new = {"k": torch.nn.functional.pad(k, pad),
                       "v": torch.nn.functional.pad(v, pad)}
            else:
                h, (state, tails) = ssm_mod.ssm_block(p["ssm"], h, cfg,
                                                      return_state=True,
                                                      ctx=ctx)
                new = dict(zip(_SSM_LEAVES, (state, *tails)))
            x = x + h
            if desc.cross:
                hh = rmsnorm(p["cross_norm"], x, cfg.norm_eps)
                ck, cv = attn.encode_cross_kv(p["cross"], enc_out, cfg, ctx)
                new["cross_k"], new["cross_v"] = ck, cv
                x = x + attn.cross_attention(p["cross"], hh, (ck, cv), cfg,
                                             ctx)
            for key, leaf in new.items():
                leaves[j].setdefault(key, []).append(leaf)
            h, _ = _ffn(p, rmsnorm(p["ffn_norm"], x, cfg.norm_eps), cfg,
                        desc, ctx)
            x = x + h
    caches = {f"pos{j}": {k: torch.stack(v) for k, v in leaves[j].items()}
              for j in range(len(descs))}
    return x, caches

"""Top-level model API of the port (port of `repro.models.model`).

Families: dense / moe / ssm / hybrid / vlm are decoder-only LMs (vlm
prepends the frontend's patch embeddings, `batch["patches"]`); audio is
an encoder over frame embeddings (`batch["frames"]`) and a causal decoder
with per-layer cross-attention.

  init_model(cfg, generator[, with_axes])       -> params[, axes]
  forward(params, batch, cfg[, remat, ctx])     -> (logits, aux)
  loss_fn(params, batch, cfg[, remat, ctx])     -> (loss, metrics)
  prefill(params, batch, cfg, max_seq[, ctx])   -> (caches, logits_last)
  decode_step(params, token, caches, t, cfg,
              block_table, page_tokens[, ctx])  -> (logits, caches)
  prefill_chunk(params, tokens, caches, chunk_idx, cfg,
                block_row, page_tokens[, ctx])  -> (logits, caches)
  make_decode_caches(cfg, batch, max_seq[, enc_len]) -> contiguous caches
  make_paged_decode_caches(cfg, n_slots, ...)   -> paged caches

Decode and chunked prefill write the caches in place (the reference
donates them to its jitted cells and gets new arrays back). `ctx` (the
parallel context, `common.parallel.SINGLE` by default) runs the rank's
shard over a mesh; the logits come back over the whole vocab.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import resolve_device
from repro_torch.common.parallel import SINGLE, ParallelCtx, gather_param
from repro_torch.models import blocks
from repro_torch.models.layers import (
    embed,
    embed_init,
    lm_head_init,
    rmsnorm,
    rmsnorm_init,
    unembed,
)
from repro_torch.models.module import Initializer, torch_dtype

MOE_AUX_COEF = 0.01
Z_LOSS_COEF = 1e-4


# ------------------------------------------------------------------ init
def init_model(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               *, device=None, seed: int = 0, with_axes: bool = False):
    """Seeded float32 master weights with the reference's tree, shapes
    and initializer scales, on the generator's device. Without a
    generator one is made on `device` (the card by default) from
    `seed`; `device="meta"` gives the tree's shapes and dtypes only.
    Enc-dec archs add the `encoder` subtree (its blocks and final norm)
    and give the decoder blocks cross-attention. `with_axes` returns
    (params, axes), the reference's pair: the matching tree of logical
    axis tuples the sharding rules resolve."""
    if generator is None:
        dev = resolve_device(device)
        if dev.type != "meta":
            generator = torch.Generator(dev).manual_seed(seed)
    init = Initializer(generator, torch_dtype(cfg.param_dtype))
    embed_init(init.child("embed"), cfg)
    lm_head_init(init.child("head"), cfg)
    rmsnorm_init(init.child("final_norm"), cfg.d_model)
    params, axes = init.collect(), init.axes()
    cross = bool(cfg.num_encoder_layers)
    if cross:
        enc, enc_axes = blocks.stack_init(generator, cfg,
                                          n_layers=cfg.num_encoder_layers)
        norm = Initializer(generator, torch_dtype(cfg.param_dtype))
        rmsnorm_init(norm.child("final_norm"), cfg.d_model)
        params["encoder"] = {"blocks": enc, **norm.collect()}
        axes["encoder"] = {"blocks": enc_axes, **norm.axes()}
    params["blocks"], axes["blocks"] = blocks.stack_init(generator, cfg,
                                                         cross=cross)
    return (params, axes) if with_axes else params


def _encode(params, frames, cfg: ModelConfig, remat: str = "none",
            ctx: ParallelCtx = SINGLE, local_batch: bool = False):
    """The encoder stack (non-causal) over the frame embeddings; over a
    mesh every rank runs its frames on its shard of the weights and ends
    with their whole encoder output: every row's (attention splits the
    rows over the dp axes where they divide and gathers them back), or
    with `local_batch` (the train step) the rank's own rows."""
    x, _ = blocks.stack_apply(params["encoder"]["blocks"], frames, cfg,
                              causal=False,
                              n_layers=cfg.num_encoder_layers, remat=remat,
                              ctx=ctx, local_batch=local_batch)
    return rmsnorm(params["encoder"]["final_norm"], x, cfg.norm_eps, ctx)


def _decoder_inputs(params, batch, cfg: ModelConfig,
                    ctx: ParallelCtx = SINGLE):
    """Token embeddings, with the vision prefix prepended. Returns
    (x, n_prefix)."""
    x = embed(params["embed"], batch["tokens"], cfg, ctx)
    n_prefix = 0
    if cfg.frontend == "vision_stub" and "patches" in batch:
        pfx = torch.as_tensor(batch["patches"], device=x.device).to(x.dtype)
        x = torch.cat([pfx, x], dim=1)
        n_prefix = pfx.shape[1]
    return x, n_prefix


# --------------------------------------------------------------- forward
def forward(params, batch, cfg: ModelConfig, remat: str = "none",
            ctx: ParallelCtx = SINGLE, local_batch: bool = False):
    """Teacher-forced forward. batch: tokens (B, S) [+ patches | frames].
    Returns (logits (B, S, V) in cfg.dtype, aux float32 scalar: the MoE
    load-balance loss). The vision prefix is dropped before unembed;
    the encoder-decoder runs its encoder over `frames`. `remat="block"`
    recomputes each super-period of layers in the backward.
    `local_batch`: the batch holds this rank's rows of one split over
    the ctx's dp axes (the train step over a mesh); the logits are the
    rank's rows over the whole vocab."""
    table = params["embed"]["embedding"]
    if cfg.tie_embeddings and table.shape[1] != cfg.d_model:
        # FSDP: one gather serves the lookup and the tied head
        params = dict(params, embed=dict(params["embed"], embedding=(
            gather_param(table, ctx, 1, cfg.d_model))))
    x, n_prefix = _decoder_inputs(params, batch, cfg, ctx)
    cross = bool(cfg.num_encoder_layers)
    enc_out = None
    if cross:
        frames = torch.as_tensor(batch["frames"], device=x.device)
        enc_out = _encode(params, frames.to(x.dtype), cfg, remat, ctx,
                          local_batch)
    x, aux = blocks.stack_apply(params["blocks"], x, cfg, cross=cross,
                                enc_out=enc_out, remat=remat, ctx=ctx,
                                local_batch=local_batch)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps, ctx)
    if n_prefix:
        x = x[:, n_prefix:, :]
    logits = unembed(params["embed"], x, cfg, params.get("head"), ctx)
    return logits, aux


def loss_fn(params, batch, cfg: ModelConfig, remat: str = "none",
            ctx: ParallelCtx = SINGLE, local_batch: bool = False):
    """Next-token cross-entropy + z-loss + MoE aux; tokens (B, S+1).
    Returns (loss, metrics) with the float32 scalars `loss`, `nll`,
    `z_loss`, `moe_aux` and `accuracy`. With `local_batch` over a mesh
    they are the means over this rank's rows (the MoE aux is the global
    batch's); the train step averages them over the dp ranks."""
    tokens = batch["tokens"]
    inputs = dict(batch, tokens=tokens[:, :-1])
    labels = tokens[:, 1:].long()
    logits, aux = forward(params, inputs, cfg, remat, ctx, local_batch)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = (logz - label_logit).mean()
    z_loss = Z_LOSS_COEF * (logz ** 2).mean()
    loss = nll + z_loss + MOE_AUX_COEF * aux
    metrics = {
        "loss": loss,
        "nll": nll,
        "z_loss": z_loss,
        "moe_aux": aux,
        "accuracy": (logits.argmax(-1) == labels).float().mean(),
    }
    return loss, metrics


# ----------------------------------------------------------------- serve
def prefill(params, batch, cfg: ModelConfig, max_seq: int,
            ctx: ParallelCtx = SINGLE):
    """Process the prompt batch["tokens"] (B, S) (+ "patches" for the
    vision prefix, "frames" for the encoder), build the per-slot decode
    caches (seq extent `max_seq` plus the prefix; cross-KV extent the
    frames'), return last-token logits (B, V). Over a mesh every dp rank
    runs the whole batch (attention splits it where it divides) and the
    caches hold the rank's KV heads (k / v and cross_k / cross_v), SSM
    heads (state) and channels (tail_x); tail_B / tail_C come back whole
    (`runtime.serve` cuts them to the decode shard's channel block)."""
    x, n_prefix = _decoder_inputs(params, batch, cfg, ctx)
    cross = bool(cfg.num_encoder_layers)
    enc_out = None
    if cross:
        frames = torch.as_tensor(batch["frames"], device=x.device)
        enc_out = _encode(params, frames.to(x.dtype), cfg, ctx=ctx)
    x, caches = blocks.stack_prefill(params["blocks"], x, cfg,
                                     max_seq + n_prefix, cross=cross,
                                     enc_out=enc_out, ctx=ctx)
    x = rmsnorm(params["final_norm"], x[:, -1:, :], cfg.norm_eps)
    logits = unembed(params["embed"], x, cfg, params.get("head"), ctx)
    return caches, logits[:, 0, :]


def decode_step(params, token, caches, t, cfg: ModelConfig,
                block_table=None, page_tokens: int = 0,
                ctx: ParallelCtx = SINGLE, seq_split=None):
    """One decode step. token (B,) int; t a scalar position shared by the
    batch or a (B,) vector of per-slot positions. With `block_table`
    (B, n_pages) int32, `caches` is the paged physical page pool
    (`make_paged_decode_caches`); without, the contiguous caches
    (`make_decode_caches`, or `prefill`'s). Written in place.

    Over a mesh whose dp axes divide the paged slots the rank decodes
    its block of them (`ParallelCtx.batch_rows`) and returns their
    logits only; the pool writes of every slot still land in its pool.
    The contiguous caches over a mesh hold the rank's slots
    (`runtime.sharding.cache_pspec`): token and t hold every slot (the
    rank takes its rows) or, as many as the caches' rows, the rank's
    own; the logits are the rank's rows. `seq_split` ({leaf name: bool},
    `runtime.serve.seq_split_leaves` of the caches' specs) names the
    attention leaves that hold the rank's block of positions over tp;
    the others hold every position."""
    B = token.shape[0]
    r0, r1 = ctx.batch_rows(B) if block_table is not None else (0, B)
    if block_table is None and ctx.mesh is not None \
            and B != _cache_rows(caches):
        r0, r1 = ctx.batch_rows(B)
        t = torch.as_tensor(t, device=token.device)
        if t.dim():
            t = t[r0:r1]
    x = embed(params["embed"], token[r0:r1, None], cfg, ctx)
    x, caches = blocks.stack_decode(params["blocks"], caches, x, t, cfg,
                                    block_table, page_tokens,
                                    cross=bool(cfg.num_encoder_layers),
                                    ctx=ctx, seq_split=seq_split)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed(params["embed"], x, cfg, params.get("head"), ctx)
    return logits[:, 0, :], caches


def _cache_rows(caches) -> int:
    """The slot rows of a contiguous cache tree (dim 1 of its leaves)."""
    return next(iter(next(iter(caches.values())).values())).shape[1]


def prefill_chunk(params, tokens, caches, chunk_idx, cfg: ModelConfig,
                  block_row, page_tokens: int, ctx: ParallelCtx = SINGLE):
    """One page-aligned prompt chunk against the PAGED caches: tokens
    (1, C) at absolute positions [chunk_idx*C, (chunk_idx+1)*C), written
    through `block_row` (1, n_pages), the prefilling slot's table row, in
    place. `chunk_idx` may be an int or a device tensor; the chunk start
    reaches the kernels as a device tensor. Returns (last-token logits,
    caches); the engine uses the logits only on the final chunk."""
    C = tokens.shape[1]
    c0 = torch.as_tensor(chunk_idx, device=tokens.device).to(
        torch.int32) * C
    x = embed(params["embed"], tokens, cfg, ctx)
    x, caches = blocks.stack_prefill_chunk(params["blocks"], caches, x, c0,
                                           cfg, block_row, page_tokens,
                                           ctx=ctx)
    x = rmsnorm(params["final_norm"], x[:, -1:, :], cfg.norm_eps)
    logits = unembed(params["embed"], x, cfg, params.get("head"), ctx)
    return logits[:, 0, :], caches


def make_decode_caches(cfg: ModelConfig, batch: int, max_seq: int,
                       enc_len: int = 0, *, device=None) -> dict:
    """Contiguous per-slot decode caches (nb, batch, max_seq, KV, hd) in
    cfg.dtype, zeroed; enc-dec archs add cross-KV of extent `enc_len`."""
    return blocks.init_caches(cfg, batch, max_seq,
                              cross=bool(cfg.num_encoder_layers),
                              enc_len=enc_len, device=device)


def make_paged_decode_caches(cfg: ModelConfig, n_slots: int, max_seq: int,
                             page_tokens: int, enc_len: int = 0, *,
                             pool_dtype: str = "fp",
                             sz_granularity: str = "page",
                             device=None) -> dict:
    """Decode caches with self-attention K/V as a physical page pool
    (`blocks.init_paged_caches`); the serving engine's layout."""
    return blocks.init_paged_caches(
        cfg, n_slots, max_seq, page_tokens,
        cross=bool(cfg.num_encoder_layers), enc_len=enc_len,
        pool_dtype=pool_dtype, sz_granularity=sz_granularity, device=device,
    )

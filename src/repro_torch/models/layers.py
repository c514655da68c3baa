"""Shared layers: RMSNorm, embedding, RoPE, dense MLP (port of
`repro.models.layers`, same dtype handling).

Over a mesh (`ctx`) the weights are the rank's shards, and each layer
issues the collective its split needs (Megatron's scheme, which the
reference leaves to XLA's partitioner): a vocab-sharded embedding looks
up the rank's rows (zero elsewhere) and sums over the model axis; a
vocab-sharded head gathers the logits over it; the MLP is column-parallel
on its up / gate projections and row-parallel on its down projection,
summed over the model axis. What is sharded is read off the local
shapes against the config. Without a mesh (or unsharded weights) they
are the plain functions.

Under the training rules every leaf with an `embed` dim also holds
d / n_data of it (FSDP): the layer gathers it over the fsdp axis after
the cast to the compute dtype (`parallel.gather_param`, whose backward
reduce-scatters the gradient). A replicated activation that enters a
rank's split of the vocab or of the ff dim passes `enter_region`, so
its gradient sums the ranks' parts (`common.parallel`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.common.parallel import (
    SINGLE,
    ParallelCtx,
    all_gather,
    enter_region,
    gather_param,
    psum,
)
from repro_torch.models.module import Initializer, torch_dtype


# ---------------------------------------------------------------- norms
def rmsnorm_init(init: Initializer, d: int, name: str = "scale"):
    init.param(name, (d,), ("embed",), init="ones")


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6,
            ctx: ParallelCtx = SINGLE) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    scale = gather_param(params["scale"], ctx, 0, x.shape[-1])
    return (y * scale.float()).to(x.dtype)


# ---------------------------------------------------------------- embedding
def embed_init(init: Initializer, cfg: ModelConfig):
    init.param("embedding", (cfg.vocab_size, cfg.d_model),
               ("vocab", "embed"), init="embedding")


def embed(params, tokens: torch.Tensor, cfg: ModelConfig,
          ctx: ParallelCtx = SINGLE) -> torch.Tensor:
    dt = torch_dtype(cfg.dtype)
    table = gather_param(params["embedding"], ctx, 1, cfg.d_model)
    ids = tokens.reshape(-1)
    V_loc = table.shape[0]
    if V_loc != cfg.vocab_size:
        # vocab-parallel: this rank's rows, zero for the other ranks'
        # tokens, summed over the model axis (one term is nonzero: exact)
        v0 = ctx.index(ctx.tp_axis) * V_loc
        mine = (ids >= v0) & (ids < v0 + V_loc)
        out = table.index_select(0, torch.where(mine, ids - v0, 0))
        out = psum(out * mine[:, None].to(out.dtype), ctx, ctx.tp_axis)
    else:
        out = table.index_select(0, ids)
    out = out.reshape(*tokens.shape, table.shape[1])
    return out.to(dt) * torch.sqrt(
        torch.tensor(cfg.d_model, dtype=dt, device=out.device))


def unembed(params, x: torch.Tensor, cfg: ModelConfig, head_params=None,
            ctx: ParallelCtx = SINGLE):
    """Project to vocab logits. Uses the tied embedding when configured.
    A vocab-sharded table gives the rank's logits, gathered over the
    model axis into the whole vocab."""
    if cfg.tie_embeddings:
        w = gather_param(params["embedding"].to(x.dtype), ctx, 1,
                         x.shape[-1])   # (V, d)
        eq, v_dim = "bsd,vd->bsv", 0
    else:
        w = gather_param(head_params["lm_head"].to(x.dtype), ctx, 0,
                         x.shape[-1])   # (d, V)
        eq, v_dim = "bsd,dv->bsv", 1
    if w.shape[v_dim] != cfg.vocab_size:
        x = enter_region(x, ctx, ctx.tp_axis)
    logits = torch.einsum(eq, x, w)
    if logits.shape[-1] != cfg.vocab_size:
        logits = all_gather(logits, ctx, ctx.tp_axis, 2)
    return logits


def lm_head_init(init: Initializer, cfg: ModelConfig):
    if not cfg.tie_embeddings:
        init.param("lm_head", (cfg.d_model, cfg.vocab_size),
                   ("embed", "vocab"), init="normal")


# ---------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., S, H, D) with positions (..., S)."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, device=x.device)             # (D/2,)
    angles = positions[..., None].float() * freqs             # (...,S,D/2)
    cos = torch.cos(angles)[..., None, :]                     # (...,S,1,D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    rx1 = x1 * cos - x2 * sin
    rx2 = x2 * cos + x1 * sin
    return torch.cat([rx1, rx2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------- dense MLP
GATED_ACTS = ("swiglu", "geglu")


def mlp_init(init: Initializer, cfg: ModelConfig, d_ff: Optional[int] = None):
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act in GATED_ACTS:
        init.param("w_gate", (d, ff), ("embed", "ff"))
    init.param("w_up", (d, ff), ("embed", "ff"))
    init.param("w_down", (ff, d), ("ff", "embed"))


def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def mlp(params, x: torch.Tensor, cfg: ModelConfig,
        ctx: ParallelCtx = SINGLE) -> torch.Tensor:
    dt, d = x.dtype, x.shape[-1]
    split = params["w_down"].shape[0] != cfg.d_ff
    if split:
        x = enter_region(x, ctx, ctx.tp_axis)  # column-parallel entry

    def w(name, dim):
        return gather_param(params[name].to(dt), ctx, dim, d)

    up = torch.einsum("bsd,df->bsf", x, w("w_up", 0))
    if cfg.act in GATED_ACTS:
        gate = torch.einsum("bsd,df->bsf", x, w("w_gate", 0))
        nl = F.silu if cfg.act == "swiglu" else _gelu
        h = nl(gate) * up
    else:
        h = _gelu(up)
    y = torch.einsum("bsf,fd->bsd", h, w("w_down", 1))
    if split:
        y = psum(y, ctx, ctx.tp_axis)        # row-parallel partial sums
    return y

"""Mixture-of-Experts FFN with expert parallelism (port of
`repro.models.moe`).

Two execution paths with identical math (up to capacity dropping):

* `moe_dense` computes every expert for every token and combines the
  outputs with the top-k gate weights: exact, O(E) compute, the path
  without a mesh. The expert FFN is three batched products (the
  reference's are jnp einsums outside any Pallas kernel).
* `moe_ep` over a mesh: each rank routes its tokens with the
  capacity-bounded sort-based dispatch (`_moe_local`), exchanges them
  over the EP (model) axis with `all_to_all`, runs its local experts and
  sends the outputs back, the DeepSeek-style EP schedule of the
  reference's `shard_map` body on `torch.distributed`.

The router runs in float32 and the gates are renormalized over the top k.

In training (`local_batch=True`, with grad) the same schedule runs
through the autograd collectives of `common.parallel`: under the
training rules the router and the expert weights hold d / n_data of
their embed dim and are gathered over the fsdp axis (a reduce-scatter
backward), the router's experts over the EP axis with a summed backward
(each rank routes its own tokens), x enters the EP region before the
rank takes its block of the sequence, and `all_to_all`'s backward is the
inverse exchange. The load-balance statistics' `psum` over every axis
sums their cotangent over the dp axes, whose ranks' losses all read the
global aux. Where the sequence does not split over the EP axis (S % ep
!= 0) every rank routes every token, as the forward without grad does:
the router logits, the aux and the expert outputs of every token are
then computed alike on every rank, each receiving the whole cotangent.
So that this replicated work counts once, y's cotangent is divided by
the EP size (`parallel.count_once`) before the ranks' parts are summed
over the axis (x entering the region, the router's reduce-scatter); the
aux needs no division, its statistics already summing ep copies of each
token.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.parallel import (
    SINGLE,
    ParallelCtx,
    all_gather,
    all_to_all,
    count_once,
    enter_region,
    gather_param,
    local_slice,
    psum,
)
from repro_torch.models.layers import GATED_ACTS, _gelu
from repro_torch.models.module import Initializer


# the moe_ff dim of each expert weight
FF_DIM = {"w_gate": 2, "w_up": 2, "w_down": 1}


def moe_init(init: Initializer, cfg: ModelConfig):
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    init.param("router", (d, e), ("embed", "experts"))
    if cfg.act in GATED_ACTS:
        init.param("w_gate", (e, d, ff), ("experts", "embed", "moe_ff"))
    init.param("w_up", (e, d, ff), ("experts", "embed", "moe_ff"))
    init.param("w_down", (e, ff, d), ("experts", "moe_ff", "embed"))


def top_k(probs: torch.Tensor, k: int):
    """The k largest entries of the last axis and their indices, the
    lower index first among equal values (`jax.lax.top_k`'s order;
    `torch.topk` promises none on ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(params, x32, cfg: ModelConfig):
    """Router logits -> (gates (T, k) f32, expert ids (T, k) int64,
    probs (T, E) f32)."""
    logits = x32 @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = top_k(probs, cfg.experts_per_token)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, idx, probs


def _expert_ffn(w, h, cfg: ModelConfig):
    """Batched expert FFN: h (E, C, d) -> (E, C, d)."""
    dt = h.dtype
    up = torch.einsum("ecd,edf->ecf", h, w["w_up"].to(dt))
    if cfg.act in GATED_ACTS:
        gate = torch.einsum("ecd,edf->ecf", h, w["w_gate"].to(dt))
        nl = torch.nn.functional.silu if cfg.act == "swiglu" else _gelu
        a = nl(gate) * up
    else:
        a = _gelu(up)
    return torch.einsum("ecf,efd->ecd", a, w["w_down"].to(dt))


def _aux_loss(probs, idx, cfg: ModelConfig):
    """Switch-style load-balance loss: E * sum_e f_e * p_e."""
    E = cfg.num_experts
    hits = torch.nn.functional.one_hot(idx, E).float().sum(dim=1)
    f = hits.mean(dim=0) / cfg.experts_per_token
    p = probs.mean(dim=0)
    return E * torch.sum(f * p)


def moe_dense(params, x, cfg: ModelConfig):
    """Every expert computed for every token. x (B, S, d) -> (y (B, S, d),
    aux scalar float32)."""
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    gates, idx, probs = _route(params, xf.float(), cfg)
    # c.at[i].add(g) per token: a float32 scatter-add of the gates
    combine = torch.zeros((xf.shape[0], cfg.num_experts),
                          dtype=torch.float32, device=x.device)
    combine.scatter_add_(1, idx, gates)
    out = _expert_ffn(params, xf[None].expand((cfg.num_experts,)
                                              + tuple(xf.shape)), cfg)
    y = torch.einsum("etd,te->td", out.float(), combine).to(x.dtype)
    return y.reshape(B, S, d), _aux_loss(probs, idx, cfg)


# ------------------------------------------------------------------ EP
def _capacity(tokens_local: int, cfg: ModelConfig) -> int:
    c = math.ceil(
        tokens_local * cfg.experts_per_token * cfg.capacity_factor
        / cfg.num_experts
    )
    return max(int(c), 4)


def _moe_local(params, x, cfg: ModelConfig, ctx: ParallelCtx,
               ep_axis: Optional[str], fsdp_axis: Optional[str],
               ep_size: int, fsdp_mode: str = "rowcol"):
    """One rank's body. x (T_loc, d); params the rank's expert shard
    (E / ep_size experts; with `fsdp_axis`, its block of each expert's
    ff dim). Returns (y (T_loc, d), aux).

    fsdp_mode handles the ff dim sharded over `fsdp_axis`:
      "gather" — all-gather the weights (classic FSDP);
      "rowcol" — column/row-parallel expert products on the ff shard and
                 one sum of the expert OUTPUT over the fsdp axis, which
                 is right only where every rank of that axis holds the
                 same tokens (`moe_ep` picks "gather" otherwise).

    Dispatch: the (token, choice) pairs sorted stably by expert, each
    pair's position within its expert from `searchsorted`, slot = expert
    * C + position, pairs past the capacity C dropped."""
    T, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    E_loc = E // ep_size
    C = _capacity(T, cfg)

    w = params
    rowcol = fsdp_axis is not None and fsdp_mode == "rowcol"
    if fsdp_axis is not None and not rowcol:
        w = dict(params)
        for name, dim in FF_DIM.items():
            if name in params and params[name].shape[dim] != cfg.moe_d_ff:
                w[name] = all_gather(params[name].to(x.dtype), ctx,
                                     fsdp_axis, dim, reduce_grad=True)

    gates, idx, probs = _route(w, x.float(), cfg)

    flat_e = idx.reshape(-1)                          # (T*k,)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(k)
    flat_g = gates.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    first = torch.searchsorted(se, torch.arange(E, device=x.device))
    pos = torch.arange(T * k, device=x.device) - first[se]
    keep = pos < C
    slot = se * C + torch.where(keep, pos, 0)

    send = torch.zeros((E * C, d), dtype=x.dtype, device=x.device)
    send.index_add_(0, slot, torch.where(keep[:, None], x[st], 0))
    send = send.reshape(ep_size, E_loc, C, d)
    recv = all_to_all(send, ctx, ep_axis) if ep_size > 1 else send
    h = recv.transpose(0, 1).reshape(E_loc, ep_size * C, d)

    out = _expert_ffn(w, h, cfg)                      # (E_loc, M*C, d)
    if rowcol:
        out = psum(out, ctx, fsdp_axis)   # row-parallel epilogue, ff dim

    out = out.reshape(E_loc, ep_size, C, d).transpose(0, 1).contiguous()
    back = all_to_all(out, ctx, ep_axis) if ep_size > 1 else out
    flat_back = back.reshape(E * C, d)

    contrib = flat_back[slot].float() * sg[:, None]
    contrib = torch.where(keep[:, None], contrib, 0.0)
    y = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    y.index_add_(0, st, contrib)

    # the load-balance aux over the GLOBAL token set: the sufficient
    # statistics (dispatch counts, router prob sums, token count) summed
    # over every axis, since the loss is not linear over token partitions
    stats = torch.cat([
        torch.nn.functional.one_hot(idx, E).float().sum(dim=(0, 1)),
        probs.sum(dim=0),
        torch.full((1,), float(T), device=x.device)])
    stats = psum(stats, ctx, ctx.all_axes)
    counts, p_sum, t_cnt = stats[:E], stats[E:2 * E], stats[2 * E]
    f = counts / (t_cnt * k)
    p = p_sum / t_cnt
    aux = E * torch.sum(f * p)
    return y.to(x.dtype), aux


def moe_ep(params, x, cfg: ModelConfig, ctx: ParallelCtx = SINGLE, *,
           local_batch: bool = False):
    """Expert-parallel MoE. x (B, S, d) -> (y, aux). Without a mesh it is
    `moe_dense`, as in the reference.

    Over a mesh `params` is the rank's shard: its E / ep experts (EP over
    the tp axis) and, where the rules split `moe_ff`, its block of their
    ff dim over the fsdp axis. x is the batch every dp rank holds; the
    rank takes its rows when B divides by the dp size and its block of
    the sequence over the EP axis (`shard_seq_moe`, S % ep == 0), as the
    reference's shard_map in_specs split them, and gathers y back.
    `local_batch` says x already holds only this rank's rows of a batch
    split over the dp axes (the decode step's slots, the train step's
    rows): no further split. Where the dp axes split the tokens over the
    fsdp axis, the ff shards are gathered ("gather") instead of the
    expert outputs being summed over that axis ("rowcol" would add other
    ranks' tokens), and where only some of the weights split it (the
    training rules give w_gate / w_up's embed dim to the fsdp axis and
    w_down's ff dim, the first of its dims to ask). Weights split on
    their embed dim are gathered whole over the fsdp axis first. With
    grad, x enters the EP region: each rank routes its own block of the
    sequence, or every token where S % ep != 0, and then y's cotangent
    is counted once over the EP axis (module docstring)."""
    if ctx.mesh is None:
        return moe_dense(params, x, cfg)
    B, S, d = x.shape
    ep_axis = ctx.tp_axis
    ep_size = ctx.axis_size(ep_axis)
    if cfg.num_experts % max(ep_size, 1):
        raise ValueError(f"{cfg.num_experts} experts over an EP axis of "
                         f"{ep_size}")
    E_loc = params["w_up"].shape[0]
    if E_loc * ep_size != cfg.num_experts:
        raise ValueError(f"the rank holds {E_loc} experts; EP over "
                         f"{ep_size} ranks needs {cfg.num_experts // ep_size}")
    ff_split = {k for k, dim in FF_DIM.items()
                if k in params and params[k].shape[dim] != cfg.moe_d_ff}
    fsdp = ctx.fsdp_axis if ff_split else None
    embed_dim = {"router": 0, "w_gate": 1, "w_up": 1, "w_down": 2}
    params = {k: gather_param(v, ctx, embed_dim[k], d)
              for k, v in params.items()}
    router = params["router"]                 # every rank routes alike
    if router.shape[1] != cfg.num_experts:
        router = all_gather(router, ctx, ep_axis, 1, reduce_grad=True)
    params = dict(params, router=router)
    dp_split = not local_batch and ctx.batch_split(B)
    mode = ctx.moe_fsdp_mode
    if fsdp is not None and ((local_batch or dp_split)
                             and fsdp in ctx.dp_axes
                             or ff_split != set(FF_DIM) & set(params)):
        mode = "gather"
    seq_split = (ctx.shard_seq_moe and ep_axis is not None and ep_size > 1
                 and S % ep_size == 0 and S >= ep_size)
    xs = x
    if dp_split:
        xs = local_slice(xs, ctx, ctx.dp_axes, 0)
    xs = enter_region(xs, ctx, ep_axis)
    if seq_split:
        xs = local_slice(xs, ctx, ep_axis, 1)
    bs, ss = xs.shape[0], xs.shape[1]
    y, aux = _moe_local(params, xs.reshape(-1, d), cfg, ctx, ep_axis, fsdp,
                        ep_size, fsdp_mode=mode)
    if not seq_split:               # every rank routed every token
        y = count_once(y, ctx, ep_axis)
    y = y.reshape(bs, ss, d)
    if seq_split:
        y = all_gather(y, ctx, ep_axis, 1)
    if dp_split:
        y = all_gather(y, ctx, ctx.dp_axes, 0)
    return y, aux

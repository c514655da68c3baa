"""Mixture-of-Experts FFN (port of the meshless path of
`repro.models.moe`).

`moe_dense` computes every expert for every token and combines the
outputs with the top-k gate weights: exact, O(E) compute, the path the
reference takes whenever there is no mesh. The expert FFN is three
batched products (the reference's are jnp einsums outside any Pallas
kernel). The router runs in float32 and the gates are renormalized over
the top k.

`moe_ep` under a mesh (the capacity-bounded all_to_all dispatch of the
reference's `_moe_local`) ports with mesh sharding (ROADMAP A16).
"""

from __future__ import annotations

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.models.layers import GATED_ACTS, _gelu
from repro_torch.models.module import Initializer


def moe_init(init: Initializer, cfg: ModelConfig):
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    init.param("router", (d, e))
    if cfg.act in GATED_ACTS:
        init.param("w_gate", (e, d, ff))
    init.param("w_up", (e, d, ff))
    init.param("w_down", (e, ff, d))


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


def moe_ep(params, x, cfg: ModelConfig, mesh=None):
    """Expert-parallel MoE, x (B, S, d) -> (y, aux). Without a mesh the
    reference returns `moe_dense`, and so does the port."""
    if mesh is None:
        return moe_dense(params, x, cfg)
    raise NotImplementedError(
        "moe_ep over a mesh (capacity dispatch + all_to_all) ports with "
        "mesh sharding (ROADMAP A16)")

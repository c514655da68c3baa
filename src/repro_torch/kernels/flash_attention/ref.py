"""Plain PyTorch version of dense GQA attention (the counterpart of
`repro.kernels.flash_attention.ref.mha`, with the Pallas kernel's masking
semantics: masked logits are -1e30, not -inf, and the softmax denominator
is clamped at 1e-30, so a fully masked row stays finite)."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


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
    B, Sq, H, D = q.shape
    _, Skv, KV, _ = k.shape
    if H % KV:
        raise ValueError(f"num_heads {H} not a multiple of kv heads {KV}")
    rep = H // KV
    scale = scale if scale is not None else D ** -0.5

    kq = k.repeat_interleave(rep, dim=2).float()      # GQA: kv -> q heads
    vq = v.repeat_interleave(rep, dim=2).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kq) * scale
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None] + kv_offset
        kpos = torch.arange(Skv, device=q.device)[None, :]
        logits = torch.where(qpos >= kpos, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l_safe = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    out = torch.einsum("bhqk,bkhd->bhqd", p, vq) / l_safe
    out = out.permute(0, 2, 1, 3).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l_safe))[..., 0]
    return out

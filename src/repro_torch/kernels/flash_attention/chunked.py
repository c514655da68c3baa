"""Memory-bounded attention in plain PyTorch: the forward of
`repro.kernels.flash_attention.chunked` (`mha_chunked`), the plain
version `ops.mha` takes above 256 x 256 scores.

The same tiling and online softmax as the flash kernel, as loops over
query and key blocks, so the scores live one (block_q, block_k) tile at a
time instead of as the full (B, H, Sq, Skv) tensor. A causal square
attention visits only the lower-triangle tiles (`_fwd_triangular`). The
backward (the reference's custom_vjp `_bwd_inner`) is not ported yet
(ROADMAP B11)."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _scores(qb, kb, scale):
    """qb (B,bq,G,R,D), kb (B,bk,G,D) -> (B,G,R,bq,bk) float32."""
    return torch.einsum("bqgrd,bkgd->bgrqk", qb.float(), kb.float()) * scale


def _pick_block(s: int, target: int) -> int:
    b = min(s, target)
    while s % b:
        b //= 2
    return max(b, 1)


def mha_chunked(q, k, v, causal: bool = True, scale: Optional[float] = None,
                kv_offset: int = 0, block_q: int = 512,
                block_k: int = 512) -> torch.Tensor:
    """GQA attention q (B,Sq,H,D), k/v (B,Skv,KV,D) -> (B,Sq,H,D) in q's
    dtype, accumulated in float32 block by block."""
    out, _ = _fwd(q, k, v, causal, scale, kv_offset, block_q, block_k)
    return out


def _fwd(q, k, v, causal, scale, kv_offset, block_q, block_k):
    """(out, lse (B, KV, H // KV, Sq) float32)."""
    if (causal and kv_offset == 0 and q.shape[1] == k.shape[1]
            and q.shape[1] // _pick_block(q.shape[1], block_q) >= 4):
        return _fwd_triangular(q, k, v, scale, block_q, block_k)
    return _fwd_inner(q, k, v, causal, scale, kv_offset, block_q, block_k)


def _update(s, vb, acc, m, l):
    """One tile's online-softmax step; s (B,G,R,bq,bk) masked scores."""
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(-1)
    pv = torch.einsum("bgrqk,bkgd->bgrqd", p, vb.float())
    return acc * alpha[..., None] + pv, m_new, l


def _finish(acc, m, l, dtype):
    """Normalized block output (B,bq,H,D) and its lse (B,G,R,bq)."""
    l_safe = torch.clamp_min(l, 1e-30)
    ob = (acc / l_safe[..., None]).to(dtype)             # (B,G,R,bq,D)
    B, G, R, bq, D = ob.shape
    return (ob.permute(0, 3, 1, 2, 4).reshape(B, bq, G * R, D),
            m + torch.log(l_safe))


def _init(B, G, R, bq, D, device):
    return (torch.zeros((B, G, R, bq, D), dtype=torch.float32, device=device),
            torch.full((B, G, R, bq), NEG_INF, dtype=torch.float32,
                       device=device),
            torch.zeros((B, G, R, bq), dtype=torch.float32, device=device))


def _fwd_triangular(q, k, v, scale, block_q, block_k):
    """Causal square attention over the lower-triangle tiles only, in the
    reference's row-major order (0,0), (1,0), (1,1), (2,0), ..."""
    B, Sq, H, D = q.shape
    G = k.shape[2]
    R = H // G
    scale = scale if scale is not None else D ** -0.5
    bq = _pick_block(Sq, block_q)
    bk = bq                      # the row-major flush needs aligned tiles
    nq = Sq // bq
    qg = q.reshape(B, Sq, G, R, D)
    out = torch.empty_like(q)
    lse = torch.empty((B, G, R, Sq), dtype=torch.float32, device=q.device)
    pos = torch.arange(bq, device=q.device)
    for qi in range(nq):
        acc, m, l = _init(B, G, R, bq, D, q.device)
        qb = qg[:, qi * bq:(qi + 1) * bq]
        for ki in range(qi + 1):
            s = _scores(qb, k[:, ki * bk:(ki + 1) * bk], scale)
            mask = (qi * bq + pos)[:, None] >= (ki * bk + pos)[None, :]
            s = torch.where(mask, s, NEG_INF)
            acc, m, l = _update(s, v[:, ki * bk:(ki + 1) * bk], acc, m, l)
        ob, lse_b = _finish(acc, m, l, q.dtype)
        out[:, qi * bq:(qi + 1) * bq] = ob
        lse[..., qi * bq:(qi + 1) * bq] = lse_b
    return out, lse


def _fwd_inner(q, k, v, causal, scale, kv_offset, block_q, block_k):
    """Every (query block, key block) tile, causal mask offset by
    `kv_offset` (the absolute position of q[0] relative to k[0])."""
    B, Sq, H, D = q.shape
    Skv, G = k.shape[1], k.shape[2]
    R = H // G
    scale = scale if scale is not None else D ** -0.5
    bq = _pick_block(Sq, block_q)
    bk = _pick_block(Skv, block_k)
    nq, nk = Sq // bq, Skv // bk
    qg = q.reshape(B, Sq, G, R, D)
    out = torch.empty_like(q)
    lse = torch.empty((B, G, R, Sq), dtype=torch.float32, device=q.device)
    for qi in range(nq):
        acc, m, l = _init(B, G, R, bq, D, q.device)
        qb = qg[:, qi * bq:(qi + 1) * bq]
        for ki in range(nk):
            s = _scores(qb, k[:, ki * bk:(ki + 1) * bk], scale)
            if causal:
                qpos = kv_offset + qi * bq + torch.arange(bq, device=q.device)
                kpos = ki * bk + torch.arange(bk, device=q.device)
                s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
            acc, m, l = _update(s, v[:, ki * bk:(ki + 1) * bk], acc, m, l)
        ob, lse_b = _finish(acc, m, l, q.dtype)
        out[:, qi * bq:(qi + 1) * bq] = ob
        lse[..., qi * bq:(qi + 1) * bq] = lse_b
    return out, lse

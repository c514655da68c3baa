"""Memory-bounded attention in plain PyTorch (port of
`repro.kernels.flash_attention.chunked`): `mha_chunked`, the plain
version `ops.mha` takes above 256 x 256 scores, with its backward.

The same tiling and online softmax as the flash kernel, as loops over
query and key blocks, so the scores live one (block_q, block_k) tile at a
time instead of as the full (B, H, Sq, Skv) tensor. A causal square
attention visits only the lower-triangle tiles (`_fwd_triangular`).

`mha_chunked` is a `torch.autograd.Function` whose backward is the
reference's custom_vjp (`_bwd_inner`): P is recomputed from the saved
logsumexp tile by tile, dq in a pass over query blocks and dk/dv in a
pass over key blocks, so training never materializes the score matrix
either. `_bwd_inner` is also the plain version of the CUDA backward
(`csrc/flash_attention_bwd.cu`)."""

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


class _MhaChunked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale, kv_offset, block_q, block_k):
        out, lse = _fwd(q, k, v, causal, scale, kv_offset, block_q, block_k)
        ctx.args = (causal, scale, kv_offset, block_q, block_k)
        if ctx.needs_input_grad[:3] != (False, False, False):
            ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = _bwd_inner(*ctx.args, ctx.saved_tensors, dout)
        return dq, dk, dv, None, None, None, None, None


def mha_chunked(q, k, v, causal: bool = True, scale: Optional[float] = None,
                kv_offset: int = 0, block_q: int = 512,
                block_k: int = 512) -> torch.Tensor:
    """GQA attention q (B,Sq,H,D), k/v (B,Skv,KV,D) -> (B,Sq,H,D) in q's
    dtype, accumulated in float32 block by block; differentiable through
    the chunked backward."""
    return _MhaChunked.apply(q, k, v, causal, scale, kv_offset, block_q,
                             block_k)


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


# ------------------------------------------------------------ backward
def _tri_indices(nq: int):
    """Row-major lower-triangle tile order: (0,0),(1,0),(1,1),(2,0)..."""
    qi = [i for i in range(nq) for _ in range(i + 1)]
    ki = [j for i in range(nq) for j in range(i + 1)]
    return qi, ki


def _bwd_inner(causal, scale, kv_offset, block_q, block_k, res, dout):
    """(dq, dk, dv) in the inputs' dtypes from res = (q, k, v, out, lse
    (B, KV, H // KV, Sq) float32) and dout, accumulated in float32."""
    q, k = res[0], res[1]
    if (causal and kv_offset == 0 and q.shape[1] == k.shape[1]
            and q.shape[1] // _pick_block(q.shape[1], block_q) >= 4):
        return _bwd_triangular(scale, block_q, res, dout)
    return _bwd_rect(causal, scale, kv_offset, block_q, block_k, res, dout)


def _bwd_prep(res, dout, nq):
    """Grouped views: q5 (B,Sq,G,R,D), dO and O in float32, and the
    per-block lse / delta = rowsum(dO * O) rows (B,G,R,bq) of q block i."""
    q, k, v, out, lse = res
    B, Sq, H, D = q.shape
    G = k.shape[2]
    R = H // G
    q5 = q.reshape(B, Sq, G, R, D)
    do5 = dout.reshape(B, Sq, G, R, D).float()
    o5 = out.reshape(B, Sq, G, R, D).float()
    delta = torch.einsum("bsgrd,bsgrd->bgrs", do5, o5)
    lse = lse.reshape(B, G, R, Sq)
    bq = Sq // nq
    rows = lambda t, i: t[..., i * bq:(i + 1) * bq]  # noqa: E731
    return q5, do5, [rows(lse, i) for i in range(nq)], \
        [rows(delta, i) for i in range(nq)]


def _tile_ds(qb, kb, vb, dob, lseb, deltab, sc, mask):
    """p and ds (B,G,R,bq,bk) of one (query block, key block) tile,
    recomputed from the saved lse; `mask` (bq, bk) bool or None."""
    s = _scores(qb, kb, sc)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - lseb[..., None])
    dp = torch.einsum("bqgrd,bkgd->bgrqk", dob, vb.float())
    ds = p * (dp - deltab[..., None]) * sc
    return p, ds


def _bwd_triangular(scale, block_q, res, dout):
    """Causal backward visiting only lower-triangle tiles (dq pass
    row-major, dk/dv pass column-major)."""
    q, k, v, _, _ = res
    B, Sq, H, D = q.shape
    G = k.shape[2]
    R = H // G
    sc = scale if scale is not None else D ** -0.5
    bq = _pick_block(Sq, block_q)
    nq = Sq // bq
    q5, do5, lses, deltas = _bwd_prep(res, dout, nq)
    pos = torch.arange(bq, device=q.device)
    blk = lambda t, i: t[:, i * bq:(i + 1) * bq]  # noqa: E731

    def tile(qi, ki):
        mask = (qi * bq + pos)[:, None] >= (ki * bq + pos)[None, :]
        return _tile_ds(blk(q5, qi), blk(k, ki), blk(v, ki), blk(do5, qi),
                        lses[qi], deltas[qi], sc, mask)

    # pass 1: dq, row-major triangle
    dq = torch.empty((B, Sq, G, R, D), dtype=torch.float32, device=q.device)
    qidx, kidx = _tri_indices(nq)
    for qi, ki in zip(qidx, kidx):
        if ki == 0:
            acc = torch.zeros((B, bq, G, R, D), dtype=torch.float32,
                              device=q.device)
        _, ds = tile(qi, ki)
        acc = acc + torch.einsum("bgrqk,bkgd->bqgrd", ds,
                                 blk(k, ki).float())
        if ki == qi:
            dq[:, qi * bq:(qi + 1) * bq] = acc

    # pass 2: dk/dv, column-major triangle
    dk = torch.empty((B, Sq, G, D), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    for ki in range(nq):
        dkb = torch.zeros((B, bq, G, D), dtype=torch.float32,
                          device=q.device)
        dvb = torch.zeros_like(dkb)
        for qi in range(ki, nq):
            p, ds = tile(qi, ki)
            dvb = dvb + torch.einsum("bgrqk,bqgrd->bkgd", p, blk(do5, qi))
            dkb = dkb + torch.einsum("bgrqk,bqgrd->bkgd", ds,
                                     blk(q5, qi).float())
        dk[:, ki * bq:(ki + 1) * bq] = dkb
        dv[:, ki * bq:(ki + 1) * bq] = dvb
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _bwd_rect(causal, scale, kv_offset, block_q, block_k, res, dout):
    """Every (query block, key block) tile, causal mask offset by
    `kv_offset`: dq outer over query blocks, dk/dv outer over key
    blocks."""
    q, k, v, _, _ = res
    B, Sq, H, D = q.shape
    Skv, G = k.shape[1], k.shape[2]
    R = H // G
    sc = scale if scale is not None else D ** -0.5
    bq = _pick_block(Sq, block_q)
    bk = _pick_block(Skv, block_k)
    nq, nk = Sq // bq, Skv // bk
    q5, do5, lses, deltas = _bwd_prep(res, dout, nq)
    qb_ = lambda t, i: t[:, i * bq:(i + 1) * bq]  # noqa: E731
    kb_ = lambda t, j: t[:, j * bk:(j + 1) * bk]  # noqa: E731

    def tile(qi, ki):
        mask = None
        if causal:
            qpos = kv_offset + qi * bq + torch.arange(bq, device=q.device)
            kpos = ki * bk + torch.arange(bk, device=q.device)
            mask = qpos[:, None] >= kpos[None, :]
        return _tile_ds(qb_(q5, qi), kb_(k, ki), kb_(v, ki), qb_(do5, qi),
                        lses[qi], deltas[qi], sc, mask)

    # pass 1: dq, outer over q blocks, inner accumulating over kv blocks
    dq = torch.empty((B, Sq, G, R, D), dtype=torch.float32, device=q.device)
    for qi in range(nq):
        acc = torch.zeros((B, bq, G, R, D), dtype=torch.float32,
                          device=q.device)
        for ki in range(nk):
            _, ds = tile(qi, ki)
            acc = acc + torch.einsum("bgrqk,bkgd->bqgrd", ds,
                                     kb_(k, ki).float())
        dq[:, qi * bq:(qi + 1) * bq] = acc

    # pass 2: dk/dv, outer over kv blocks, inner accumulating over q blocks
    dk = torch.empty((B, Skv, G, D), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    for ki in range(nk):
        dkb = torch.zeros((B, bk, G, D), dtype=torch.float32,
                          device=q.device)
        dvb = torch.zeros_like(dkb)
        for qi in range(nq):
            p, ds = tile(qi, ki)
            dvb = dvb + torch.einsum("bgrqk,bqgrd->bkgd", p, qb_(do5, qi))
            dkb = dkb + torch.einsum("bgrqk,bqgrd->bkgd", ds,
                                     qb_(q5, qi).float())
        dk[:, ki * bk:(ki + 1) * bk] = dkb
        dv[:, ki * bk:(ki + 1) * bk] = dvb
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))

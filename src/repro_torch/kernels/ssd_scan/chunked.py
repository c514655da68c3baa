"""Chunked SSD (state-space duality) in matmul form, the plain version of
the CUDA kernel (`repro.kernels.ssd_scan.chunked`, same algorithm).

The O(S) sequential recurrence becomes the Mamba2 chunked algorithm: an
intra-chunk quadratic form (Q x Q products) plus an inter-chunk state
recurrence over S/Q steps. Every decay exponential has a non-positive
argument (A < 0, dt > 0, i >= j), so no max subtraction is needed.
"""

from __future__ import annotations

from typing import Optional

import torch


def _pick_chunk(S: int, target: int) -> int:
    """The reference's chunk length: halve min(S, target) until it
    divides S (S=65 gives 1)."""
    c = min(S, target)
    while S % c:
        c //= 2
    return max(c, 1)


def ssd_chunked(x, dt, A, Bmat, Cmat, D: Optional[torch.Tensor] = None,
                init_state: Optional[torch.Tensor] = None,
                chunk: int = 128):
    """x (B,S,H,P), dt (B,S,H), A (H,) <= 0, Bmat/Cmat (B,S,G,N), D (H,),
    init_state (B,H,P,N). Returns (y (B,S,H,P) in x's dtype, final state
    (B,H,P,N)). Computes in float32, as the reference, or in float64 for
    float64 x (a dtype the reference's JAX has no use for): the
    high-precision evaluation the CUDA kernel is held against on the
    card."""
    Bz, S, H, P = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    rep = H // G
    Q = _pick_chunk(S, chunk)
    nc = S // Q
    f32 = torch.promote_types(x.dtype, torch.float32)

    xq = x.to(f32).reshape(Bz, nc, Q, H, P)
    dtq = dt.to(f32).reshape(Bz, nc, Q, H)
    Bq = torch.repeat_interleave(Bmat.to(f32), rep, dim=2).reshape(
        Bz, nc, Q, H, N)
    Cq = torch.repeat_interleave(Cmat.to(f32), rep, dim=2).reshape(
        Bz, nc, Q, H, N)

    a = A.to(f32)[None, None, None, :] * dtq             # (B,nc,Q,H) <= 0
    cum = torch.cumsum(a, dim=2)                         # inclusive
    total = cum[:, :, -1, :]                             # (B,nc,H)

    # intra-chunk: Y[i] = sum_{j<=i} exp(cum_i - cum_j) (C_i.B_j) dt_j x_j
    scores = torch.einsum("bcqhn,bckhn->bchqk", Cq, Bq)  # (B,nc,H,Q,Q)
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    decay = torch.movedim(decay, -1, 2)                  # (B,nc,H,Q,Q)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    # masked before the exp: above the diagonal decay > 0 and exp may
    # overflow, and exp's backward there would be 0 * inf = NaN. The
    # reference masks after the exp (the same forward values), so its
    # grads are NaN wherever a chunk's decay passes float32's range
    # (ROADMAP §C); these stay finite.
    L = torch.exp(torch.where(mask, decay, float("-inf")))
    dx = dtq[..., None] * xq                             # (B,nc,Q,H,P)
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", scores * L, dx)

    # chunk states: h_c = sum_j exp(total_c - cum_j) dt_j B_j (x) x_j
    w = torch.exp(total[:, :, None, :] - cum)            # (B,nc,Q,H)
    hc = torch.einsum("bcqhn,bcqhp->bchpn", w[..., None] * Bq, dx)

    # inter-chunk recurrence over nc, the state BEFORE each chunk kept
    h = (torch.zeros((Bz, H, P, N), dtype=f32, device=x.device)
         if init_state is None else init_state.to(f32))
    hprevs = []
    for c in range(nc):
        hprevs.append(h)
        h = torch.exp(total[:, c])[..., None, None] * h + hc[:, c]
    hprevs = torch.stack(hprevs, dim=1)                  # (B,nc,H,P,N)

    # inter-chunk contribution: Y[i] += exp(cum_i) C_i . H_{c-1}
    y_inter = torch.exp(cum)[..., None] * torch.einsum(
        "bcqhn,bchpn->bcqhp", Cq, hprevs)

    y = (y_intra + y_inter).reshape(Bz, S, H, P)
    if D is not None:
        y = y + D.to(f32)[None, None, :, None] * x.to(f32)
    return y.to(x.dtype), h

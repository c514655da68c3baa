"""Plain PyTorch oracle of the Mamba2 SSD recurrence, the exact sequential
scan (`repro.kernels.ssd_scan.ref`, same semantics).

State update (per batch b, head h):
    h_t = exp(A_h * dt_t) * h_{t-1} + dt_t * (B_t outer x_t)
    y_t = C_t . h_t + D_h * x_t
Shapes: x (B,S,H,P), dt (B,S,H), A (H,) <= 0, B/C (B,S,G,N), state h (H,P,N).
G groups share B/C across H//G heads. Everything is computed in float32
(float64 for float64 x, a dtype the reference's JAX has no use for); y
comes back in x's dtype, the state in float32.
"""

from __future__ import annotations

from typing import Optional

import torch


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bmat: torch.Tensor, Cmat: torch.Tensor,
        D: Optional[torch.Tensor] = None,
        init_state: Optional[torch.Tensor] = None):
    Bsz, S, H, P = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    rep = H // G
    f32 = torch.promote_types(x.dtype, torch.float32)   # float64 stays
    x32, dt32, A32 = x.to(f32), dt.to(f32), A.to(f32)
    Bh = torch.repeat_interleave(Bmat.to(f32), rep, dim=2)   # (B,S,H,N)
    Ch = torch.repeat_interleave(Cmat.to(f32), rep, dim=2)
    h = (torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
         if init_state is None else init_state.to(f32))
    ys = []
    for t in range(S):
        decay = torch.exp(A32[None, :] * dt32[:, t])          # (B,H)
        upd = ((dt32[:, t, :, None] * x32[:, t])[..., None]
               * Bh[:, t, :, None, :])                         # (B,H,P,N)
        h = decay[..., None, None] * h + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    y = torch.stack(ys, dim=1)
    if D is not None:
        y = y + D.to(f32)[None, None, :, None] * x32
    return y.to(x.dtype), h


def ssd_decode(x, dt, A, Bt, Ct, D, state):
    """One decode step. x (B,H,P), dt (B,H), Bt/Ct (B,G,N), state
    (B,H,P,N). Returns (y (B,H,P) in x's dtype, new state float32)."""
    H = x.shape[1]
    rep = H // Bt.shape[1]
    Bh = torch.repeat_interleave(Bt.float(), rep, dim=1)
    Ch = torch.repeat_interleave(Ct.float(), rep, dim=1)
    dt32 = dt.float()
    decay = torch.exp(A.float()[None, :] * dt32)
    upd = (dt32[..., None] * x.float())[..., None] * Bh[:, :, None, :]
    new_state = decay[..., None, None] * state.float() + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    if D is not None:
        y = y + D.float()[None, :, None] * x.float()
    return y.to(x.dtype), new_state

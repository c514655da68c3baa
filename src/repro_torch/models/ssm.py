"""Mamba2 (SSD) block: in_proj -> causal depthwise conv -> selective SSM ->
gated RMSNorm -> out_proj (port of `repro.models.ssm`, same dtype
handling).

The prompt pass runs the chunked SSD scan (`kernels.ssd_scan`: the CUDA
kernel on the card, the plain versions on the CPU); decode is one O(1)
recurrence step per token, plain PyTorch. Decode keeps two small states
per layer: the SSM state (B, H, P, N) in float32 and the conv tails
(B, W-1, channels) in the activation dtype.
"""

from __future__ import annotations

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.module import Initializer, torch_dtype

NGROUPS = 1  # B/C groups (mamba2 default)


def ssm_init(init: Initializer, cfg: ModelConfig):
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    h, w = cfg.ssm_heads, cfg.conv_width
    gn = NGROUPS * n
    init.param("w_in_x", (d, di), ("embed", "ssm_inner"))
    init.param("w_in_z", (d, di), ("embed", "ssm_inner"))
    init.param("w_in_B", (d, gn), ("embed", None))
    init.param("w_in_C", (d, gn), ("embed", None))
    init.param("w_in_dt", (d, h), ("embed", "ssm_heads"))
    init.param("conv_x", (w, di), (None, "ssm_inner"), scale=0.5)
    init.param("conv_B", (w, gn), (None, None), scale=0.5)
    init.param("conv_C", (w, gn), (None, None), scale=0.5)
    init.param("A_log", (h,), ("ssm_heads",), init="zeros")
    init.param("D", (h,), ("ssm_heads",), init="ones")
    init.param("dt_bias", (h,), ("ssm_heads",), init="zeros")
    init.param("norm_scale", (di,), ("ssm_inner",), init="ones")
    init.param("w_out", (di, d), ("ssm_inner", "embed"))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus` as JAX computes it, logaddexp(x, 0) =
    max(x, 0) + log1p(exp(-|x|)) (torch's softplus takes another formula
    and returns x itself above its threshold)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x, w, tail=None):
    """Depthwise causal conv as the reference writes it, a sum of W
    shifted products in x's dtype (a float32 `conv1d` would go through
    cuDNN in TF32). x (B,S,C), w (W,C), tail (B,W-1,C) or None. Returns
    (y (B,S,C), new_tail (B,W-1,C))."""
    W = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([tail, x], dim=1)                 # (B, S+W-1, C)
    S = x.shape[1]
    y = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(W))
    new_tail = xp[:, xp.shape[1] - (W - 1):, :] if W > 1 else tail
    return y, new_tail


def _project(params, x):
    dt_ = x.dtype
    xs = torch.einsum("bsd,di->bsi", x, params["w_in_x"].to(dt_))
    z = torch.einsum("bsd,di->bsi", x, params["w_in_z"].to(dt_))
    Bm = torch.einsum("bsd,dn->bsn", x, params["w_in_B"].to(dt_))
    Cm = torch.einsum("bsd,dn->bsn", x, params["w_in_C"].to(dt_))
    dt = torch.einsum("bsd,dh->bsh", x, params["w_in_dt"].to(dt_))
    return xs, z, Bm, Cm, dt


def _gated_norm(params, y, z, eps: float):
    # silu(z) is cast to y's dtype BEFORE the product, as the reference
    # does, so bf16 activations round where the reference's round
    g = y * torch.nn.functional.silu(z.float()).to(y.dtype)
    g32 = g.float()
    var = torch.mean(g32 * g32, dim=-1, keepdim=True)
    return (g32 * torch.rsqrt(var + eps)
            * params["norm_scale"].float()).to(y.dtype)


def _dt_and_A(params, dt):
    dtp = softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    return dtp, A


def ssm_block(params, x, cfg: ModelConfig, return_state: bool = False,
              init_state=None, conv_tail=None):
    """Full-sequence SSD block. x: (B, S, d). With `return_state`, also
    the final SSM state and the conv tails (state, (tail_x, tail_B,
    tail_C))."""
    B, S, _ = x.shape
    H, Pd, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    xs, z, Bm, Cm, dt = _project(params, x)
    tails = conv_tail or (None, None, None)
    xs, tail_x = _causal_conv(xs, params["conv_x"].to(x.dtype), tails[0])
    Bm, tail_B = _causal_conv(Bm, params["conv_B"].to(x.dtype), tails[1])
    Cm, tail_C = _causal_conv(Cm, params["conv_C"].to(x.dtype), tails[2])
    silu = torch.nn.functional.silu
    xs, Bm, Cm = silu(xs), silu(Bm), silu(Cm)
    dtp, A = _dt_and_A(params, dt)

    y, state = ssd_ops.ssd(
        xs.reshape(B, S, H, Pd), dtp, A,
        Bm.reshape(B, S, NGROUPS, N), Cm.reshape(B, S, NGROUPS, N),
        params["D"], init_state,
    )
    y = _gated_norm(params, y.reshape(B, S, cfg.d_inner), z, cfg.norm_eps)
    out = torch.einsum("bsi,id->bsd", y, params["w_out"].to(x.dtype))
    if return_state:
        return out, (state, (tail_x, tail_B, tail_C))
    return out


def ssm_decode_step(params, x, cfg: ModelConfig, state, conv_tail):
    """One-token decode. x (B,1,d); state (B,H,P,N); conv_tail the
    3-tuple of (B, W-1, C) tails. Returns (out (B,1,d), (new_state,
    new_tails))."""
    B = x.shape[0]
    H, Pd, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    xs, z, Bm, Cm, dt = _project(params, x)

    def step_conv(xt, w, tail):
        xp = torch.cat([tail, xt], dim=1)            # (B, W, C)
        y = torch.einsum("bwc,wc->bc", xp, w)[:, None, :]
        return y, xp[:, 1:, :]

    xs, tail_x = step_conv(xs, params["conv_x"].to(x.dtype), conv_tail[0])
    Bm, tail_B = step_conv(Bm, params["conv_B"].to(x.dtype), conv_tail[1])
    Cm, tail_C = step_conv(Cm, params["conv_C"].to(x.dtype), conv_tail[2])
    silu = torch.nn.functional.silu
    xs, Bm, Cm = silu(xs), silu(Bm), silu(Cm)
    dtp, A = _dt_and_A(params, dt)
    y, new_state = ssd_ops.ssd_decode(
        xs[:, 0].reshape(B, H, Pd), dtp[:, 0], A,
        Bm[:, 0].reshape(B, NGROUPS, N), Cm[:, 0].reshape(B, NGROUPS, N),
        params["D"], state,
    )
    y = _gated_norm(params, y.reshape(B, 1, cfg.d_inner), z, cfg.norm_eps)
    out = torch.einsum("bsi,id->bsd", y, params["w_out"].to(x.dtype))
    return out, (new_state, (tail_x, tail_B, tail_C))


def make_ssm_state(cfg: ModelConfig, batch: int, n_layers: int, *,
                   device=None):
    """Zeroed decode state of `n_layers` SSM layers: the float32 SSM
    state (n_layers, batch, H, P, N) (float32 for recurrence stability)
    and the three conv tails (n_layers, batch, W-1, C) in cfg.dtype."""
    H, Pd, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    gn = NGROUPS * N
    cdt = torch_dtype(cfg.dtype)
    W = cfg.conv_width
    state = torch.zeros((n_layers, batch, H, Pd, N), dtype=torch.float32,
                        device=device)
    tails = tuple(
        torch.zeros((n_layers, batch, W - 1, c), dtype=cdt, device=device)
        for c in (cfg.d_inner, gn, gn))
    return state, tails

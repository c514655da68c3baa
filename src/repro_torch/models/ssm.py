"""Mamba2 (SSD) block: in_proj -> causal depthwise conv -> selective SSM ->
gated RMSNorm -> out_proj (port of `repro.models.ssm`, same dtype
handling).

The prompt pass runs the chunked SSD scan (`kernels.ssd_scan`: the CUDA
kernel on the card, the plain versions on the CPU); decode is one O(1)
recurrence step per token, plain PyTorch. Decode keeps two small states
per layer: the SSM state (B, H, P, N) in float32 and the conv tails
(B, W-1, channels) in the activation dtype.

Over a mesh (`ctx`, `common.parallel`; the serving rules) the block runs
the rank's block of `d_inner`. `w_in_x`, `w_in_z`, `conv_x`,
`norm_scale` and `w_out` hold channels [c0, c0 + d_inner / tp) of it
(`ssm_inner` over the model axis; `d_inner` is head-major);
`w_in_dt`, `A_log`, `D` and `dt_bias` stay whole (`ssm_heads` is never
sharded) and the rank takes its heads from them; `w_in_B` / `w_in_C` /
`conv_B` / `conv_C` stay whole. The decode state is the rank's shard of
`runtime.sharding.cache_pspec` / `paged_cache_pspec`: the state holds
its heads where they divide over the model axis and every head where
they do not, each conv tail its block of the channels where they
divide. What the split costs:

(a) the gated RMSNorm takes its mean over the WHOLE `d_inner`, as the
    reference's does: the rank sums its squares, the sums go over the
    model axis and are divided by `d_inner` (a mean over the rank's
    channels alone would be another norm);
(b) `w_out` is row-parallel: its partial sums go over the model axis;
(c) `tail_B` / `tail_C` hold the rank's block of the B / C channels,
    while B and C feed every head: the depthwise conv is channel-local,
    so the rank convolves its block with its tail block, and one
    all-gather over the model axis rebuilds the post-conv B and C;
(d) where `H % tp != 0` but `d_inner % tp == 0` the rank's block starts
    or ends inside a head. The scan is independent per channel of a
    head given the head's dt, A and D, so the rank runs its block as
    virtual heads of g = gcd(P, d_inner / tp) channels, virtual head j
    reading real head (c0 + j g) // P's `w_in_dt` column, `A_log`, `D`
    and `dt_bias` (`_rank_params`). The state then stays whole on every
    rank (`cache_pspec`): the prompt pass and each decode step gather
    the ranks' channel blocks of their final state over the model axis,
    (B, d_inner / tp, N) float32 a rank and a layer, and a decode step
    reads its own channels out of the whole state. Where the heads
    divide, g = P and the virtual heads are the rank's heads.

In training (the training rules; with grad) the same split runs as a
TP region, and every leaf's `embed` dim is split over the fsdp axis:
the block gathers `w_in_*` on dim 0 and `w_out` on dim 1 after the cast
(`parallel.gather_param`, a reduce-scatter backward). Where `d_inner`
is split x enters the region (`parallel.enter_region`), and so do the
whole leaves that feed only the rank's heads (`w_in_B`, `w_in_C`,
`conv_B`, `conv_C`, `w_in_dt`, `A_log`, `D`, `dt_bias`): a rank's
cotangent of each holds its heads' part (a virtual head's scattered
back onto its real head), and the sum over the model axis is the whole
gradient. The gated norm's summed squares are read
by every rank's channels, so their cotangent is summed over the model
axis too (trap (a)'s psum has an identity backward there).

With tp 1 (or without a mesh) nothing is split: the block is the
meshless one, op for op.
"""

from __future__ import annotations

import math

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.parallel import (
    SINGLE,
    ParallelCtx,
    all_gather,
    enter_region,
    gather_param,
    psum,
)
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


def _step_conv(xt, w, tail):
    """One decode step of the causal conv: xt (B,1,C) against its tail
    (B,W-1,C). Returns (y (B,1,C), new_tail)."""
    xp = torch.cat([tail, xt], dim=1)                # (B, W, C)
    y = torch.einsum("bwc,wc->bc", xp, w)[:, None, :]
    return y, xp[:, 1:, :]


# the whole leaves a rank's heads read (module docstring): each enters
# the TP region where `d_inner` is split
_WHOLE = ("w_in_B", "w_in_C", "conv_B", "conv_C", "w_in_dt", "A_log", "D",
          "dt_bias")


def virtual_heads(cfg: ModelConfig, di_loc: int, rank: int):
    """(g, heads) of the block [rank di_loc, (rank + 1) di_loc) of
    `d_inner` (trap (d)): it runs as di_loc / g virtual heads of g =
    gcd(P, di_loc) channels, virtual head j reading real head (rank di_loc
    + j g) // P; `heads` indexes the per-head leaves' head dim by
    virtual head (a slice of the whole heads where g = P)."""
    P = cfg.ssm_head_dim
    g, c0 = math.gcd(P, di_loc), rank * di_loc
    if g == P:
        return g, slice(c0 // P, (c0 + di_loc) // P)
    return g, [(c0 + j * g) // P for j in range(di_loc // g)]


def _rank_params(params, cfg: ModelConfig, ctx: ParallelCtx):
    """(params, g): `params` with the whole per-head leaves (`w_in_dt`,
    `A_log`, `D`, `dt_bias`) cut to the rank's virtual heads of g
    channels (`virtual_heads` of its block of `d_inner`, which its local
    `w_in_x` gives) and every whole leaf in the TP region; the leaves as
    they are, and g = P, where `d_inner` is whole."""
    di_loc = params["w_in_x"].shape[1]
    if di_loc == cfg.d_inner:
        return params, cfg.ssm_head_dim
    g, heads = virtual_heads(cfg, di_loc, ctx.index(ctx.tp_axis))
    if not isinstance(heads, slice):
        heads = torch.tensor(heads, device=params["A_log"].device)
    whole = {n: enter_region(params[n], ctx, ctx.tp_axis) for n in _WHOLE}
    whole["w_in_dt"] = whole["w_in_dt"][:, heads]
    for n in ("A_log", "D", "dt_bias"):
        whole[n] = whole[n][heads]
    return dict(params, **whole), g


def _own_state(state, ctx: ParallelCtx, di_loc: int, g: int):
    """The rank's block of an SSM state as (B, di_loc / g, g, N): the
    state as it is where it holds the rank's channels (its heads, or
    every head without a split), else the rank's channels of the whole
    state (trap (d)). None stays None."""
    if state is None:
        return None
    Bz, N = state.shape[0], state.shape[-1]
    if state.shape[1] * state.shape[2] != di_loc:
        c0 = ctx.index(ctx.tp_axis) * di_loc
        state = state.reshape(Bz, -1, N)[:, c0:c0 + di_loc]
    return state.reshape(Bz, di_loc // g, g, N)


def _whole_state(state, cfg: ModelConfig, ctx: ParallelCtx):
    """The SSM state a cache holds from the rank's final state (B, Hv, g,
    N): as it is where g = P (its heads, or every head); else (trap (d))
    the ranks' channel blocks gathered over the model axis into the whole
    (B, H, P, N), the same on every rank of the axis."""
    Bz, Hv, g, N = state.shape
    if g == cfg.ssm_head_dim:
        return state
    whole = all_gather(state.reshape(Bz, Hv * g, N), ctx, ctx.tp_axis, 1)
    return whole.reshape(Bz, cfg.ssm_heads, cfg.ssm_head_dim, N)


def _project(params, x, ctx: ParallelCtx = SINGLE):
    dt_, d = x.dtype, x.shape[-1]

    def w(name):        # FSDP: the embed dim gathered after the cast
        return gather_param(params[name].to(dt_), ctx, 0, d)

    xs = torch.einsum("bsd,di->bsi", x, w("w_in_x"))
    z = torch.einsum("bsd,di->bsi", x, w("w_in_z"))
    Bm = torch.einsum("bsd,dn->bsn", x, w("w_in_B"))
    Cm = torch.einsum("bsd,dn->bsn", x, w("w_in_C"))
    dt = torch.einsum("bsd,dh->bsh", x, w("w_in_dt"))
    return xs, z, Bm, Cm, dt


def _conv_all(params, xs, Bm, Cm, tails, conv, ctx: ParallelCtx):
    """The causal conv (`conv(x, w, tail)`: the block's or the decode
    step's) of x, B and C against their tails (None: zeros). x's channels
    and `conv_x` are the rank's. B and C are convolved whole where their
    tails are whole (or absent); where a tail holds the rank's channel
    block, the rank convolves that block and the post-conv B and C are
    gathered over the model axis in one call (trap (c)). Returns (x, B,
    C, (tail_x, tail_B, tail_C))."""
    dt = xs.dtype
    xs, tail_x = conv(xs, params["conv_x"].to(dt), tails[0])
    wB, wC = params["conv_B"].to(dt), params["conv_C"].to(dt)
    N = Bm.shape[-1]
    n = tails[1].shape[-1] if tails[1] is not None else N
    if n != N:
        c0 = ctx.index(ctx.tp_axis) * n
        Bm, Cm = Bm[..., c0:c0 + n], Cm[..., c0:c0 + n]
        wB, wC = wB[:, c0:c0 + n], wC[:, c0:c0 + n]
    Bm, tail_B = conv(Bm, wB, tails[1])
    Cm, tail_C = conv(Cm, wC, tails[2])
    if n != N:
        both = all_gather(torch.stack([Bm, Cm]), ctx, ctx.tp_axis,
                          Bm.dim())
        Bm, Cm = both[0], both[1]
    return xs, Bm, Cm, (tail_x, tail_B, tail_C)


def _gated_norm(params, y, z, eps: float, d_inner: int = 0,
                ctx: ParallelCtx = SINGLE):
    # silu(z) is cast to y's dtype BEFORE the product, as the reference
    # does, so bf16 activations round where the reference's round
    g = y * torch.nn.functional.silu(z.float()).to(y.dtype)
    g32 = g.float()
    if not d_inner or g.shape[-1] == d_inner:
        var = torch.mean(g32 * g32, dim=-1, keepdim=True)
    else:
        # the rank holds d_inner / tp channels: the mean is the whole
        # d_inner's (trap (a)); every rank's channels read it, so its
        # cotangent sums over the model axis
        var = enter_region(psum(torch.sum(g32 * g32, dim=-1, keepdim=True),
                                ctx, ctx.tp_axis), ctx,
                           ctx.tp_axis) / d_inner
    return (g32 * torch.rsqrt(var + eps)
            * params["norm_scale"].float()).to(y.dtype)


def _out_proj(params, y, cfg: ModelConfig, ctx: ParallelCtx):
    """`w_out`, row-parallel where it holds the rank's block of `d_inner`
    (trap (b))."""
    out = torch.einsum("bsi,id->bsd", y, gather_param(
        params["w_out"].to(y.dtype), ctx, 1, cfg.d_model))
    if params["w_out"].shape[0] != cfg.d_inner:
        out = psum(out, ctx, ctx.tp_axis)
    return out


def _dt_and_A(params, dt):
    dtp = softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    return dtp, A


def scan_inputs(params, x, tails=(None, None, None),
                ctx: ParallelCtx = SINGLE, conv=_causal_conv):
    """The SSD scan's inputs from the block's input x (B, S, d): the
    projections, the causal conv (`conv`: the prompt pass's, or the
    decode step's `_step_conv`) against `tails` and the SiLU of x, B and
    C, dt through softplus and A. Returns (x (B, S, C_x), z, B (B, S,
    N), C, dt (B, S, H), A (H,), new tails), over a mesh for the rank's
    channels and heads of `params` (`_rank_params`)."""
    xs, z, Bm, Cm, dt = _project(params, x, ctx)
    xs, Bm, Cm, tails = _conv_all(params, xs, Bm, Cm, tails, conv, ctx)
    silu = torch.nn.functional.silu
    dtp, A = _dt_and_A(params, dt)
    return silu(xs), z, silu(Bm), silu(Cm), dtp, A, tails


def ssm_block(params, x, cfg: ModelConfig, return_state: bool = False,
              init_state=None, conv_tail=None, ctx: ParallelCtx = SINGLE):
    """Full-sequence SSD block. x: (B, S, d). With `return_state`, also
    the final SSM state and the conv tails (state, (tail_x, tail_B,
    tail_C)). Over a mesh (module docstring) the state is the rank's
    heads (every head where they do not divide over the model axis, trap
    (d); `init_state` likewise) and `tail_x` its channels; `tail_B` /
    `tail_C` come back whole unless `conv_tail` held the rank's channel
    block of them."""
    if params["w_in_x"].shape[1] != cfg.d_inner:   # d_inner split: TP region
        x = enter_region(x, ctx, ctx.tp_axis)
    params, g = _rank_params(params, cfg, ctx)
    B, S, _ = x.shape
    N = cfg.ssm_state
    xs, z, Bm, Cm, dtp, A, tails = scan_inputs(
        params, x, conv_tail or (None, None, None), ctx)
    di = xs.shape[-1]
    y, state = ssd_ops.ssd(
        xs.reshape(B, S, di // g, g), dtp, A,
        Bm.reshape(B, S, NGROUPS, N), Cm.reshape(B, S, NGROUPS, N),
        params["D"], _own_state(init_state, ctx, di, g),
    )
    y = _gated_norm(params, y.reshape(B, S, di), z, cfg.norm_eps,
                    cfg.d_inner, ctx)
    out = _out_proj(params, y, cfg, ctx)
    if return_state:
        return out, (_whole_state(state, cfg, ctx), tails)
    return out


def ssm_decode_step(params, x, cfg: ModelConfig, state, conv_tail,
                    ctx: ParallelCtx = SINGLE):
    """One-token decode. x (B,1,d); state (B,H,P,N); conv_tail the
    3-tuple of (B, W-1, C) tails. Returns (out (B,1,d), (new_state,
    new_tails)). Over a mesh state and tails are the rank's shards
    (module docstring; the state whole where the heads do not divide
    over the model axis, and the new state whole too) and x holds the
    rows of its slots."""
    params, g = _rank_params(params, cfg, ctx)
    B = x.shape[0]
    N = cfg.ssm_state
    xs, z, Bm, Cm, dtp, A, tails = scan_inputs(params, x, conv_tail, ctx,
                                               _step_conv)
    di = xs.shape[-1]
    y, new_state = ssd_ops.ssd_decode(
        xs[:, 0].reshape(B, di // g, g), dtp[:, 0], A,
        Bm[:, 0].reshape(B, NGROUPS, N), Cm[:, 0].reshape(B, NGROUPS, N),
        params["D"], _own_state(state, ctx, di, g),
    )
    y = _gated_norm(params, y.reshape(B, 1, di), z, cfg.norm_eps,
                    cfg.d_inner, ctx)
    out = _out_proj(params, y, cfg, ctx)
    return out, (_whole_state(new_state, cfg, ctx), tails)


def make_ssm_state(cfg: ModelConfig, batch: int, n_layers: int, *,
                   device=None, ctx: ParallelCtx = SINGLE):
    """Zeroed decode state of `n_layers` SSM layers: the float32 SSM
    state (n_layers, batch, H, P, N) (float32 for recurrence stability)
    and the three conv tails (n_layers, batch, W-1, C) in cfg.dtype. Over
    a mesh, the rank's shard of `runtime.sharding.cache_pspec`: its rows
    of `batch` over the dp axes, its heads and its block of each tail's
    channels over the model axis where they divide (every head where the
    heads do not, trap (d))."""
    H, Pd, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    gn = NGROUPS * N
    cdt = torch_dtype(cfg.dtype)
    W = cfg.conv_width
    tp = ctx.axis_size(ctx.tp_axis)
    r0, r1 = ctx.batch_rows(batch)

    def split(n):
        return n // tp if n % tp == 0 else n

    state = torch.zeros((n_layers, r1 - r0, split(H), Pd, N),
                        dtype=torch.float32, device=device)
    tails = tuple(
        torch.zeros((n_layers, r1 - r0, W - 1, split(c)), dtype=cdt,
                    device=device)
        for c in (cfg.d_inner, gn, gn))
    return state, tails

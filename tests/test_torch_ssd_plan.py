"""The tensor-core SSD body (`csrc/ssd_scan.cu` `ssd_mma_kernel`) checked
on the CPU, because a mis-sized launch or a lost digit shows only on the
card otherwise: its launch plan (`kernels/ssd_scan/ssd_scan.py`
`launch_plan`) and a float32/float64 emulation of its arithmetic against
the reference package's `ssd_pallas` in interpret mode and the exact
scan, on the same seeded inputs.

The emulation follows the kernel block by block: P split into the plan's
blocks of pb columns, chunks of 64 positions with the last one masked
(rows past S zero), the cumsum in float64, the C.B^T scores of bf16
operands summed in float32 per 16-wide step of N, the decayed scores, the
state and (exp(total - cum_j) dt_j x_j) each entering their product as a
bf16 hi + lo pair, the state decayed in place and kept in float32, y
rounded once to bf16.

Gates: every (b, h, p) computed by exactly one block; shared memory
within 227 KB at mamba2-780m's widths and at every shape of
`chip_smoke.py`'s ssd sweep; the emulation's y within atol=2e-2,
rtol=8e-3 (bf16, one rounding) and its final state within atol=rtol=2e-4
(the reference's own tolerance for its kernel against the exact scan) of
both references."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import ref as jref  # noqa: E402
from repro.kernels.ssd_scan.ssd_scan import ssd_pallas  # noqa: E402
from repro_torch.configs import mamba2_780m  # noqa: E402
from repro_torch.kernels.build import N_SM, SMEM_LIMIT  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as tks  # noqa: E402

Y_TOL = dict(atol=2e-2, rtol=8e-3)
STATE_TOL = dict(atol=2e-4, rtol=2e-4)

# chip_smoke.py's ssd sweep: (B, S, H, P, G, N); then its shard shapes
# of a head cut across ranks (mamba2-780m over tp 32 and 64: 3 virtual
# heads of 32 and of 16)
SWEEP = ([(2, 256, 4, 16, 1, 32), (1, 128, 4, 32, 2, 16),
          (2, 128, 8, 16, 1, 64), (1, 192, 2, 8, 1, 8)]
         + [(B, S, 48, 64, 1, 128) for B in (1, 8) for S in (64, 128, 256)]
         + [(1, 100, 48, 64, 1, 128), (2, 128, 48, 64, 2, 128),
            (2, 160, 48, 64, 1, 128)]
         + [(1, 128, 3, 32, 1, 128), (1, 128, 3, 16, 1, 128)])


# ------------------------------------------------------------ the plan
@pytest.mark.parametrize("B,S,H,P,G,N", SWEEP)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_covers_every_column_once_and_fits(B, S, H, P, G, N, dtype):
    """Each plan the wrapper can take (the default, every pb, one and two
    stages) tiles P with its blocks exactly once per (b, h), and its
    shared memory fits the card; bf16 takes the tensor-core body at N <=
    128, float32 the FMA body."""
    plan = tks.launch_plan(B, H, P, N, dtype)
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.body == ("mma" if dtype == torch.bfloat16 else "fma")
    if plan.body == "fma":
        assert plan.grid == (H, B) and plan.pb == 0
        assert plan.smem_bytes == tks.fma_smem(P, N)
        return
    assert plan.stages == 2          # two chunk buffers fit at every shape
    options = [plan] + [tks.launch_plan(B, H, P, N, dtype, pb, st)
                        for pb in tks.MMA_PB for st in (1, 2)]
    for pl in options:
        nb, gh, gb = pl.grid
        assert (gh, gb) == (H, B) and pl.threads == 256
        cover = np.zeros(P, np.int64)
        for j in range(nb):
            cover[j * pl.pb:min(P, j * pl.pb + pl.pb)] += 1
        assert (cover == 1).all() and (nb - 1) * pl.pb < P
        assert pl.smem_bytes == tks.mma_smem(pl.pb, N, pl.stages)
        assert pl.smem_bytes % 16 == 0 and pl.smem_bytes <= SMEM_LIMIT


def test_plan_fills_the_card_and_does_not_over_split():
    """At mamba2-780m's widths (48 heads of 64, state 128) batch 1 splits
    P into four blocks of 16 (192 blocks on 132 SMs), batch 8 keeps P
    whole (384 blocks); a head dim of 8 is not split past 16 columns;
    float32 and bf16 with N > 128 take the FMA body."""
    cfg = mamba2_780m.CONFIG
    assert (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state) == (48, 64, 128)
    one = tks.launch_plan(1, 48, 64, 128, torch.bfloat16)
    assert one.pb == 16 and one.grid == (4, 48, 1)
    assert one.grid[0] * 48 >= N_SM and one.smem_bytes <= SMEM_LIMIT
    eight = tks.launch_plan(8, 48, 64, 128, torch.bfloat16)
    assert eight.pb == 64 and eight.grid == (1, 48, 8)
    assert tks.launch_plan(1, 2, 8, 8, torch.bfloat16).pb == 16
    assert tks.launch_plan(1, 48, 64, 256, torch.bfloat16).body == "fma"
    assert tks.launch_plan(1, 48, 64, 128, torch.float32).body == "fma"
    with pytest.raises(ValueError):
        tks.launch_plan(1, 48, 64, 128, torch.bfloat16, pb=48)


# ------------------------------------------------------ the emulation
def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def _split(t):
    hi = _bf16(t)
    return hi, _bf16(t - hi)


def _mma(a, b, eq):
    """float32 accumulation of a product over its last operand axis in
    16-wide steps, each step's products summed exactly (float64), as a
    chain of m16n8k16 mma.sync on float32 accumulators."""
    k = a.shape[-1]
    out = None
    for k0 in range(0, k, 16):
        part = torch.einsum(eq, a[..., k0:k0 + 16].double(),
                            b[..., k0:k0 + 16].double()).float()
        out = part if out is None else out + part
    return out


def _emulate(x, dt, A, Bm, Cm, D, h0, pb):
    """The tensor-core body on float32 tensors holding bf16 values (x, B,
    C), per block of pb columns of P. Returns (y rounded to bf16 as
    float32, final state float32) and the count of blocks that wrote
    each (b, h, p)."""
    Bz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = tks.Q
    rep = H // G
    Bh = torch.repeat_interleave(Bm, rep, dim=2)           # (B,S,H,N)
    Ch = torch.repeat_interleave(Cm, rep, dim=2)
    y = torch.full((Bz, S, H, P), float("nan"))
    hT = torch.full((Bz, H, P, N), float("nan"))
    written = torch.zeros(P, dtype=torch.int64)
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    for p0 in range(0, P, pb):
        p1 = min(P, p0 + pb)
        written[p0:p1] += 1
        st = (torch.zeros(Bz, H, p1 - p0, N) if h0 is None
              else h0[:, :, p0:p1].clone())
        for c0 in range(0, S, Q):
            L = min(Q, S - c0)

            def chunk(t):                        # (B,L,...) -> (B,Q,...)
                z = torch.zeros((Bz, Q) + tuple(t.shape[2:]))
                z[:, :L] = t[:, c0:c0 + L]
                return z

            xs = chunk(x[..., p0:p1]).permute(0, 2, 1, 3)  # (B,H,Q,pb)
            bs = chunk(Bh).permute(0, 2, 1, 3)              # (B,H,Q,N)
            cs = chunk(Ch).permute(0, 2, 1, 3)
            dts = chunk(dt).permute(0, 2, 1)                # (B,H,Q)
            a = (A[None, :, None] * dts).double()   # f32 product, f64 sum
            cum = torch.cumsum(a, dim=-1)
            total = cum[..., -1:]
            w = torch.exp((total - cum).float()) * dts
            sc = _mma(cs, bs, "bhin,bhjn->bhij")
            decay = torch.exp((cum[..., :, None] - cum[..., None, :]).float())
            s = torch.where(tri, sc * decay * dts[..., None, :],
                            torch.zeros(()))
            sh, sl = _split(s)
            th, tl = _split(st)
            inter = (_mma(cs, th, "bhin,bhpn->bhip")
                     + _mma(cs, tl, "bhin,bhpn->bhip"))
            yv = torch.exp(cum.float())[..., None] * inter
            yv = (yv + _mma(sh, xs.transpose(-1, -2), "bhij,bhpj->bhip")
                  + _mma(sl, xs.transpose(-1, -2), "bhij,bhpj->bhip"))
            if D is not None:
                yv = yv + D[None, :, None, None] * xs
            y[:, c0:c0 + L, :, p0:p1] = _bf16(yv[:, :, :L]).permute(
                0, 2, 1, 3)
            st = st * torch.exp(total.float())[..., None]
            wh, wl = _split(w[..., None] * xs)              # (B,H,Q,pb)
            st = (st + _mma(wh.transpose(-1, -2), bs.transpose(-1, -2),
                            "bhpj,bhnj->bhpn")
                  + _mma(wl.transpose(-1, -2), bs.transpose(-1, -2),
                         "bhpj,bhnj->bhpn"))
        hT[:, :, p0:p1] = st
    return y, hT, written


def _inputs(B, S, H, P, G, N, seed, init=False, with_D=True):
    """The reference test's draws from numpy, with x, B and C rounded to
    bf16 (the tensor-core body's operand type)."""
    rng = np.random.default_rng(seed)
    f = np.float32

    def bf(a):
        return _bf16(torch.from_numpy(a.astype(f))).numpy()

    x = bf(rng.standard_normal((B, S, H, P)))
    dt = np.logaddexp(rng.standard_normal((B, S, H)), 0).astype(f)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(f)
    Bm = bf(rng.standard_normal((B, S, G, N)))
    Cm = bf(rng.standard_normal((B, S, G, N)))
    D = rng.standard_normal(H).astype(f) if with_D else None
    h0 = ((rng.standard_normal((B, H, P, N)) * 0.1).astype(f) if init
          else None)
    return x, dt, A, Bm, Cm, D, h0


def _close(out, ref, tol):
    ref = ref.to(out.dtype)
    assert torch.isfinite(out).all()
    assert bool(((out - ref).abs() <= tol["atol"]
                 + tol["rtol"] * ref.abs()).all()), float(
        (out - ref).abs().max())


@pytest.mark.parametrize(
    "B,S,H,P,G,N,kw",
    [
        (1, 128, 2, 64, 1, 128, {}),              # mamba2's head, pb 16
        (2, 100, 4, 32, 2, 16, {}),               # ragged S, G = 2
        (1, 192, 2, 8, 1, 8, dict(with_D=False)),  # P, N under a tile
        (2, 160, 2, 64, 1, 128, dict(init=True)),  # initial state
    ],
)
def test_emulation_matches_pallas_and_exact_scan(B, S, H, P, G, N, kw):
    """The emulated tensor-core body against `ssd_pallas(...,
    interpret=True)` and the exact sequential scan, on the same inputs,
    for the default plan and every other pb: y within the bf16 gate,
    the final state within 2e-4, every column written by one block."""
    arrs = _inputs(B, S, H, P, G, N, seed=B * 1000 + S + P + N, **kw)
    x, dt, A, Bm, Cm, D, h0 = arrs
    jx = [None if a is None else jnp.asarray(a) for a in arrs]
    yp, hp = ssd_pallas(*jx[:5], D=jx[5], init_state=jx[6], chunk=64,
                        interpret=True)
    ys, hs = jref.ssd(*jx[:5], D=jx[5], init_state=jx[6])
    t = [None if a is None else torch.from_numpy(a) for a in arrs]
    default = tks.launch_plan(B, H, P, N, torch.bfloat16).pb
    for pb in sorted({default, *[w for w in tks.MMA_PB if w <= max(16, P)]}):
        y, h, written = _emulate(*t, pb=pb)
        assert (written == 1).all()
        for yr, hr in ((yp, hp), (ys, hs)):
            _close(y, torch.from_numpy(np.asarray(yr)), Y_TOL)
            _close(h, torch.from_numpy(np.asarray(hr)), STATE_TOL)

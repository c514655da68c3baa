"""The port's attention and SSD backward against the reference's.

* The plain flash backward (`chunked._bwd_inner`, reached through the
  autograd of the port's `mha_chunked`) against `jax.grad` of the
  reference's `chunked.mha_chunked` at the same blocks and of
  `flash_mha(..., interpret=True)` (Pallas forward, chunked backward):
  causal on the triangular walk, causal rectangular with kv_offset,
  non-causal, GQA, D 20, S not a multiple of the block. dq/dk/dv within
  1e-4 (atol and rtol), as `tests/test_kernels.py` holds the reference's
  grads: float32, sums in another order.
* The CUDA backward's float32 tile walk (`csrc/flash_attention_bwd.cu`'s
  FMA bodies: the dq kernel's key range, the dk/dv kernel's first query
  tile, the masks, 16-row query and 32-key tiles, GQA heads summed per
  key tile) emulated in numpy float64 against the plain backward (1e-5:
  the emulation is exact arithmetic, the plain version float32).
* The bf16 tensor-core walk (`flash_bwd_dq_mma_kernel`,
  `flash_bwd_dkv_mma_kernel`) over `bwd_plan`'s rows and tiles: every
  unmasked (row, key) pair visited once by each pass at D 8-256 and
  rep 1, 3, 8, and a numpy emulation (bf16
  operands, P and dS as bf16 hi + lo pairs) against the plain backward
  on the same bf16 values (2e-5 of each grad's largest).
* The two autograd rules of the kernel paths (`ops._FlashMha`,
  `ssd_scan.ops._SsdScan`) with their CUDA calls replaced by the plain
  versions, so the saved tensors, the lse layout and the grads' routing
  are checked here; the kernels themselves run only on the card
  (`chip_smoke.py --phases device,build,train`).
* The SSD op's plain branch (autograd through `ref` / `chunked`) against
  `jax.grad` of the reference's `ssd_chunked_jnp`: grads of x, dt, A, B,
  C, D and init_state within 1e-4; and, where a chunk's decay passes
  float32's range, the port's chunked backward finite and equal to the
  exact scan's, where the reference's is NaN.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import chunked as jchunked  # noqa: E402
from repro.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_mha as jflash_mha)
from repro.kernels.ssd_scan.chunked import ssd_chunked_jnp  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.flash_attention import chunked as tchunked  # noqa
from repro_torch.kernels.flash_attention import flash_attention as tfa  # noqa
from repro_torch.kernels.flash_attention import ops as tops  # noqa: E402
from repro_torch.kernels.ssd_scan import chunked as tssd_chunked  # noqa
from repro_torch.kernels.ssd_scan import ops as tssd_ops  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)

# (B, Sq, Skv, H, KV, D, causal, kv_offset, block_q, block_k)
CASES = {
    "causal_triangular": (2, 64, 64, 4, 2, 16, True, 0, 16, 16),
    "causal_rect_offset": (1, 32, 64, 4, 2, 16, True, 32, 16, 16),
    "noncausal": (2, 48, 40, 2, 2, 16, False, 0, 16, 8),
    "gqa_rep8": (1, 32, 32, 8, 1, 16, True, 0, 16, 16),
    "head_dim_20": (1, 64, 64, 3, 1, 20, True, 0, 16, 16),
    "seq_100_block_512": (1, 100, 100, 2, 1, 20, True, 0, 512, 512),
    "seq_100_block_32": (1, 100, 100, 2, 1, 16, True, 0, 32, 32),
}
PALLAS = ["causal_triangular", "causal_rect_offset", "gqa_rep8",
          "head_dim_20"]


def _inputs(case, seed=0):
    B, Sq, Skv, H, KV, D = CASES[case][:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            [(B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D),
             (B, Sq, H, D)]]


def _port_grads(case, q, k, v, do):
    causal, off, bq, bk = CASES[case][6:]
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = tchunked.mha_chunked(*ts, causal, None, off, bq, bk)
    return [g.numpy() for g in torch.autograd.grad(out, ts,
                                                   torch.tensor(do))]


def _jax_grads(fn, q, k, v, do):
    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_jax_chunked(case):
    causal, off, bq, bk = CASES[case][6:]
    q, k, v, do = _inputs(case)
    want = _jax_grads(lambda *a: jchunked.mha_chunked(
        *a, causal, None, off, bq, bk), q, k, v, do)
    for got, ref, name in zip(_port_grads(case, q, k, v, do), want,
                              ("dq", "dk", "dv")):
        np.testing.assert_allclose(got, ref, err_msg=name, **TOL)


@pytest.mark.parametrize("case", PALLAS)
def test_plain_backward_matches_jax_flash_interpret(case):
    causal, off, bq, bk = CASES[case][6:]
    q, k, v, do = _inputs(case, seed=1)
    want = _jax_grads(lambda *a: jflash_mha(
        *a, causal, None, off, bq, bk, True), q, k, v, do)
    for got, ref, name in zip(_port_grads(case, q, k, v, do), want,
                              ("dq", "dk", "dv")):
        np.testing.assert_allclose(got, ref, err_msg=name, **TOL)


# ------------------------- the CUDA kernels' float32 walk, emulated
BQ, BK = 16, 32       # csrc/flash_attention_bwd.cu kBQ, kBK


def _emulate_cuda_bwd(q, k, v, out, lse, do, causal, off):
    """float64 numpy walk of the three float32 kernels: delta per row;
    dq per 16-row query tile over its key tiles up to the causal
    frontier; dk/dv per 32-key tile over the group's heads and the query
    tiles from the first that sees its first key. lse (B, H, Sq)."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    rep = H // KV
    sc = D ** -0.5
    q, k, v, out, do, lse = (x.astype(np.float64)
                             for x in (q, k, v, out, do, lse))
    delta = np.einsum("bshd,bshd->bhs", do, out)
    dq = np.zeros_like(q)
    dk = np.zeros_like(k)
    dv = np.zeros_like(v)

    def tile(b, h, q0, k0):
        """p, ds (16, 32) of rows q0.. and keys k0.. (zero where masked
        or past the ends)."""
        g = h // rep
        qi = q0 + np.arange(BQ)[:, None]
        kj = k0 + np.arange(BK)[None, :]
        live = (qi < Sq) & (kj < Skv)
        if causal:
            live &= kj <= off + qi
        qc, kc = np.minimum(qi, Sq - 1), np.minimum(kj, Skv - 1)
        s = np.einsum("ijd,ijd->ij", q[b, qc, h], k[b, kc, g]) * sc
        dp = np.einsum("ijd,ijd->ij", do[b, qc, h], v[b, kc, g])
        p = np.where(live, np.exp(s - lse[b, h, qc]), 0.0)
        ds = p * (dp - delta[b, h, qc]) * sc
        return p, ds, live

    for b in range(B):
        for h in range(H):
            for q0 in range(0, Sq, BQ):
                q_last = min(q0 + BQ, Sq) - 1
                k_end = max(0, min(Skv, off + q_last + 1)) if causal else Skv
                for k0 in range(0, k_end, BK):
                    _, ds, live = tile(b, h, q0, k0)
                    ds = np.where(live & (k0 + np.arange(BK) < k_end), ds,
                                  0.0)
                    kk = k[b, np.minimum(k0 + np.arange(BK), Skv - 1),
                           h // rep]
                    n = min(BQ, Sq - q0)
                    dq[b, q0:q0 + n, h] += (ds @ kk)[:n]
        for g in range(KV):
            for k0 in range(0, Skv, BK):
                q_start = max(0, k0 - off) // BQ * BQ if causal else 0
                m = min(BK, Skv - k0)
                for h in range(g * rep, (g + 1) * rep):
                    for q0 in range(q_start, Sq, BQ):
                        p, ds, _ = tile(b, h, q0, k0)
                        rows = np.minimum(q0 + np.arange(BQ), Sq - 1)
                        valid = (q0 + np.arange(BQ) < Sq)[:, None]
                        dv[b, k0:k0 + m, g] += (
                            (p * valid).T @ do[b, rows, h])[:m]
                        dk[b, k0:k0 + m, g] += (
                            (ds * valid).T @ q[b, rows, h])[:m]
    return dq, dk, dv


@pytest.mark.parametrize("shape", [
    (1, 40, 40, 6, 2, 20, True, 0),     # ragged tiles, GQA
    (2, 33, 70, 4, 4, 16, True, 37),    # kv_offset, a q tile past keys
    (1, 50, 19, 2, 1, 8, False, 0),     # non-causal, Skv < one key tile
    (1, 70, 70, 3, 3, 24, True, 0),     # causal square, three key tiles
])
def test_cuda_walk_emulation_matches_plain_backward(shape):
    B, Sq, Skv, H, KV, D, causal, off = shape
    rng = np.random.default_rng(3)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in
                   [(B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D),
                    (B, Sq, H, D)])
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    out, lse = tchunked._fwd(tq, tk, tv, causal, None, off, 512, 512)
    want = tchunked._bwd_inner(causal, None, off, 512, 512,
                               (tq, tk, tv, out, lse), torch.tensor(do))
    got = _emulate_cuda_bwd(q, k, v, out.numpy(),
                            lse.reshape(B, H, Sq).numpy(), do, causal, off)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, w.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


# --------------------------- the tensor-core (bf16) walk and its plan
def _bwd_dq_visits(plan, Sq, Skv, H, KV, causal, off):
    """The bf16 dq pass's walk (`flash_bwd_dq_mma_kernel`): per block of
    `plan.rows` rows (row = query position * rep + head of the group), the
    64-key tiles up to the block's causal frontier; each warp walks its
    16 rows over the tiles in 32-key halves, less the halves past its own
    last key. Returns the visits (row_lo, row_hi, key_lo, key_hi), clipped
    to the tensors, and per block (first row, tiles loaded, k_end)."""
    rep = H // KV
    n_rows = Sq * rep
    visits, blocks = [], []
    for y in range(plan.dq_grid[1]):
        row0 = (plan.dq_grid[1] - 1 - y) * plan.rows
        q_last = (min(row0 + plan.rows, n_rows) - 1) // rep
        k_end = max(0, min(Skv, off + q_last + 1)) if causal else Skv
        n_tiles = -(-k_end // tfa.BWD_KEY_TILE)
        blocks.append((row0, n_tiles, k_end))
        for rg in range(plan.rows // 16):
            w_row = row0 + 16 * rg
            if w_row >= n_rows:
                continue
            kmax = (off + min(w_row + 15, n_rows - 1) // rep if causal
                    else Skv)
            for t in range(n_tiles):
                for kh in range(tfa.BWD_KEY_TILE // 32):
                    kb = t * tfa.BWD_KEY_TILE + kh * 32
                    if kb > kmax or kb >= k_end:
                        continue
                    visits.append((w_row, min(w_row + 16, n_rows), kb,
                                   min(kb + 32, k_end)))
    return visits, blocks


def _bwd_dkv_visits(plan, Sq, Skv, H, KV, D, causal, off):
    """The bf16 dk/dv pass's walk (`flash_bwd_dkv_mma_kernel`): per block
    of `plan.keys` (16) keys, the 64-row tiles from the first that holds a
    row seeing the block's first key; a warp (row group, column group)
    takes the tiles' 16-row chunks rc with rc % row_groups equal to its
    row group, less those whose last query sees none of the block's keys,
    over its share of dk/dv's 16-column tiles. Returns the visits
    (key_lo, key_hi, row_lo, row_hi, column tiles), clipped, and per block
    (first key, first row tile)."""
    rep = H // KV
    n_rows = Sq * rep
    kd = -(-D // 16)
    dmax16 = next(m for m in (2, 4, 8, 16) if kd <= m)   # DMAX / 16
    n_rg = plan.row_groups
    n_ct = -(-dmax16 // plan.col_groups)
    warps = 4
    assert plan.keys == 16 and n_rg * plan.col_groups == warps
    visits, blocks = [], []
    t_hi = -(-n_rows // tfa.BWD_ROW_TILE)
    for y in range(plan.dkv_grid[1]):
        k0 = y * plan.keys
        row_start = min(Sq, max(0, k0 - off)) * rep if causal else 0
        t_lo = row_start // tfa.BWD_ROW_TILE
        blocks.append((k0, t_lo))
        for w in range(warps):
            rg, dg = w % n_rg, w // n_rg
            kw0 = k0
            cts = [c for c in range(dg * n_ct, dg * n_ct + n_ct) if c < kd]
            for t in range(t_lo, t_hi):
                for rc in range(rg, tfa.BWD_ROW_TILE // 16, n_rg):
                    c_row = t * tfa.BWD_ROW_TILE + 16 * rc
                    if (kw0 >= Skv or c_row >= n_rows or (
                            causal and off + min(c_row + 15, n_rows - 1)
                            // rep < kw0)):
                        continue
                    visits.append((kw0, min(kw0 + 16, Skv), c_row,
                                   min(c_row + 16, n_rows), cts))
    return visits, blocks


def _live(rows, keys, rep, causal, off):
    """(rows, keys) bool: the key is unmasked for the row's query."""
    return (keys[None, :] <= off + rows[:, None] // rep) if causal else \
        np.ones((len(rows), len(keys)), bool)


def _bf16(x):
    """Round float32 to bfloat16 (to nearest even), kept as float32."""
    return torch.tensor(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _split(x):
    """x as the kernels pass it to a product: a bf16 hi + lo pair."""
    hi = _bf16(x)
    return hi.astype(np.float64) + _bf16(x - hi)


def _emulate_mma_bwd(q, k, v, out, lse, do, causal, off):
    """float64 numpy walk of the bf16 tensor-core passes over the rows
    (query, head of the group) and tile sizes of `bwd_plan`: S and dP of
    bf16 operands, P = exp(S scale - lse), dS = P (dP - delta) scale,
    and P, dS entering dq, dk, dv as bf16 hi + lo pairs. q, k, v, out, do
    hold bf16 values; lse (B, H, Sq)."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    rep = H // KV
    sc = D ** -0.5
    plan = tfa.bwd_plan(B, Sq, Skv, H, KV, D, torch.bfloat16)
    q, k, v, out, do, lse = (x.astype(np.float64)
                             for x in (q, k, v, out, do, lse))
    delta = np.einsum("bshd,bshd->bhs", do, out)
    # row-layout views: (B, KV, Sq * rep, D) and (B, KV, Sq * rep)
    rows = lambda x: x.reshape(B, Sq, KV, rep, -1).transpose(  # noqa
        0, 2, 1, 3, 4).reshape(B, KV, Sq * rep, -1)
    qr, dor = rows(q), rows(do)
    lser = rows(lse.transpose(0, 2, 1)[..., None])[..., 0]
    delr = rows(delta.transpose(0, 2, 1)[..., None])[..., 0]
    kg_, vg = k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)

    def p_ds(b, g, r0, r1, k0, k1):
        r, j = np.arange(r0, r1), np.arange(k0, k1)
        s = qr[b, g, r0:r1] @ kg_[b, g, k0:k1].T
        dp = dor[b, g, r0:r1] @ vg[b, g, k0:k1].T
        live = _live(r, j, rep, causal, off)
        p = np.where(live, np.exp(s * sc - lser[b, g, r0:r1, None]), 0.0)
        return p, p * (dp - delr[b, g, r0:r1, None]) * sc

    dq = np.zeros_like(qr)
    dk = np.zeros_like(kg_)
    dv = np.zeros_like(vg)
    dq_visits, _ = _bwd_dq_visits(plan, Sq, Skv, H, KV, causal, off)
    dkv_visits, _ = _bwd_dkv_visits(plan, Sq, Skv, H, KV, D, causal, off)
    for b in range(B):
        for g in range(KV):
            for r0, r1, k0, k1 in dq_visits:
                _, ds = p_ds(b, g, r0, r1, k0, k1)
                dq[b, g, r0:r1] += _split(ds) @ kg_[b, g, k0:k1]
            for k0, k1, r0, r1, cts in dkv_visits:
                p, ds = p_ds(b, g, r0, r1, k0, k1)
                for c in cts:
                    cols = slice(16 * c, 16 * c + 16)
                    dv[b, g, k0:k1, cols] += _split(p).T @ dor[b, g, r0:r1,
                                                                cols]
                    dk[b, g, k0:k1, cols] += _split(ds).T @ qr[b, g, r0:r1,
                                                               cols]
    dq = dq.reshape(B, KV, Sq, rep, D).transpose(0, 2, 1, 3, 4).reshape(
        B, Sq, H, D)
    return dq, dk.transpose(0, 2, 1, 3), dv.transpose(0, 2, 1, 3)


MMA_SHAPES = [
    (1, 40, 40, 6, 2, 20, True, 0),     # ragged tiles, GQA
    (2, 33, 70, 4, 4, 16, True, 37),    # kv_offset, a q tile past keys
    (1, 50, 19, 2, 1, 8, False, 0),     # non-causal, Skv < one key tile
    (1, 70, 70, 3, 3, 24, True, 0),     # causal square, three key tiles
    (1, 96, 96, 6, 2, 64, True, 0),     # GQA rep 3 at D 64
    (1, 40, 72, 2, 1, 256, True, 32),   # D 256: 2 column groups
]


@pytest.mark.parametrize("shape", MMA_SHAPES)
def test_mma_walk_emulation_matches_plain_backward(shape):
    """The bf16 walk (exact products of bf16 operands, P and dS as bf16
    hi + lo pairs) against the plain backward on the same bf16 values in
    float32: within 2e-5 of each grad's largest magnitude (the walk reads
    2e-6 to 5e-6: a hi + lo pair keeps P and dS to about 2^-17 of their
    size). A single bf16 (2^-9) misses by more than 50 times the
    tolerance (checked below), as would a skipped or repeated tile."""
    B, Sq, Skv, H, KV, D, causal, off = shape
    rng = np.random.default_rng(4)
    q, k, v, do = (_bf16(rng.standard_normal(s)) for s in
                   [(B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D),
                    (B, Sq, H, D)])
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    out, lse = tchunked._fwd(tq, tk, tv, causal, None, off, 512, 512)
    out = torch.tensor(_bf16(out.numpy()))     # the forward's bf16 output
    want = tchunked._bwd_inner(causal, None, off, 512, 512,
                               (tq, tk, tv, out, lse), torch.tensor(do))
    lse3 = lse.reshape(B, H, Sq).numpy()
    got = _emulate_mma_bwd(q, k, v, out.numpy(), lse3, do, causal, off)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        w = w.numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-5 * np.abs(w).max(),
                                   err_msg=name)
    if shape == MMA_SHAPES[4]:
        # the same walk with P and dS in one bf16 each fails the gate
        global _split
        keep = _split
        try:
            _split = _bf16
            one = _emulate_mma_bwd(q, k, v, out.numpy(), lse3, do, causal,
                                   off)
        finally:
            _split = keep
        worst = max(np.abs(g - w.numpy()).max() / np.abs(w.numpy()).max()
                    for g, w in zip(one, want))
        assert worst > 1e-3, worst


@pytest.mark.parametrize("rep", [1, 3, 8])
@pytest.mark.parametrize("D", [8, 16, 20, 64, 80, 128, 144, 256])
def test_mma_bwd_plan_covers_every_pair_once(D, rep):
    """Each bf16 pass's walk over the plan at this D (64 rows per dq
    block, 16 keys per dk/dv block) visits every unmasked (row, key) pair
    exactly once (dk/dv: once per 16-column tile of D), loads no K/V tile
    past a dq block's causal frontier and starts each dk/dv block at the
    row tile holding the first row that sees its first key; both passes'
    shared memory fits, and one row group's partial sums at a time fit
    the tile ring they merge through."""
    B, KV = 2, 2
    H = KV * rep
    dp = -(-D // 16) * 16
    kd = dp // 16
    dmax = next(m for m in (32, 64, 128, 256) if dp <= m)
    qp = 2 * (dp + 8)
    for Sq, Skv, causal, off in ((100, 100, True, 0), (37, 77, True, 40),
                                 (50, 19, False, 0), (64, 64, True, 0)):
        n_rows = Sq * rep
        rows, keys = np.arange(n_rows), np.arange(Skv)
        live = _live(rows, keys, rep, causal, off)
        plan = tfa.bwd_plan(B, Sq, Skv, H, KV, D, torch.bfloat16)
        assert (plan.rows, plan.keys) == (64, 16)
        assert max(plan.dq_smem, plan.dkv_smem) <= tfa.SMEM_LIMIT
        assert plan.dq_grid == (B * KV, -(-n_rows // 64))
        assert plan.dkv_grid == (B * KV, -(-Skv // 16))
        # one merge step: dk + dv of 16 keys x the column share of each
        # column group (4-byte floats)
        w = min(-(-(dmax // 16) // plan.col_groups), kd)
        assert plan.col_groups * 16 * w * 32 * 4 <= 2 * 2 * 64 * qp
        seen = np.zeros((n_rows, Skv), int)
        visits, blocks = _bwd_dq_visits(plan, Sq, Skv, H, KV, causal, off)
        for r0, r1, k0, k1 in visits:
            seen[r0:r1, k0:k1] += live[r0:r1, k0:k1]
        assert (seen == live).all()
        for row0, n_tiles, k_end in blocks:
            assert n_tiles * 64 - 64 < k_end or n_tiles == 0
        seen = np.zeros((n_rows, Skv, kd), int)
        visits, blocks = _bwd_dkv_visits(plan, Sq, Skv, H, KV, D, causal,
                                         off)
        for k0, k1, r0, r1, cts in visits:
            for c in cts:
                seen[r0:r1, k0:k1, c] += live[r0:r1, k0:k1]
        assert (seen == live[..., None]).all()
        for k0, t_lo in blocks:
            if t_lo > 0:    # the tiles before hold no row seeing k0
                assert not live[:t_lo * 64, k0].any()
                assert live[t_lo * 64:, k0].any()


# ------------------------------------------- the kernel paths' rules
def test_flash_autograd_rule_routes_the_kernel_calls(monkeypatch):
    """`ops._FlashMha` with `flash_mha_cuda` / `flash_mha_bwd_cuda`
    replaced by the plain forward and backward (lse as the kernel lays it
    out, (B, H, Sq)): grads equal the plain path's, the backward gets the
    forward's saved (q, k, v, out, lse) and arguments, and nothing is
    saved without a grad."""
    calls = []

    def fwd(q, k, v, *, causal, scale, kv_offset):
        out, lse = tchunked._fwd(q, k, v, causal, scale, kv_offset, 16, 16)
        calls.append("fwd")
        return out, lse.reshape(q.shape[0], q.shape[2], q.shape[1])

    def bwd(q, k, v, out, lse, dout, *, causal, scale, kv_offset):
        B, Sq, H, _ = q.shape
        calls.append(("bwd", causal, kv_offset, tuple(lse.shape)))
        return tchunked._bwd_inner(causal, scale, kv_offset, 16, 16,
                                   (q, k, v, out, lse.reshape(
                                       B, k.shape[2], H // k.shape[2], Sq)),
                                   dout)

    monkeypatch.setattr(tfa, "flash_mha_cuda", fwd)
    monkeypatch.setattr(tfa, "flash_mha_bwd_cuda", bwd)
    q, k, v, do = _inputs("causal_rect_offset")
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = tops._FlashMha.apply(*ts, True, None, 32)
    got = torch.autograd.grad(out, ts, torch.tensor(do))
    assert calls == ["fwd", ("bwd", True, 32, (1, 4, 32))]
    want = _port_grads("causal_rect_offset", q, k, v, do)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        out = tops._FlashMha.apply(*ts, True, None, 32)
    assert not out.requires_grad and calls[-1] == "fwd"


def test_plain_attention_backward_is_counted():
    """The plain path's backward counts one `REFERENCE_CALLS["mha_bwd"]`
    per call (both the full-score and the chunked version); the forward
    alone counts none."""
    kernels.reset_counters()
    for S in (16, 300):
        q = torch.randn(1, S, 2, 8, requires_grad=True)
        k = torch.randn(1, S, 1, 8)
        out = tops.mha(q, k, k)
        out.sum().backward()
    assert kernels.REFERENCE_CALLS["mha"] == 2
    assert kernels.REFERENCE_CALLS["mha_bwd"] == 2
    with torch.no_grad():
        tops.mha(q, k, k)
    assert kernels.REFERENCE_CALLS["mha_bwd"] == 2
    kernels.reset_counters()


# ----------------------------------------------------------------- SSD
def _ssd_inputs(B=2, S=96, H=4, P=8, G=2, N=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (B, S, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (H,)).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    D = rng.standard_normal((H,)).astype(np.float32)
    h0 = rng.standard_normal((B, H, P, N)).astype(np.float32) * 0.1
    dy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dh = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return [x, dt, A, Bm, Cm, D, h0], (dy, dh)


SSD_NAMES = ("x", "dt", "A", "B", "C", "D", "init_state")


@pytest.mark.parametrize("S,chunk", [(96, 32), (40, 128)])
def test_ssd_plain_backward_matches_jax(S, chunk):
    """The op's plain branch (S <= 64: the exact scan; above: chunked)
    against the vjp of the reference's chunked jnp version."""
    ins, (dy, dh) = _ssd_inputs(S=S)
    _, vjp = jax.vjp(lambda *a: ssd_chunked_jnp(*a, chunk),
                     *map(jnp.asarray, ins))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    ts = [torch.tensor(x, requires_grad=True) for x in ins]
    y, h = tssd_ops.ssd(*ts, chunk=chunk)
    got = torch.autograd.grad((y, h), ts, (torch.tensor(dy),
                                           torch.tensor(dh)))
    for g, w, name in zip(got, want, SSD_NAMES):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("with_opt", [True, False])
def test_ssd_autograd_rule_is_the_chunked_vjp(monkeypatch, with_opt):
    """`_SsdScan` with `ssd_cuda` replaced by the exact scan: its backward
    is the vjp of `chunked.ssd_chunked` recomputed from the saved inputs,
    D and init_state optional, grads only for the inputs that need
    them."""
    from repro_torch.kernels.ssd_scan import ref as tssd_ref
    from repro_torch.kernels.ssd_scan import ssd_scan as tks

    monkeypatch.setattr(tks, "ssd_cuda", lambda x, dt, A, B, C, D, h0:
                        tssd_ref.ssd(x, dt, A, B, C, D, h0))
    ins, (dy, dh) = _ssd_inputs(S=64)
    if not with_opt:
        ins[5] = ins[6] = None
    ts = [torch.tensor(x, requires_grad=i != 2) if x is not None else None
          for i, x in enumerate(ins)]
    y, h = tssd_ops._SsdScan.apply(*ts, 32)
    live = [t for t in ts if t is not None and t.requires_grad]
    got = torch.autograd.grad((y, h), live, (torch.tensor(dy),
                                             torch.tensor(dh)))
    ts2 = [t.detach().requires_grad_(t.requires_grad) if t is not None
           else None for t in ts]
    y2, h2 = tssd_chunked.ssd_chunked(*ts2, 32)
    want = torch.autograd.grad(
        (y2, h2), [t for t in ts2 if t is not None and t.requires_grad],
        (torch.tensor(dy), torch.tensor(dh)))
    assert len(got) == (6 if with_opt else 4)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_ssd_backward_stays_finite_where_the_reference_overflows():
    """A chunk long enough that exp(cum_i - cum_j) above the diagonal
    passes float32's range (64 steps of A dt = -1.5): the reference's
    chunked vjp is NaN (it masks after the exp), the port's plain backward
    masks before it and equals the exact scan's grads."""
    ins, (dy, dh) = _ssd_inputs(B=1, S=64, H=2, P=4, G=1, N=4, seed=2)
    ins[1] = np.full_like(ins[1], 1.5)          # dt
    ins[2] = -np.ones_like(ins[2])              # A
    _, vjp = jax.vjp(lambda *a: ssd_chunked_jnp(*a, 64),
                     *map(jnp.asarray, ins))
    jgrads = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    assert not all(bool(jnp.isfinite(g).all()) for g in jgrads)
    from repro_torch.kernels.ssd_scan import ref as tssd_ref

    grads = []
    for fn in (lambda *a: tssd_chunked.ssd_chunked(*a, 64),
               tssd_ref.ssd):
        ts = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
              for x in ins]
        y, h = fn(*ts)
        grads.append(torch.autograd.grad(
            (y, h), ts, (torch.tensor(dy, dtype=torch.float64),
                         torch.tensor(dh, dtype=torch.float64))))
    for g, w, name in zip(*grads, SSD_NAMES):
        assert bool(torch.isfinite(g).all()), name
        torch.testing.assert_close(g, w, rtol=1e-9, atol=1e-9,
                                   msg=name)

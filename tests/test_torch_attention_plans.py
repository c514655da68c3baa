"""Launch plans of the port's attention kernels, checked on the CPU
because a refused or mis-sized launch shows only on the card: the
flash-attention forward's plan (`kernels/flash_attention/flash_attention.py`
`launch_plan`), its backward's defaults (`bwd_plan`; the walks over that
plan are checked in `tests/test_torch_flash_bwd.py`) and the split decode
body's plan and key partition
(`kernels/decode_attention/paged.py` `decode_plan`, `key_spans`), which
the paged and the contiguous decode share. Then a float32 emulation of
the split decode (span partials, merged in span order) against the plain
versions of both decode ops and against the reference package's plain
decode, on the same seeded inputs.

Gates: every (query position, head) row computed by exactly one block,
key splits partitioning each block's key tiles, shared memory within
227 KB; the decode key partition identical for a paged and a dense
capacity at equal lengths (0, 1, the span edges, parked rows); the
emulation within atol=rtol=1e-6 of the plain versions (float32, sums in
another order) and bit-equal to itself for every span count that holds
the used spans; a row of length 0 averaging V as the reference's Pallas
kernels do (interpret mode)."""

from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import ops as jdops  # noqa: E402
from repro.kernels.decode_attention import ref as jdref  # noqa: E402
from repro_torch.kernels.decode_attention import ops as tdops  # noqa: E402
from repro_torch.kernels.decode_attention import paged as dplan  # noqa: E402
from repro_torch.kernels.decode_attention import ref as tdref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention as fa,
)

TOL = dict(atol=1e-6, rtol=1e-6)
# head dim 256: 256-long float32 dot products in another order move the
# softmax's exponents further; the card's float32 gate (chip_smoke F32_TOL)
TOL_WIDE = dict(atol=1e-5, rtol=1e-5)


# ------------------------------------------------------- flash_mha plan
@pytest.mark.parametrize("Sq", [1, 17, 64, 128, 512])
@pytest.mark.parametrize("rep", [1, 3, 8])
@pytest.mark.parametrize("D", [16, 20, 64, 112, 128, 256])
def test_flash_plan_covers_every_row_and_fits(D, rep, Sq):
    """Both bodies' plans (float32 FMA, bf16 tensor-core with the default
    and every (rows, key groups) option at the head dim, split or not)
    fit a block's shared memory and thread limit and the grid's limits;
    every (query position, head) row is computed by exactly one block
    (above D 128 causal blocks run in reverse order); the key splits
    partition each block's causal key tiles (64 keys up to D 128, 32
    above it)."""
    B, KV = 2, 2
    H = KV * rep
    for Skv, causal, off in ((Sq, True, 0), (Sq + 40, True, 40),
                             (Sq + 7, False, 0)):
        plans = [fa.launch_plan(B, Sq, Skv, H, KV, D, torch.float32, causal,
                                off),
                 fa.launch_plan(B, Sq, Skv, H, KV, D, torch.bfloat16, causal,
                                off)]
        plans += [fa._mma_plan(B, Sq, Skv, H, KV, D, causal, off, rows=r,
                               n_split=n, key_groups=kg)
                  for r, kg in fa.mma_options(D) for n in (1, 4)
                  if fa._mma_smem(r, D, kg) <= fa.SMEM_LIMIT]
        for plan in plans:
            assert plan.smem_bytes <= fa.SMEM_LIMIT, plan
            assert plan.threads <= 1024 and plan.threads % 32 == 0
            assert max(plan.grid[1:]) <= 65535 and plan.grid[0] >= 1
            covered = Counter()
            if not plan.tensor_core:
                assert plan.grid == (-(-Sq // 16), H, B)
                for x in range(plan.grid[0]):
                    for qi in range(16 * x, min(16 * x + 16, Sq)):
                        for h in range(H):
                            covered[qi, h] += 1
                assert len(covered) == Sq * H
                assert set(covered.values()) == {1}
                continue
            assert plan.rows in (16, 32, 64)
            if -(-D // 16) * 16 <= 128:
                assert plan.threads == 128 and plan.col_groups == 1
                assert plan.key_groups * plan.rows == 64
                assert plan.key_tile == fa.KEY_TILE
            else:
                assert plan.col_groups == 4 and plan.key_tile == 32
                assert plan.threads == (32 * 4 * plan.rows // 16
                                        * plan.key_groups) <= 256
            assert plan.grid[1] == KV and plan.grid[2] == B * plan.n_split
            n_rows = Sq * rep
            for x in range(plan.grid[0]):
                # the kernel's block index: the longest causal key ranges
                # first above D 128
                bx = (plan.grid[0] - 1 - x if plan.col_groups > 1 and causal
                      else x)
                rows = range(bx * plan.rows, min(bx * plan.rows + plan.rows,
                                                 n_rows))
                for row in rows:
                    covered[divmod(row, rep)] += 1
                # the kernel's split of the block's key tiles
                q_last = rows[-1] // rep
                k_end = (max(0, min(Skv, off + q_last + 1)) if causal
                         else Skv)
                n_tiles = -(-k_end // plan.key_tile)
                tiles = []
                for s in range(plan.n_split):
                    lo = s * n_tiles // plan.n_split
                    hi = (s + 1) * n_tiles // plan.n_split
                    # round r: key group j takes tile lo + r * kp + j
                    kp = plan.key_groups
                    for r in range(-(-(hi - lo) // kp)):
                        tiles += [t for t in range(lo + r * kp,
                                                   lo + r * kp + kp)
                                  if t < hi]
                assert tiles == list(range(n_tiles))
            assert len(covered) == n_rows
            assert set(covered.values()) == {1}


def test_flash_plan_defaults():
    """The default bf16 plan: up to D 128 32 row slots and two key groups
    of 4 warps in all per block, 64-key tiles; above D 128 (D padded to
    16) 16 row slots whose output columns split over 4 warps, two key
    groups of 32-key tiles, 256 threads. At the main shape (B=1,
    Sq=Skv=128, 15/5 heads) 60 blocks whose two key groups take the two
    key tiles, no split across blocks; at paligemma-3b's prefix + prompt
    (S 384, 8/1 heads, D 256) 192 blocks, no split. A split only where
    the blocks are fewer than the SMs and each split keeps both groups
    busy; never more splits than tiles."""
    main = fa.launch_plan(1, 128, 128, 15, 5, 64, torch.bfloat16)
    assert (main.rows, main.key_groups) == (32, 2)
    assert main.grid == (12, 5, 1) and main.n_split == 1
    assert (main.col_groups, main.key_tile, main.threads) == (1, 64, 128)
    for D in (144, 192, 256):
        wide = fa.launch_plan(1, 128, 128, 8, 1, D, torch.bfloat16)
        assert (wide.rows, wide.key_groups, wide.col_groups) == (16, 2, 4)
        assert (wide.key_tile, wide.threads) == (32, 256)
        qp = 2 * (-(-D // 16) * 16 + 8)
        assert wide.smem_bytes == (16 * qp + 2 * 2 * 2 * 32 * qp
                                   + 2 * 4 * 16 * fa.S_PITCH * 4)
    assert fa.launch_plan(1, 128, 128, 8, 1, 128,
                          torch.bfloat16).col_groups == 1
    pali = fa.launch_plan(1, 384, 384, 8, 1, 256, torch.bfloat16)
    assert pali.grid == (192, 1, 1) and pali.n_split == 1
    assert fa.mma_options(256) == [(16, 1), (16, 2), (32, 1)]
    with pytest.raises(ValueError):
        fa._mma_plan(1, 384, 384, 8, 1, 256, rows=64)
    assert fa.launch_plan(8, 512, 512, 15, 5, 64,
                          torch.bfloat16).n_split == 1
    few = fa.launch_plan(1, 512, 512, 3, 1, 64, torch.bfloat16)
    assert few.grid[:2] == (48, 1) and few.n_split == 4
    assert fa._mma_plan(1, 128, 128, 15, 5, 64, n_split=9).n_split == 2


def test_flash_bwd_plan_defaults():
    """The backward's plan: float32 the FMA bodies' fixed geometry (16
    query positions of a head per dq block, 32 keys per dk/dv block, f32
    tiles); bf16 the tensor-core bodies with 64 rows per dq block and 16
    keys in four row groups per dk/dv block (two row groups of two column
    groups above D 128); at smollm-360m's train shape (B 8, S 256, 15/5
    heads, D 64) 480 dq blocks and 640 dk/dv blocks. Every plan fits the
    shared memory and the scratch holds either body's delta."""
    f32 = fa.bwd_plan(8, 256, 256, 15, 5, 64, torch.float32)
    assert (f32.tensor_core, f32.rows, f32.keys) == (False, 16, 32)
    assert f32.dq_grid == (16, 15, 8) and f32.dkv_grid == (8, 5, 8)
    assert f32.dkv_smem == 4 * (2 * 32 * 65 + 2 * 16 * 64 + 2 * 16 * 33
                                + 2 * 16 + 2 * 32 * 64)
    main = fa.bwd_plan(8, 256, 256, 15, 5, 64, torch.bfloat16)
    assert main.tensor_core and main.rows == 64
    assert (main.keys, main.row_groups, main.col_groups) == (16, 4, 1)
    assert main.dq_grid == (40, 12) and main.dkv_grid == (40, 16)
    assert fa.bwd_scratch_floats(8, 256, 15, 5) == 2 * 40 * 768
    assert fa.bwd_scratch_floats(1, 10, 4, 4) == 2 * 4 * 64
    for D, groups in ((16, (4, 1)), (128, (4, 1)), (144, (2, 2)),
                      (256, (2, 2))):
        plan = fa.bwd_plan(2, 384, 384, 8, 1, D, torch.bfloat16)
        assert (plan.row_groups, plan.col_groups) == groups, D
        assert max(plan.dq_smem, plan.dkv_smem) <= fa.SMEM_LIMIT


# ---------------------------------------------------------- decode plan
def _lengths(cap: int, span: int):
    return sorted({0, 1, span - 1, span, span + 1, 2 * span, cap - 1, cap,
                   cap + 7})


@pytest.mark.parametrize("span", [32, 64, 128])
@pytest.mark.parametrize("page", [16, 64])
def test_decode_partition_same_for_paged_and_dense(page, span):
    """The split body's key partition depends on the length, the
    capacity's clamp and the span cap only: a paged capacity (n_pages *
    page) and a dense capacity (S) of the same size give the same spans
    at every length, parked rows and slots past the span cap (longer
    spans) included, and at lengths below both capacities any two
    capacities do. The spans tile [0, min(length, capacity)) in order,
    each inside its own span block, all of one length (a multiple of the
    span) but the last, at most `MAX_SPANS` of them, and the plan's grid
    holds them."""
    max_spans = dplan.MAX_SPANS
    for n_pages in (1, 3, 9, 16, 16384 // page + 1, 4 * 16384 // page + 3):
        cap = n_pages * page
        lengths = _lengths(cap, span) + [
            n for n in (max_spans * span - 1, max_spans * span,
                        max_spans * span + 1, 3 * max_spans * span + 5,
                        16384, 16384 + 1, 4 * 16384 + 7) if n <= cap]
        for length in lengths:
            paged = dplan.key_spans(length, n_pages * page, span)
            dense = dplan.key_spans(length, cap, span)
            assert paged == dense
            n_keys = min(length, cap)
            L = dplan.span_len(n_keys, span)
            assert L % span == 0 and (L == span) == (
                n_keys <= max_spans * span)
            assert paged[0][0] == 0 and paged[-1][1] == n_keys
            assert len(paged) <= max_spans
            assert all(lo == u * L and hi <= lo + L and (
                hi > lo or n_keys == 0)
                for u, (lo, hi) in enumerate(paged))
            assert all(a[1] == b[0] for a, b in zip(paged, paged[1:]))
            for plan_cap in (cap, cap + 4):          # draft caches: S + k
                if length <= cap:
                    assert dplan.key_spans(length, plan_cap, span) == paged
            plan = dplan.decode_plan(8, 24, 3, 64, cap, torch.int8, span)
            assert len(paged) <= plan.n_span == plan.grid[2]
            assert plan.n_span == min(-(-cap // span), max_spans)
            assert plan.grid[:2] == (3, 8)


@pytest.mark.parametrize("span", [32, 64])
def test_decode_partition_unchanged_up_to_the_span_cap(span):
    """Every length up to MAX_SPANS spans keeps the first split body's
    partition, spans of `span` keys from 0 (and so its sums: the body at
    D <= 128 runs each span's keys in the same order); one key past the
    cap, the spans double and their count halves (rounded up)."""
    cap = dplan.MAX_SPANS * span
    for length in range(cap + 1):
        n_used = max(1, -(-length // span))
        assert dplan.key_spans(length, cap + 64, span) == [
            (u * span, min(u * span + span, length)) for u in range(n_used)]
    past = dplan.key_spans(cap + 1, 4 * cap, span)
    assert past[0] == (0, 2 * span) and len(past) == dplan.MAX_SPANS // 2 + 1
    assert dplan.default_span(128) == dplan.SPAN == 64
    assert dplan.default_span(144) == dplan.default_span(256) == 32


@pytest.mark.parametrize("dt", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [16, 20, 64, 112, 128, 256])
def test_decode_plan_smem_layout(D, dt):
    """The plan's shared memory mirrors the kernel's layout, whatever the
    span: a ring of two rounds of K and V rows (64 keys a round, 32 for a
    float32 pool above D 128) at a pitch of an odd number of 16-byte
    chunks (so 32 lanes reading 16 bytes of 32 rows meet every bank
    once), a (scale, zero) row and a cache row per key of the ring, rep
    f32 q rows padded to the staged chunks, the merge's (rescale,
    weight) per (row, span) and (M, L) per row over the ring, and above
    D 128 each warp's scores and (m, l, alpha) of up to 4 rows; (scale,
    zero) rows only for int8 pools. Every plan fits."""
    esize = torch.empty((), dtype=dt).element_size()
    for span in (32, 64, 128, 256):
        for rep in (1, 3, 16):
            plan = dplan.decode_plan(4, 2 * rep, 2, D, 1000, dt, span)
            chunks = -(-D * esize // 16)
            pitch = 16 * (chunks | 1)
            rk = 32 if esize == 4 and D > 128 else 64
            assert (pitch // 16) % 2 == 1 and pitch >= D * esize
            cw = -(-rep * (dplan.MAX_SPANS + 1) * 8 // 16) * 16
            assert plan.smem_bytes == (
                max(2 * 2 * rk * pitch, cw)
                + (2 * rk * 16 if esize == 1 else 0) + 2 * rk * 8
                + rep * chunks * (16 // esize) * 4
                + (4 * 4 * 36 * 4 if D > 128 else 0))
            assert plan.smem_bytes % 16 == 0
            assert plan.smem_bytes <= dplan.SMEM_LIMIT
    with pytest.raises(ValueError):
        dplan.decode_plan(1, 1, 1, D, 64, dt, span=48)


def test_decode_plan_block_warps():
    """A block's warps: 4 up to rep 4 and above D 128, else 5 (qwen2.5-32b's
    40 / 8 heads at D 128: one warp a query row); the plan's threads say
    so."""
    for D, rep, warps in ((64, 3, 4), (64, 4, 4), (128, 5, 5), (128, 8, 5),
                          (64, 16, 5), (256, 8, 4), (144, 16, 4),
                          (20, 1, 4)):
        assert dplan.block_warps(D, rep) == warps
        plan = dplan.decode_plan(2, 2 * rep, 2, D, 512, torch.bfloat16)
        assert plan.threads == 32 * warps


# ----------------------------------------- split decode, emulated
def _split_decode(q, k, v, lengths, span, n_span, scale=None,
                  empty_v=None):
    """float32 emulation of the split body on a dense cache: a slot's
    spans are `span_len` keys long (`span`, or a multiple of it past
    `MAX_SPANS` spans); every span block of the grid past its slot's
    length exits; a slot of length 0 writes the mean of V over the rows
    its policy names (`empty_v` (rows, KV, D), physical page 0 of a
    paged pool dequantized; by default the slot's own S rows); each used
    span computes its (acc, m, l) over its keys in 32-key tiles, online
    (the tile's max rescales the sums so far), as the ring's rounds feed
    them; a slot with one used span writes acc / max(l, 1e-30), otherwise
    the spans merge online in span order (the running max rescales the
    sums so far)."""
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    rep = H // KV
    scale = scale if scale is not None else D ** -0.5
    out = torch.zeros(B, H, D)
    for b in range(B):
        n_keys = max(0, min(int(lengths[b]), S))
        spans = dplan.key_spans(int(lengths[b]), S, span)
        span_keys = dplan.span_len(n_keys, span)
        assert len(spans) <= n_span
        for g in range(KV):
            if n_keys == 0:
                rows = v[b, :, g] if empty_v is None else empty_v[:, g]
                out[b, g * rep:(g + 1) * rep] = rows.float().mean(0)
                continue
            qg = q[b, g * rep:(g + 1) * rep].float()      # (rep, D)
            parts = []
            for sp in range(n_span):
                if sp > 0 and sp * span_keys >= n_keys:
                    continue                              # past the length
                lo, hi = spans[sp]
                m = torch.full((rep,), tdref.NEG_INF)
                l_ = torch.zeros(rep)
                acc = torch.zeros(rep, D)
                for t0 in range(lo, hi, dplan.KEY_TILE):  # the span's tiles
                    t1 = min(t0 + dplan.KEY_TILE, hi)
                    kk, vv = k[b, t0:t1, g].float(), v[b, t0:t1, g].float()
                    s = (qg @ kk.T) * scale               # (rep, keys)
                    m_new = torch.maximum(m, s.amax(-1))
                    p = torch.exp(s - m_new[:, None])
                    alpha = torch.exp(m - m_new)
                    l_ = l_ * alpha + p.sum(-1)
                    acc = acc * alpha[:, None] + p @ vv
                    m = m_new
                parts.append((acc, m, l_))
            if len(parts) == 1:
                acc, _, l_ = parts[0]
                o = acc / torch.clamp_min(l_, 1e-30)[:, None]
            else:                      # online, in span order
                M = torch.full((rep,), tdref.NEG_INF)
                O = torch.zeros(rep, D)
                L = torch.zeros(rep)
                for acc, m, l_ in parts:
                    m_new = torch.maximum(M, m)
                    c, w = torch.exp(M - m_new), torch.exp(m - m_new)
                    L = L * c + w * l_
                    O = O * c[:, None] + w[:, None] * acc
                    M = m_new
                o = O / torch.clamp_min(L, 1e-30)[:, None]
            out[b, g * rep:(g + 1) * rep] = o
    return out


def _inputs(seed, B, H, KV, D, page, n_pages, pool):
    rng = np.random.default_rng(seed)
    P = B * n_pages
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    bt = np.stack([rng.permutation(P)[:n_pages] for _ in range(B)]).astype(
        np.int32)
    shape = (P, page, KV, D)
    if pool == "f32":
        return (q, rng.standard_normal(shape).astype(np.float32),
                (0.5 * rng.standard_normal(shape)).astype(np.float32), bt,
                None, None)
    sz_shape = (P, KV, 2) if pool == "int8/page" else (P, page, KV, 2)

    def sz():
        s = rng.uniform(0.005, 0.02, sz_shape[:-1])
        z = rng.uniform(-0.5, 0.5, sz_shape[:-1])
        return np.stack([s, z], -1).astype(np.float32)

    return (q, rng.integers(-127, 128, shape).astype(np.int8),
            rng.integers(-127, 128, shape).astype(np.int8), bt, sz(), sz())


@pytest.mark.parametrize("pool", ["f32", "int8/page", "int8/token"])
@pytest.mark.parametrize("rep", [1, 3, 8])
@pytest.mark.parametrize("page", [16, 64])
def test_split_decode_emulation_matches_plain(page, rep, pool):
    """Span partials plus the span-ordered merge equal the plain paged
    decode, the plain dense decode of the gathered cache and the
    reference package's plain paged decode within 1e-6, at lengths 0,
    1, the span edges, a page edge, the capacity and parked; and equal
    themselves bit for bit for every span count from the used spans up
    to past the capacity's. At length 0 the paged body averages physical
    page 0's V rows (where the reference clamps every dead entry), the
    dense one the slot's own rows."""
    span = dplan.SPAN
    KV, D = 2, 64 if rep != 8 else 20
    H = KV * rep
    n_pages = -(-(2 * span + 16) // page)
    cap = n_pages * page
    lengths = np.array([0, 1, span - 1, span, span + 1, page, 2 * span + 1,
                        cap, cap + 7], np.int32)
    q, kp, vp, bt, ksz, vsz = _inputs(page * 7 + rep, len(lengths), H, KV,
                                      D, page, n_pages, pool)
    t = {n: (torch.from_numpy(a) if a is not None else None) for n, a in
         dict(q=q, kp=kp, vp=vp, bt=bt, ksz=ksz, vsz=vsz,
              len=lengths).items()}
    plain = tdops.paged_decode_mha(t["q"], t["kp"], t["vp"], t["bt"],
                                   t["len"], k_sz=t["ksz"], v_sz=t["vsz"])
    if ksz is None:
        kd = tdref.gather_pages(t["kp"], t["bt"])
        vd = tdref.gather_pages(t["vp"], t["bt"])
    else:
        kd = tdref.gather_pages_q8(t["kp"], t["ksz"], t["bt"])
        vd = tdref.gather_pages_q8(t["vp"], t["vsz"], t["bt"])
    dense = tdops.decode_mha(t["q"], kd, vd, t["len"])
    jkw = {} if ksz is None else dict(k_sz=jnp.asarray(ksz),
                                      v_sz=jnp.asarray(vsz))
    jplain = torch.from_numpy(np.array(jdref.paged_decode_mha(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(lengths), **jkw)))
    used = max(len(dplan.key_spans(int(n), cap, span)) for n in lengths)
    n_full = dplan.decode_plan(len(lengths), H, KV, D, cap, t["kp"].dtype,
                               span).n_span
    assert used == 3 and n_full == -(-cap // span)
    page0 = _page0_v(t["vp"], t["vsz"])
    emu = _split_decode(t["q"], kd, vd, t["len"], span, used, empty_v=page0)
    torch.testing.assert_close(emu, plain.float(), **TOL)
    # the reference's plain version masks with -inf, so its length-0 row
    # is NaN (its Pallas kernels average V: test_length_zero_...)
    torch.testing.assert_close(emu[1:], jplain[1:].float(), **TOL)
    torch.testing.assert_close(
        _split_decode(t["q"], kd, vd, t["len"], span, used), dense.float(),
        **TOL)
    for n_span in (used + 1, n_full, n_full + 5):
        assert torch.equal(_split_decode(t["q"], kd, vd, t["len"], span,
                                         n_span, empty_v=page0), emu)
    # slots past the span cap (longer spans walked as tiles) at a reduced
    # head dim, and paligemma-3b's head dim 256 (span 32) at rep 8
    _check_against_plain(page, rep, pool, 16 if rep != 8 else 20, span,
                         (4096, 4097, 9000, 16384, 1), 16384 + page)
    if rep == 8:
        _check_against_plain(page, rep, pool, 256, dplan.default_span(256),
                             (1, 31, 33, 700, 2049), 2048 + page)


def _check_against_plain(page, rep, pool, D, span, lengths, cap_keys):
    """`_split_decode` at these lengths (>= 1; the default span cap)
    against the plain paged decode, the plain dense decode of the
    gathered cache and the reference package's plain paged decode, within
    1e-6 (1e-5 above D 128). (At length 0 and a long capacity the plain versions average
    page 0's rows repeated over the whole table, whose float32 sum drifts
    from the mean of the page's own rows: the short test covers it.)"""
    KV = 2
    H = KV * rep
    n_pages = -(-cap_keys // page)
    cap = n_pages * page
    lengths = np.array(lengths, np.int32)
    q, kp, vp, bt, ksz, vsz = _inputs(page + rep + D, len(lengths), H, KV,
                                      D, page, n_pages, pool)
    t = {n: (torch.from_numpy(a) if a is not None else None) for n, a in
         dict(q=q, kp=kp, vp=vp, bt=bt, ksz=ksz, vsz=vsz,
              len=lengths).items()}
    plain = tdops.paged_decode_mha(t["q"], t["kp"], t["vp"], t["bt"],
                                   t["len"], k_sz=t["ksz"], v_sz=t["vsz"])
    if ksz is None:
        kd = tdref.gather_pages(t["kp"], t["bt"])
        vd = tdref.gather_pages(t["vp"], t["bt"])
    else:
        kd = tdref.gather_pages_q8(t["kp"], t["ksz"], t["bt"])
        vd = tdref.gather_pages_q8(t["vp"], t["vsz"], t["bt"])
    dense = tdops.decode_mha(t["q"], kd, vd, t["len"])
    jkw = {} if ksz is None else dict(k_sz=jnp.asarray(ksz),
                                      v_sz=jnp.asarray(vsz))
    jplain = torch.from_numpy(np.array(jdref.paged_decode_mha(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(lengths), **jkw)))
    n_span = dplan.decode_plan(len(lengths), H, KV, D, cap, t["kp"].dtype,
                               span).n_span
    assert n_span == min(-(-cap // span), dplan.MAX_SPANS)
    emu = _split_decode(t["q"], kd, vd, t["len"], span, n_span,
                        empty_v=_page0_v(t["vp"], t["vsz"]))
    tol = TOL if D <= 128 else TOL_WIDE
    torch.testing.assert_close(emu, plain.float(), **tol)
    torch.testing.assert_close(emu, jplain.float(), **tol)
    torch.testing.assert_close(
        _split_decode(t["q"], kd, vd, t["len"], span, n_span),
        dense.float(), **tol)


def _page0_v(vp, vsz):
    """Physical page 0 of a V pool, dequantized to float32 (page, KV, D):
    the rows a length-0 slot of the paged decode averages."""
    if vsz is None:
        return vp[0].float()
    return tdref.gather_pages_q8(vp, vsz, torch.zeros(1, 1, dtype=torch.int32)
                                 )[0]


@pytest.mark.parametrize("pool", ["f32", "int8/page", "int8/token"])
def test_length_zero_matches_pallas_interpret(pool):
    """A row of length 0 (beside rows of length 1 and 5) through the
    port's plain paged and dense decodes equals the reference package's
    Pallas kernels run in interpret mode (`ops` with impl="interpret"):
    the paged op the mean of physical page 0's V rows, dequantized with
    page 0's (scale, zero) per page or per token, though the slot's
    table names other pages; the dense op the mean of the slot's S rows.
    The split-decode emulation gives the same rows. float32, within
    atol=rtol=1e-6 (sums in another order)."""
    B, H, KV, D, page, n_pages = 3, 6, 2, 16, 8, 3
    q, kp, vp, bt, ksz, vsz = _inputs(11, B, H, KV, D, page, n_pages, pool)
    bt[0] = np.arange(1, n_pages + 1)            # never page 0 itself
    lengths = np.array([0, 1, 5], np.int32)
    t = {n: (torch.from_numpy(a) if a is not None else None) for n, a in
         dict(q=q, kp=kp, vp=vp, bt=bt, ksz=ksz, vsz=vsz,
              len=lengths).items()}
    jkw = {} if ksz is None else dict(k_sz=jnp.asarray(ksz),
                                      v_sz=jnp.asarray(vsz))
    jpaged = torch.from_numpy(np.array(jdops.paged_decode_mha(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(lengths), impl="interpret", **jkw)))
    paged = tdops.paged_decode_mha(t["q"], t["kp"], t["vp"], t["bt"],
                                   t["len"], k_sz=t["ksz"], v_sz=t["vsz"])
    torch.testing.assert_close(paged, jpaged, **TOL)
    page0 = _page0_v(t["vp"], t["vsz"])
    torch.testing.assert_close(paged[0], page0.mean(0).repeat_interleave(
        H // KV, 0), **TOL)
    if ksz is None:
        kd = tdref.gather_pages(t["kp"], t["bt"])
        vd = tdref.gather_pages(t["vp"], t["bt"])
    else:
        kd = tdref.gather_pages_q8(t["kp"], t["ksz"], t["bt"])
        vd = tdref.gather_pages_q8(t["vp"], t["vsz"], t["bt"])
    emu = _split_decode(t["q"], kd, vd, t["len"], dplan.SPAN, 1,
                        empty_v=page0)
    torch.testing.assert_close(emu, paged, **TOL)
    # the contiguous cache: the slot's own S rows
    jdense = torch.from_numpy(np.array(jdops.decode_mha(
        jnp.asarray(q), jnp.asarray(kd.numpy()), jnp.asarray(vd.numpy()),
        jnp.asarray(lengths), impl="interpret")))
    dense = tdops.decode_mha(t["q"], kd, vd, t["len"])
    torch.testing.assert_close(dense, jdense, **TOL)
    torch.testing.assert_close(dense[0], vd[0].mean(0).repeat_interleave(
        H // KV, 0), **TOL)
    torch.testing.assert_close(_split_decode(t["q"], kd, vd, t["len"],
                                             dplan.SPAN, 1), dense, **TOL)


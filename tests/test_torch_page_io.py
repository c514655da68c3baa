"""The port's page copies against the reference package, and the grouped
CUDA kernel's work plan.

- the plain `write_pages` (one leaf and grouped) against the reference's
  `write_pages_pallas` in interpret mode on the same numpy inputs (int8
  payload, float32 (scale, zero) rows, bf16), an out-of-range id against
  the reference's plain scatter (dropped);
- the plain `copy_pages` (the substrate's page_out / page_in) against
  `t.at[:, ids].set(p[:, ids])` and `t[:, ids]`;
- the fleet's handoff copy (both id vectors, pool to pool) through the
  kernel's walk against the op's plain "handoff" stream;
- an emulation of the CUDA body's walk over the descriptor that
  `page_io.plan` builds for the wrapper: every byte of every segment is
  covered exactly once, at the vector width chosen (16 B payload, 8 B for
  40-byte rows, 1 B for odd rows), ragged last tiles included, and the
  result equals the plain version. All bit-exact.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.page_io import ref as jref  # noqa: E402
from repro.kernels.page_io.page_io import write_pages_pallas  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.kernels.page_io import ops as tops  # noqa: E402
from repro_torch.kernels.page_io import page_io as pio  # noqa: E402
from repro_torch.kernels.page_io import ref as tref  # noqa: E402

# page dims of the serving pools (reduced widths): payload (page, KV, hd),
# per-page (scale, zero) rows (KV, 2) f32 = 40 B at KV 5, per-token rows
PAGE_SHAPES = {
    "int8": ((16, 2, 20), np.int8),
    "sz": ((5, 2), np.float32),
    "bf16": ((16, 2, 8), "bf16"),
}


def _arrays(rng, shape, kind):
    if kind == np.int8:
        return rng.integers(-127, 128, shape).astype(np.int8)
    return rng.standard_normal(shape).astype(np.float32)


def _torch(x, kind):
    t = torch.from_numpy(x.copy())
    return t.to(torch.bfloat16) if kind == "bf16" else t


def _jax(x, kind):
    return jnp.asarray(x, dtype=jnp.bfloat16 if kind == "bf16" else x.dtype)


def _bits(t):
    t = t.contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _jbits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def _pallas(pool, tiles, phys):
    nb, P = pool.shape[:2]
    out = write_pages_pallas(pool.reshape(nb, P, -1),
                             tiles.reshape(nb, tiles.shape[1], -1),
                             jnp.asarray(phys), interpret=True)
    return out.reshape(pool.shape)


# ------------------------------------------------------------ page writes
@pytest.mark.parametrize("leaf", sorted(PAGE_SHAPES))
@pytest.mark.parametrize("n_wp", [1, 3])
def test_write_pages_matches_pallas(leaf, n_wp):
    rng = np.random.default_rng(n_wp * 7 + len(leaf))
    shape, kind = PAGE_SHAPES[leaf]
    nb, P = 3, 10
    phys = rng.permutation(P)[:n_wp].astype(np.int32)
    pool = _arrays(rng, (nb, P, *shape), kind)
    tiles = _arrays(rng, (nb, n_wp, *shape), kind)
    want = _pallas(_jax(pool, kind), _jax(tiles, kind), phys)
    tpool = _torch(pool, kind)
    out = tops.write_pages(tpool, _torch(tiles, kind), torch.from_numpy(phys))
    assert out is tpool
    np.testing.assert_array_equal(_bits(out), _jbits(want))


@pytest.mark.parametrize("per_token", [False, True])
def test_grouped_write_matches_pallas_per_leaf(per_token):
    """The admission's four leaves (k, k_sz, v, v_sz) in one grouped call
    equal four Pallas writes, and count one plain call."""
    rng = np.random.default_rng(11 + per_token)
    nb, P, n_wp, page, KV, hd = 2, 12, 4, 8, 5, 4
    phys = rng.permutation(P)[:n_wp].astype(np.int32)
    sz = (page, KV, 2) if per_token else (KV, 2)
    leaves = [((page, KV, hd), np.int8), (sz, np.float32)] * 2
    pools = [_arrays(rng, (nb, P, *s), k) for s, k in leaves]
    tiles = [_arrays(rng, (nb, n_wp, *s), k) for s, k in leaves]
    tpools = [_torch(p, k) for p, (_, k) in zip(pools, leaves)]
    tk.reset_counters()
    tops.write_pages_group(tpools, [_torch(t, k) for t, (_, k)
                                    in zip(tiles, leaves)],
                           torch.from_numpy(phys))
    assert tk.REFERENCE_CALLS["write_pages"] == 1
    assert sum(tk.LAUNCHES.values()) == 0
    for tp, p, t, (_, k) in zip(tpools, pools, tiles, leaves):
        want = _pallas(_jax(p, k), _jax(t, k), phys)
        np.testing.assert_array_equal(_bits(tp), _jbits(want))


def test_write_pages_drops_out_of_range_ids():
    """An id at or past P is dropped, as the reference's scatter drops it
    and the kernel never writes it; the other pages land. A negative id is
    the documented departure: the reference wraps -1 to page P - 1 and
    writes it, the port drops it; every other page agrees."""
    rng = np.random.default_rng(5)
    nb, P = 2, 6
    phys = np.array([4, 6, 1, 100], np.int32)
    pool = _arrays(rng, (nb, P, 3, 8), np.int8)
    tiles = _arrays(rng, (nb, 4, 3, 8), np.int8)
    want = jref.write_pages(jnp.asarray(pool), jnp.asarray(tiles),
                            jnp.asarray(phys))
    out = tops.write_pages(torch.from_numpy(pool.copy()),
                           torch.from_numpy(tiles), torch.from_numpy(phys))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    neg_ids = np.array([-1, 2, 3, 7], np.int32)
    jneg = np.asarray(jref.write_pages(jnp.asarray(pool), jnp.asarray(tiles),
                                       jnp.asarray(neg_ids)))
    neg = tops.write_pages(torch.from_numpy(pool.copy()),
                           torch.from_numpy(tiles),
                           torch.from_numpy(neg_ids)).numpy()
    np.testing.assert_array_equal(jneg[:, P - 1], tiles[:, 0])  # wrapped
    np.testing.assert_array_equal(neg[:, P - 1], pool[:, P - 1])  # dropped
    np.testing.assert_array_equal(neg[:, :P - 1], jneg[:, :P - 1])
    keep = pool.copy()
    keep[:, 2:4] = tiles[:, 1:3]
    np.testing.assert_array_equal(neg, keep)


# ------------------------------------------------------------ page streams
@pytest.mark.parametrize("leaf", sorted(PAGE_SHAPES))
def test_copy_pages_out_and_in_match_jnp(leaf):
    """page_out: `twin.at[:, ids].set(pool[:, ids])`; page_in: `twin[:,
    ids]` into scratch; and page_in returns what page_out wrote."""
    rng = np.random.default_rng(len(leaf))
    shape, kind = PAGE_SHAPES[leaf]
    nb, P = 3, 16
    ids = rng.permutation(P)[:7].astype(np.int32)
    pool = _arrays(rng, (nb, P, *shape), kind)
    twin = _arrays(rng, (nb, P, *shape), kind)
    jt = _jax(twin, kind).at[:, ids].set(_jax(pool, kind)[:, ids])
    tt, tp = _torch(twin, kind), _torch(pool, kind)
    tk.reset_counters()
    tops.copy_pages(tt, torch.from_numpy(ids), tp, torch.from_numpy(ids),
                    name="page_out")
    np.testing.assert_array_equal(_bits(tt), _jbits(jt))
    scratch = torch.zeros((nb, len(ids), *shape), dtype=tt.dtype)
    tops.copy_pages([scratch], None, [tt], torch.from_numpy(ids),
                    name="page_in")
    np.testing.assert_array_equal(_bits(scratch), _jbits(jt[:, ids]))
    np.testing.assert_array_equal(_bits(scratch), _bits(tp[:, ids]))
    assert (tk.REFERENCE_CALLS["page_out"], tk.REFERENCE_CALLS["page_in"]) \
        == (1, 1)
    assert sum(tk.LAUNCHES.values()) == 0


def test_copy_pages_checks_its_stream_and_device():
    t = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="stream"):
        tops.copy_pages(t, None, t, None, name="page_sideways")
    with pytest.raises(ValueError, match="CUDA"):
        tops.copy_pages(t, None, t, None, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tops.write_pages(t, t[:, :1], torch.tensor([0]), impl="cuda")


# ------------------------------------------------ the kernel's work plan
class _Mem:
    """Fake device memory: buffers at chosen addresses, so the planner
    sees the alignment a real allocation would have."""

    def __init__(self):
        self.bufs = {}
        self.next = 1 << 20

    def put(self, arr: np.ndarray, misalign: int = 0) -> int:
        addr = self.next + misalign
        self.next += (arr.nbytes // 4096 + 2) * 4096
        self.bufs[addr] = arr
        return addr

    def find(self, addr):
        for base, arr in self.bufs.items():
            if base <= addr < base + max(arr.nbytes, 1):
                return base, arr
        raise KeyError(hex(addr))


def _fields(plan):
    n_seg = int(plan.desc[0])
    return plan.desc[pio.HEADER:pio.HEADER + n_seg * pio.SEG_FIELDS] \
        .reshape(n_seg, pio.SEG_FIELDS)


def _div(v, mul, shift):
    """The kernel's multiply-shift division (`div_by`)."""
    return (v.astype(np.uint64) * np.uint64(mul)) >> np.uint64(shift)


def _emulate(plan: pio.Plan, mem: _Mem):
    """Run the kernel's walk over `plan.desc` with numpy: block (x,
    y) takes tiles x, x + grid_x, ... of segment y, so every tile of every
    segment once; returns {dst base: per-byte write counts}."""
    counts = {}
    tid = np.arange(pio.THREADS, dtype=np.int64)
    grid_x, n_seg = plan.grid
    assert n_seg == int(plan.desc[0])
    for f in _fields(plan).tolist():
        (dst, src, dst_ids, src_ids, P_dst, P_src, M, n_vec, n_tiles,
         per_page, pp_mul, pp_sh, n, n_mul, n_sh, vec, stage) = f
        assert M % vec == 0 and dst % vec == 0 and src % vec == 0
        assert M // vec == per_page and n_vec % (n * per_page) == 0
        dbase, darr = mem.find(dst)
        sbase, sarr = mem.find(src)
        dbytes = darr.reshape(-1).view(np.uint8)
        sbytes = sarr.reshape(-1).view(np.uint8)
        cnt = counts.setdefault(dbase, np.zeros(dbytes.size, np.int64))

        def ids_of(ptr):
            base, arr = mem.find(ptr)
            return arr.reshape(-1)[(ptr - base) // 4:][:n].astype(np.int64)

        # the staged copy and the global reads hold the same ids
        d_ids = ids_of(dst_ids) if dst_ids else None
        s_ids = ids_of(src_ids) if src_ids else None
        tiles = [t for x in range(grid_x) for t in range(x, n_tiles, grid_x)]
        assert sorted(tiles) == list(range(n_tiles))
        for tile in tiles:
            for u in range(pio.UNROLL):
                v = tile * pio.TILE + u * pio.THREADS + tid
                assert v.max() < 2**31
                row = _div(v, pp_mul, pp_sh).astype(np.int64)
                off = v - row * per_page
                lev = _div(row, n_mul, n_sh).astype(np.int64)
                j = row - lev * n
                live = v < n_vec
                lev, j, off = lev[live], j[live], off[live]
                sp = j if s_ids is None else s_ids[j]
                dp = j if d_ids is None else d_ids[j]
                ok = (sp >= 0) & (sp < P_src) & (dp >= 0) & (dp < P_dst)
                so = (lev * P_src + sp) * M + off * vec + (src - sbase)
                do = (lev * P_dst + dp) * M + off * vec + (dst - dbase)
                for b in range(vec):
                    dbytes[do[ok] + b] = sbytes[so[ok] + b]
                    np.add.at(cnt, do[ok] + b, 1)
    return counts


def _layout(rng, mem, nb, P, n, shape, dtype, misalign=0, src_ids=False):
    """One page-write segment's tensors in fake memory: pool, tiles, ids
    (and, for a copy, source ids over a source pool)."""
    pool = rng.integers(-100, 100, (nb, P, *shape)).astype(dtype)
    ids = rng.permutation(P)[:n].astype(np.int32)
    if src_ids:
        src = rng.integers(-100, 100, (nb, P, *shape)).astype(dtype)
        sids = rng.permutation(P)[:n].astype(np.int32)
    else:
        src = rng.integers(-100, 100, (nb, n, *shape)).astype(dtype)
        sids = None
    M = int(np.prod(shape)) * np.dtype(dtype).itemsize
    seg = pio.Segment(
        dst=mem.put(pool, misalign), src=mem.put(src, misalign),
        dst_ids=mem.put(ids), src_ids=0 if sids is None else mem.put(sids),
        nb=nb, P_dst=P, P_src=src.shape[1], n=n, M=M)
    return seg, pool, src, ids, sids


# (nb, P, n, page dims, dtype, base misalignment, source ids, vec wanted)
PLAN_CASES = [
    (32, 40, 8, (16, 5, 64), np.int8, 0, False, 16),   # SmolLM payload
    (32, 40, 8, (5, 2), np.float32, 0, False, 8),      # 40-byte sz rows
    (4, 9, 3, (16, 5, 2), np.float32, 0, False, 16),   # per-token sz rows
    (3, 7, 5, (3, 5, 7), np.int8, 0, False, 1),        # odd rows
    (2, 6, 2, (4, 6), np.int8, 4, False, 4),           # misaligned base
    (5, 11, 4, (17, 2), np.int16, 0, True, 4),         # copy, both ids
    (1, 3, 3, (7,), np.int8, 0, True, 1),              # ragged tiny copy
    (4, 12, 6, (16, 5, 64), np.int16, 0, False, 16),   # bf16 payload
    (3, 10, 4, (16, 5, 2), np.float32, 0, False, 16),  # per-token sz, KV 5
    (2, 64, 33, (16, 5, 64), np.int8, 0, True, 16),    # page_out burst
    (4, 9, 3, (5, 2), np.float32, 8, False, 8),        # 40 B rows, base 8
    (2, 9, 5, (5, 2), np.float32, 4, True, 4),         # 40 B rows, base 4
]


@pytest.mark.parametrize("n_sm", [None, 1])
@pytest.mark.parametrize("case", range(len(PLAN_CASES)))
def test_vector_plan_covers_every_byte_once(case, n_sm):
    """Every byte of the segment is written once, at the vector width the
    alignment allows; with one SM's worth of blocks (n_sm=1) the blocks
    walk several tiles each."""
    nb, P, n, shape, dtype, mis, with_src_ids, vec = PLAN_CASES[case]
    rng = np.random.default_rng(case)
    mem = _Mem()
    seg, pool, src, ids, sids = _layout(rng, mem, nb, P, n, shape, dtype,
                                        mis, with_src_ids)
    want = torch.from_numpy(pool.copy())
    if with_src_ids:
        tref.copy_pages([want], torch.from_numpy(ids),
                        [torch.from_numpy(src)], torch.from_numpy(sids))
    else:
        tref.write_pages(want, torch.from_numpy(src), torch.from_numpy(ids))
    plan = pio.plan([seg]) if n_sm is None else pio.plan([seg], n_sm=n_sm)
    assert _fields(plan)[0, 15] == vec
    assert 0 < plan.grid[0] <= plan.n_tiles and plan.grid[1] == 1
    if n_sm == 1:
        assert plan.grid[0] == min(plan.n_tiles, pio.BLOCKS_PER_SM)
    counts = _emulate(plan, mem)
    np.testing.assert_array_equal(pool, want.numpy())
    cnt = counts[seg.dst].reshape(nb, P, -1)
    written = np.zeros((nb, P), bool)
    written[:, ids] = True
    assert (cnt[written] == 1).all() and (cnt[~written] == 0).all()


def test_grouped_plan_of_an_admission():
    """The bucket insert's four leaves in one descriptor: one staged id
    vector for all four, tiles in segment order, payload at 16 B and the
    40-byte rows at 8 B, every written byte once; ids past P dropped."""
    rng = np.random.default_rng(0)
    mem = _Mem()
    nb, P, n = 4, 20, 5
    ids = np.array([3, 19, 0, 25, 7], np.int32)     # 25: out of range
    ids_ptr = mem.put(ids)
    pools, tiles, segs = [], [], []
    for shape, dtype in [((16, 5, 8), np.int8), ((5, 2), np.float32)] * 2:
        p = rng.integers(-100, 100, (nb, P, *shape)).astype(dtype)
        t = rng.integers(-100, 100, (nb, n, *shape)).astype(dtype)
        M = int(np.prod(shape)) * np.dtype(dtype).itemsize
        segs.append(pio.Segment(dst=mem.put(p), src=mem.put(t),
                                dst_ids=ids_ptr, src_ids=0, nb=nb, P_dst=P,
                                P_src=n, n=n, M=M))
        pools.append(p)
        tiles.append(t)
    plan = pio.plan(segs)
    fields = _fields(plan)
    assert plan.grid == (fields[:, 8].max(), 4)
    assert (fields[:, 2] == ids_ptr).all() and (fields[:, 3] == 0).all()
    assert fields[:, 15].tolist() == [16, 8, 16, 8]
    assert (fields[:, 16] == 1).all()                # ids staged
    wants = []
    for p, t in zip(pools, tiles):
        w = torch.from_numpy(p.copy())
        tref.write_pages(w, torch.from_numpy(t), torch.from_numpy(ids))
        wants.append(w.numpy())
    counts = _emulate(plan, mem)
    for seg, p, w in zip(segs, pools, wants):
        np.testing.assert_array_equal(p, w)
        cnt = counts[seg.dst].reshape(nb, P, -1)
        live = ids[ids < P]
        assert (cnt[:, live] == 1).all()
        assert cnt.sum() == nb * len(live) * seg.M


def test_handoff_plan_between_two_pools():
    """The fleet's handoff: the four leaves of one engine's pool onto
    another's, both id vectors given and distinct, in one descriptor.
    Both vectors are staged, every destination page written once, the
    source left alone, the result equal to the op's plain "handoff"
    stream (one plain call)."""
    rng = np.random.default_rng(1)
    mem = _Mem()
    nb, P, n = 3, 24, 6
    src_ids = rng.permutation(P)[:n].astype(np.int32)
    dst_ids = rng.permutation(P)[:n].astype(np.int32)
    s_ptr, d_ptr = mem.put(src_ids), mem.put(dst_ids)
    dsts, srcs, segs = [], [], []
    for shape, dtype in [((16, 5, 8), np.int8), ((5, 2), np.float32)] * 2:
        d = rng.integers(-100, 100, (nb, P, *shape)).astype(dtype)
        sp = rng.integers(-100, 100, (nb, P, *shape)).astype(dtype)
        M = int(np.prod(shape)) * np.dtype(dtype).itemsize
        segs.append(pio.Segment(dst=mem.put(d), src=mem.put(sp),
                                dst_ids=d_ptr, src_ids=s_ptr, nb=nb,
                                P_dst=P, P_src=P, n=n, M=M))
        dsts.append(d)
        srcs.append(sp)
    plan = pio.plan(segs)
    fields = _fields(plan)
    assert (fields[:, 2] == d_ptr).all() and (fields[:, 3] == s_ptr).all()
    assert fields[:, 15].tolist() == [16, 8, 16, 8]
    assert (fields[:, 16] == 1).all()                # both staged
    want = [torch.from_numpy(d.copy()) for d in dsts]
    src_before = [sp.copy() for sp in srcs]
    tk.reset_counters()
    tops.copy_pages(want, torch.from_numpy(dst_ids),
                    [torch.from_numpy(sp) for sp in srcs],
                    torch.from_numpy(src_ids), name="handoff")
    assert tk.REFERENCE_CALLS["handoff"] == 1
    counts = _emulate(plan, mem)
    for seg, d, w, sp, s0 in zip(segs, dsts, want, srcs, src_before):
        np.testing.assert_array_equal(d, w.numpy())
        np.testing.assert_array_equal(sp, s0)
        cnt = counts[seg.dst].reshape(nb, P, -1)
        assert (cnt[:, dst_ids] == 1).all()
        assert cnt.sum() == nb * n * seg.M


def test_plan_stages_ids_while_they_fit_and_splits_big_segments():
    big = pio.Segment(dst=1 << 20, src=1 << 40, dst_ids=4096, src_ids=8192,
                      nb=2, P_dst=4096, P_src=4096, n=pio.ID_CAP // 2 + 1,
                      M=32)
    assert _fields(pio.plan([big]))[0, 16] == 0       # too many: global
    small = dataclasses.replace(big, n=pio.ID_CAP // 2)
    assert _fields(pio.plan([small]))[0, 16] == 1
    none = dataclasses.replace(small, dst_ids=0, src_ids=0)
    assert _fields(pio.plan([none]))[0, 16] == 0
    # an 8.6 GB stream at 1-byte vectors exceeds 32-bit vector counts
    huge = pio.Segment(dst=1 << 20, src=1 << 41, dst_ids=4096, src_ids=4096,
                       nb=32, P_dst=4096, P_src=4096, n=4096, M=65537)
    plan = pio.plan([huge])
    fields = _fields(plan)
    pages = fields[:, 7] // fields[:, 9]             # n_vec / per_page
    assert len(fields) > 1 and pages.sum() == 32 * 4096
    assert (fields[:, 7] <= pio.MAX_VEC).all()
    assert (np.diff(fields[:, 0]) == pages[:-1] * 65537).all()
    assert plan.grid[1] == len(fields)
    with pytest.raises(ValueError, match="segments"):
        pio.plan([small] * (pio.MAX_SEGS + 1))


@pytest.mark.parametrize("d", [1, 2, 3, 5, 7, 8, 40, 320, 641, 4096, 5121,
                               65537, 2**20 + 1, 2**31 - 1])
def test_magic_division_is_exact(d):
    """The kernel's multiply-shift division equals v // d for every
    31-bit v: checked at the edges and on random values."""
    mul, shift = pio.magic(d)
    assert 0 < mul < 2**32
    rng = np.random.default_rng(d)
    v = np.concatenate([
        np.arange(0, 4 * d + 3) if d < 2**16 else np.arange(0, 70000),
        np.arange(2**31 - 4 * min(d, 2**16) - 3, 2**31),
        (np.arange(1, 200) * d)[np.arange(1, 200) * d < 2**31],
        rng.integers(0, 2**31, 200_000)]).astype(np.int64)
    v = np.concatenate([v, np.maximum(v - 1, 0)])
    np.testing.assert_array_equal(_div(v, mul, shift).astype(np.int64),
                                  v // d)

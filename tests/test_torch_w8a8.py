"""The port's W8A8 int8 matmul against the reference's on the same numpy
inputs: `quantize_rows` equal bit for bit on both axes; the op on CPU
tensors (the plain version) against the Pallas kernel in interpret mode
on the reference test's four shapes at rtol = atol = 1e-6 (its own
tolerance); zero operands exact; the plain version's float64 product (the
one torch has on CUDA) equal to its int32 product."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.matmul_w8a8 import ops as jops  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.matmul_w8a8 import ops as tops  # noqa: E402
from repro_torch.kernels.matmul_w8a8 import ref as tref  # noqa: E402

SHAPES = [(128, 128, 128), (256, 384, 256), (130, 96, 200), (1, 128, 256)]


def _operands(M, K, N):
    rng = np.random.default_rng(M + K + N)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = (rng.standard_normal((K, N)) * 0.5).astype(np.float32)
    return a, b


@pytest.mark.parametrize("axis", [-1, 0, 1])
def test_quantize_rows_matches_reference(axis):
    a, _ = _operands(96, 200, 1)
    a[3] = 0.0                        # an all-zero row keeps MIN_SCALE
    a[5, 7] = 1e-9
    q, s = tops.quantize_rows(torch.from_numpy(a), axis=axis)
    jq, js = jops.quantize_rows(jnp.asarray(a), axis=axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_matmul_w8a8_matches_reference(M, K, N):
    a, b = _operands(M, K, N)
    a8, sa = jops.quantize_rows(jnp.asarray(a))
    b8, sb = jops.quantize_rows(jnp.asarray(b), axis=0)
    want = np.asarray(jops.matmul_w8a8(a8, b8, sa, sb, impl="interpret"))
    kernels.reset_counters()
    got = tops.matmul_w8a8(*(torch.from_numpy(np.array(x))
                             for x in (a8, b8, sa, sb)))
    assert kernels.REFERENCE_CALLS["matmul_w8a8"] == 1
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    fp = a @ b
    assert np.abs(got.numpy() - fp).max() / np.abs(fp).max() < 0.05


def test_matmul_w8a8_zero_operands_exact():
    a8, sa = tops.quantize_rows(torch.zeros(64, 128))
    b8, sb = tops.quantize_rows(torch.zeros(128, 64), axis=0)
    out = tops.matmul_w8a8(a8, b8, sa, sb)
    assert torch.equal(out, torch.zeros(64, 64))


@pytest.mark.parametrize("M,K,N", SHAPES + [(8, 960, 2560)])
def test_plain_float64_product_equals_int32(M, K, N):
    """The float64 product is exact: equal to the int32 one on the CPU,
    down to the epilogue, at the extremes of the int8 range too."""
    rng = np.random.default_rng(K)
    a8 = torch.from_numpy(rng.integers(-127, 128, (M, K), dtype=np.int8))
    b8 = torch.from_numpy(rng.integers(-127, 128, (K, N), dtype=np.int8))
    a8[0] = 127
    b8[:, 0] = 127
    sa = torch.from_numpy(rng.uniform(1e-3, 1e-1, M).astype(np.float32))
    sb = torch.from_numpy(rng.uniform(1e-3, 1e-1, N).astype(np.float32))
    acc = tref.int_matmul(a8, b8, via="int32")
    assert acc.dtype == torch.int32 and int(acc[0, 0]) == 127 * 127 * K
    assert torch.equal(tref.int_matmul(a8, b8, via="float64"), acc)
    assert torch.equal(tref.matmul_w8a8(a8, b8, sa, sb, via="float64"),
                       tref.matmul_w8a8(a8, b8, sa, sb, via="int32"))


def test_matmul_w8a8_kernel_refuses_cpu_tensors():
    a8, sa = tops.quantize_rows(torch.ones(4, 8))
    b8, sb = tops.quantize_rows(torch.ones(8, 4), axis=0)
    with pytest.raises(ValueError, match="CUDA"):
        tops.matmul_w8a8(a8, b8, sa, sb, impl="cuda")


# ------------------------------------- the tensor-core kernel, emulated
def _byte_perm(x, y, s):
    """CUDA's __byte_perm: byte i of the result is byte ((s >> 4i) & 7) of
    the eight bytes y:x (x's low byte first)."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + [
        (y >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(s >> (4 * i)) & 7] << (8 * i)
    return out


def _words(mem, addr):
    """Little-endian 32-bit words of a byte array at byte addresses."""
    b = mem[addr[..., None] + np.arange(4)].astype(np.uint32)
    return b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24


def _ldsm_x4(mem, addr, trans=False):
    """ldmatrix .x4 of 8x8 b16 matrices: lanes 8i..8i+7 give the row
    addresses of matrix i. Lane l = 4 gr + t gets, in register i, the
    word t of row gr (not transposed), or (.trans) the b16 at column gr
    of rows 2t (low half) and 2t + 1 (high half)."""
    lane = np.arange(32)
    gr, t = lane // 4, lane % 4
    if not trans:
        return [_words(mem, addr[8 * i + gr] + 4 * t) for i in range(4)]
    regs = []
    for i in range(4):
        lo = addr[8 * i + 2 * t] + 2 * gr
        hi = addr[8 * i + 2 * t + 1] + 2 * gr
        regs.append(mem[lo].astype(np.uint32) | mem[lo + 1].astype(
            np.uint32) << 8 | mem[hi].astype(np.uint32) << 16
            | mem[hi + 1].astype(np.uint32) << 24)
    return regs


def _bytes(reg):
    """(32,) uint32 -> (32, 4) int8, the lowest byte first."""
    return reg.astype("<u4").view(np.uint8).reshape(32, 4).view(np.int8)


def _mma_s8(acc, a, b0, b1):
    """mma.sync m16n8k32 s8.s8.s32 from the fragment layouts of
    `csrc/mma.cuh`: acc (32, 4) int64 += the lanes' A (16 x 32) @ B
    (32 x 8)."""
    lane = np.arange(32)
    gr, t = lane // 4, lane % 4
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for reg, dr, dk in ((a[0], 0, 0), (a[1], 8, 0), (a[2], 0, 16),
                        (a[3], 8, 16)):
        A[(gr + dr)[:, None], dk + 4 * t[:, None] + np.arange(4)] = _bytes(
            reg)
    for reg, dk in ((b0, 0), (b1, 16)):
        B[dk + 4 * t[:, None] + np.arange(4), gr[:, None]] = _bytes(reg)
    D = A @ B
    for e in range(4):
        acc[:, e] += D[gr + 8 * (e >> 1), 2 * t + (e & 1)]


def _b_row(k):
    """The kernel's staged row of B's k-th row within a K tile."""
    return (k & ~15) + ((k >> 2) & 3) * 2 + (k & 1) + ((k >> 1) & 1) * 8


def _emulate_w8a8(a8, b8, sa, sb, bm, bn):
    """The tensor-core kernel block by block, warp by warp: A and B tiles
    staged zero-filled (B's rows in the kernel's permuted k order),
    ldmatrix fragments (.trans for B), the byte permutes into even and
    odd column tiles, int8 mma, the epilogue's 16-byte rows. Returns the
    output and how many times each element was written."""
    from repro_torch.kernels.matmul_w8a8 import matmul_w8a8 as mm

    M, K = a8.shape
    N = b8.shape[1]
    WM, WN = bm // 32, bn // 32
    bp = bn + 16
    a_u, b_u = a8.view(np.uint8), b8.view(np.uint8)
    out = np.full((M, N), np.nan, np.float32)
    writes = np.zeros((M, N), np.int64)
    lane = np.arange(32)
    gr, t4 = lane // 4, lane % 4
    for m0 in range(0, M, bm):
        for n0 in range(0, N, bn):
            acc = np.zeros((8, WM, WN, 32, 4), np.int64)
            for k0 in range(0, K, mm.BK):
                kv = min(mm.BK, K - k0)
                As = np.zeros(bm * 80, np.uint8)
                for r in range(min(bm, M - m0)):
                    As[r * 80:r * 80 + kv] = a_u[m0 + r, k0:k0 + kv]
                Bs = np.zeros(mm.BK * bp, np.uint8)
                nv = min(bn, N - n0)
                for r in range(kv):
                    s = _b_row(r) * bp
                    Bs[s:s + nv] = b_u[k0 + r, n0:n0 + nv]
                for warp in range(8):
                    wm, wn = warp >> 2, warp & 3
                    for ks in range(mm.BK // 32):
                        af = [_ldsm_x4(As, (wm * 16 * WM + i * 16
                                            + (lane & 15)) * 80 + ks * 32
                                       + (lane >> 4) * 16)
                              for i in range(WM)]
                        for jp in range(WN // 2):
                            r = _ldsm_x4(Bs, (ks * 32 + lane) * bp
                                         + wn * 8 * WN + jp * 16, trans=True)
                            b0e = _byte_perm(r[0], r[1], 0x6420)
                            b0o = _byte_perm(r[0], r[1], 0x7531)
                            b1e = _byte_perm(r[2], r[3], 0x6420)
                            b1o = _byte_perm(r[2], r[3], 0x7531)
                            for i in range(WM):
                                _mma_s8(acc[warp, i, 2 * jp], af[i], b0e,
                                        b1e)
                                _mma_s8(acc[warp, i, 2 * jp + 1], af[i],
                                        b0o, b1o)
            for warp in range(8):
                wm, wn = warp >> 2, warp & 3
                for i in range(WM):
                    for jp in range(WN // 2):
                        nc = n0 + wn * 8 * WN + jp * 16 + 4 * t4
                        for hh in range(2):
                            m = m0 + wm * 16 * WM + i * 16 + gr + 8 * hh
                            for c in range(4):
                                n = nc + c
                                ok = (m < M) & (n < N)
                                v = acc[warp, i, 2 * jp + (c & 1), :,
                                        2 * hh + (c >> 1)]
                                f = (v[ok].astype(np.float32) * sa[m[ok]]
                                     ) * sb[n[ok]]
                                out[m[ok], n[ok]] = f
                                np.add.at(writes, (m[ok], n[ok]), 1)
    return out, writes


@pytest.mark.parametrize("tile", [None, (128, 128), (64, 128), (32, 64)])
@pytest.mark.parametrize("M,K,N", [(33, 97, 203), (130, 96, 200),
                                   (8, 192, 256)])
def test_tensor_core_emulation_bit_equal(M, K, N, tile):
    """The tensor-core kernel's data path, emulated from the documented
    ldmatrix and m16n8k32 fragment layouts (B's rows staged in the
    permuted k order, ldmatrix .trans and the byte permutes into even and
    odd column tiles, the epilogue's 16-byte rows), equals the
    plain int32 product and its epilogue bit for bit, ragged M, N and K
    included (zero-filled, masked), and writes each output once."""
    from repro_torch.kernels.matmul_w8a8 import matmul_w8a8 as mm

    rng = np.random.default_rng(M * 7 + K + N)
    a8 = rng.integers(-127, 128, (M, K), dtype=np.int8)
    b8 = rng.integers(-127, 128, (K, N), dtype=np.int8)
    a8[0], b8[:, 0] = 127, -127
    sa = rng.uniform(1e-3, 1e-1, M).astype(np.float32)
    sb = rng.uniform(1e-3, 1e-1, N).astype(np.float32)
    plan = mm.launch_plan(M, N, tile)
    out, writes = _emulate_w8a8(a8, b8, sa, sb, plan.bm, plan.bn)
    ref = tref.matmul_w8a8(*(torch.from_numpy(x) for x in (a8, b8, sa, sb)))
    assert (writes == 1).all()
    assert np.array_equal(out, ref.numpy())


@pytest.mark.parametrize("M,N", [(1, 1), (8, 960), (8, 2560), (33, 203),
                                 (1024, 960), (1024, 2560), (4096, 128)])
def test_tile_plan_covers_the_output_once(M, N):
    """Every tile of the plan covers output elements no other tile covers
    and the tiles together cover (M, N); the shared memory mirrors the
    kernel's layout and fits; the default takes 128 x 128 tiles at the
    MLP up/gate shape (160 blocks), 64 x 128 at the down projection (128
    blocks), and the smallest where no tile reaches three quarters of
    the SMs."""
    from repro_torch.kernels.build import N_SM, SMEM_LIMIT
    from repro_torch.kernels.matmul_w8a8 import matmul_w8a8 as mm

    for tile in (None,) + mm.TILES:
        plan = mm.launch_plan(M, N, tile)
        gx, gy = plan.grid
        cover = np.zeros((M, N), np.int64)
        for by in range(gy):
            for bx in range(gx):
                cover[by * plan.bm:(by + 1) * plan.bm,
                      bx * plan.bn:(bx + 1) * plan.bn] += 1
        assert (cover == 1).all()
        assert (gx - 1) * plan.bn < N and (gy - 1) * plan.bm < M
        assert plan.smem_bytes == 4 * (plan.bm * 80 + 64 * (plan.bn + 16)
                                       ) <= SMEM_LIMIT
    default = mm.launch_plan(M, N)
    if (M, N) == (1024, 2560):
        assert (default.bm, default.bn) == (128, 128)
        assert default.grid == (20, 8)
    if (M, N) == (1024, 960):
        assert (default.bm, default.bn) == (64, 128)
    small = mm.launch_plan(M, N, mm.TILES[-1])
    assert mm.MIN_BLOCKS == 3 * N_SM // 4
    if small.grid[0] * small.grid[1] < mm.MIN_BLOCKS:
        assert (default.bm, default.bn) == mm.TILES[-1]
    with pytest.raises(ValueError):
        mm.launch_plan(M, N, (16, 16))

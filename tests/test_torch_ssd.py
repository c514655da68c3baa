"""The port's SSD scan (`repro_torch.kernels.ssd_scan`) against the
reference's on the same numpy inputs: the op on CPU tensors (the plain
versions) against the Pallas `ssd_pallas` in interpret mode and the exact
scan `ref.ssd`, on the reference test's four shapes, with an initial
state, without D, and at S <= 64 (the exact scan) and S > 64 (the chunked
form); `_pick_chunk` equal; the one-step decode against the reference's.

Tolerance: atol = rtol = 2e-4, the reference's own for its Pallas kernel
against the exact scan (float32; the chunked form sums in another order
than the sequential scan). The CUDA kernel itself is held against the
plain version on the card (`chip_smoke.py`)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import chunked as jchunked  # noqa: E402
from repro.kernels.ssd_scan import ops as jops  # noqa: E402
from repro.kernels.ssd_scan import ref as jref  # noqa: E402
from repro.kernels.ssd_scan.ssd_scan import ssd_pallas  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.ssd_scan import chunked as tchunked  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as tops  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as tref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as tks  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)


def _inputs(B, S, H, P, G, N, seed, init=False, with_D=True):
    """x, dt = softplus(normal), A = -exp(0.5 normal), B, C, D and an
    optional initial state, as the reference test draws them (from
    numpy here, so both frameworks see the same numbers)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((B, S, H, P)).astype(f)
    dt = np.logaddexp(rng.standard_normal((B, S, H)), 0).astype(f)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(f)
    Bm = rng.standard_normal((B, S, G, N)).astype(f)
    Cm = rng.standard_normal((B, S, G, N)).astype(f)
    D = rng.standard_normal(H).astype(f) if with_D else None
    h0 = ((rng.standard_normal((B, H, P, N)) * 0.1).astype(f) if init
          else None)
    return x, dt, A, Bm, Cm, D, h0


def _jax(arrs):
    return [None if a is None else jnp.asarray(a) for a in arrs]


def _torch(arrs):
    return [None if a is None else torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize(
    "B,S,H,P,G,N,Q",
    [
        (2, 256, 4, 16, 1, 32, 64),
        (1, 128, 4, 32, 2, 16, 32),
        (2, 128, 8, 16, 1, 64, 128),
        (1, 192, 2, 8, 1, 8, 64),    # non-pow2 S
    ],
)
def test_ssd_matches_pallas_sweep(B, S, H, P, G, N, Q):
    arrs = _inputs(B, S, H, P, G, N, seed=S + N + P)
    yp, hp = ssd_pallas(*_jax(arrs), Q, True)
    yr, hr = jref.ssd(*_jax(arrs))
    kernels.reset_counters()
    y, h = tops.ssd(*_torch(arrs), chunk=Q)
    assert kernels.REFERENCE_CALLS["ssd"] == 1
    assert kernels.LAUNCHES["ssd_scan"] == 0
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    for got, want in ((y, yp), (h, hp), (y, yr), (h, hr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("S", [1, 40, 64, 65, 100, 128])
@pytest.mark.parametrize("init,with_D", [(True, True), (False, False),
                                         (True, False)])
def test_ssd_state_and_skip_options(S, init, with_D):
    """An initial state and D=None, on both plain branches of the op:
    S <= 64 takes the exact scan, S > 64 the chunked form (S = 65 picks
    a chunk of 1, S = 100 one of 100), against the reference's op (its
    reference branch), its Pallas kernel and its exact scan."""
    arrs = _inputs(2, S, 4, 16, 2, 16, seed=7 * S, init=init,
                   with_D=with_D)
    jx = _jax(arrs)
    yo, ho = jops.ssd(*jx, impl="reference")
    yp, hp = ssd_pallas(*jx, 128, True)
    yr, hr = jref.ssd(*jx)
    y, h = tops.ssd(*_torch(arrs))
    for got, want in ((y, yo), (h, ho), (y, yp), (h, hp), (y, yr),
                      (h, hr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("S", [48, 64, 65, 96, 192])
def test_ssd_cpu_branch_follows_reference(S):
    """A CPU tensor takes the reference's own plain branch: the exact
    scan up to S = 64, the chunked form above, bit for bit with the
    port's plain functions; asking for the kernel on a CPU tensor
    raises, and so does the CUDA wrapper (no fallback)."""
    t = _torch(_inputs(1, S, 2, 8, 1, 8, seed=S, init=True))
    y, h = tops.ssd(*t)
    want = tref.ssd(*t) if S <= 64 else tchunked.ssd_chunked(*t)
    assert torch.equal(y, want[0]) and torch.equal(h, want[1])
    with pytest.raises(ValueError, match="CUDA"):
        tops.ssd(*t, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tks.ssd_cuda(*t)


def test_pick_chunk_matches_reference():
    for S in range(1, 400):
        for target in (1, 32, 64, 128, 256):
            assert tchunked._pick_chunk(S, target) == \
                jchunked._pick_chunk(S, target)


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("with_D", [True, False])
def test_ssd_decode_matches_reference(G, with_D):
    rng = np.random.default_rng(10 * G + with_D)
    f = np.float32
    B, H, P, N = 3, 4, 16, 8
    x = rng.standard_normal((B, H, P)).astype(f)
    dt = np.logaddexp(rng.standard_normal((B, H)), 0).astype(f)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(f)
    Bt = rng.standard_normal((B, G, N)).astype(f)
    Ct = rng.standard_normal((B, G, N)).astype(f)
    D = rng.standard_normal(H).astype(f) if with_D else None
    st = rng.standard_normal((B, H, P, N)).astype(f)
    arrs = (x, dt, A, Bt, Ct, D, st)
    jy, js = jops.ssd_decode(*_jax(arrs))
    y, s = tops.ssd_decode(*_torch(arrs))
    assert s.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)


def test_ssd_decode_continues_the_scan():
    """The final state of a scan over S tokens, stepped once by the
    decode recurrence, gives the scan over S + 1 tokens: y of the last
    token and the state (the contract the engine's prefill-then-decode
    relies on)."""
    x, dt, A, Bm, Cm, D, h0 = _torch(_inputs(2, 97, 4, 16, 1, 16, seed=3,
                                             init=True))
    _, h = tops.ssd(x[:, :96], dt[:, :96], A, Bm[:, :96], Cm[:, :96], D,
                    h0)
    y1, h1 = tops.ssd_decode(x[:, 96], dt[:, 96], A, Bm[:, 96], Cm[:, 96],
                             D, h)
    yf, hf = tops.ssd(x, dt, A, Bm, Cm, D, h0)
    np.testing.assert_allclose(y1.numpy(), yf[:, 96].numpy(), **TOL)
    np.testing.assert_allclose(h1.numpy(), hf.numpy(), **TOL)

"""The port's memory-bounded plain attention (`kernels/flash_attention/
chunked.py`) against the reference's `mha_chunked` on the same numpy
inputs, above 256 x 256 scores where `ops.mha`'s plain branch takes it:
the causal square (lower-triangle tiles), a causal chunk at kv_offset > 0,
non-causal, and GQA. float32, atol = rtol = 1e-5 (the same tiling; sums
taken by another library)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import chunked as jchunked  # noqa: E402
from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.kernels.flash_attention import chunked as tchunked  # noqa
from repro_torch.kernels.flash_attention import ops as tops  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
# name: (Sq, Skv, H, KV, D, causal, kv_offset, block)
CASES = {
    "causal_square_triangular_gqa": (384, 384, 6, 2, 20, True, 0, 64),
    "causal_offset_gqa": (128, 640, 4, 1, 16, True, 512, 64),
    "noncausal_rect": (320, 272, 2, 2, 16, False, 0, 64),
    "causal_square_inner": (384, 384, 3, 3, 16, True, 0, 128),
}


def _inputs(Sq, Skv, H, KV, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((2, Skv, KV, D)).astype(np.float32)
    v = rng.standard_normal((2, Skv, KV, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("case", sorted(CASES))
def test_mha_chunked_matches_reference(case):
    Sq, Skv, H, KV, D, causal, off, blk = CASES[case]
    q, k, v = _inputs(Sq, Skv, H, KV, D)
    want = jchunked.mha_chunked(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal, None, off, blk, blk)
    got = tchunked.mha_chunked(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal, None, off, blk,
                               blk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunked_lse_matches_reference(case):
    Sq, Skv, H, KV, D, causal, off, blk = CASES[case]
    q, k, v = _inputs(Sq, Skv, H, KV, D, seed=1)
    _, want = jchunked._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal, None, off, blk, blk)
    _, got = tchunked._fwd(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal, None, off, blk, blk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_triangular_path_is_taken_for_the_causal_square(monkeypatch):
    """The causal square with >= 4 query blocks visits only the lower
    triangle, as the reference does; the other cases run every tile."""
    taken = []
    tri, inner = tchunked._fwd_triangular, tchunked._fwd_inner
    monkeypatch.setattr(tchunked, "_fwd_triangular",
                        lambda *a: taken.append("tri") or tri(*a))
    monkeypatch.setattr(tchunked, "_fwd_inner",
                        lambda *a: taken.append("inner") or inner(*a))
    for case in ("causal_square_triangular_gqa", "causal_offset_gqa",
                 "causal_square_inner"):
        Sq, Skv, H, KV, D, causal, off, blk = CASES[case]
        q, k, v = (torch.from_numpy(x) for x in _inputs(Sq, Skv, H, KV, D))
        tchunked.mha_chunked(q, k, v, causal, None, off, blk, blk)
    assert taken == ["tri", "inner", "inner"]


@pytest.mark.parametrize("Sq,Skv,causal,off", [
    (320, 320, True, 0), (96, 704, True, 608), (272, 256, False, 0)])
def test_ops_mha_plain_branch_goes_chunked_above_256x256(monkeypatch, Sq,
                                                          Skv, causal, off):
    """`ops.mha` on CPU tensors: above 256 x 256 scores it runs
    `mha_chunked` (default blocks) and equals the reference's
    `ops.mha`, which routes the same way."""
    calls = []
    real = tchunked.mha_chunked
    monkeypatch.setattr(tchunked, "mha_chunked",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    q, k, v = _inputs(Sq, Skv, 4, 2, 16, seed=2)
    tk.reset_counters()
    got = tops.mha(torch.from_numpy(q), torch.from_numpy(k),
                   torch.from_numpy(v), causal=causal, kv_offset=off)
    want = jops.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, kv_offset=off, impl="reference")
    assert calls == [1] and tk.REFERENCE_CALLS["mha"] == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ops_mha_plain_branch_stays_dense_up_to_256x256(monkeypatch):
    calls = []
    monkeypatch.setattr(tchunked, "mha_chunked",
                        lambda *a, **kw: calls.append(1))
    q, k, v = (torch.from_numpy(x) for x in _inputs(256, 256, 2, 1, 16))
    out = tops.mha(q, k, v)
    assert calls == [] and out.shape == q.shape

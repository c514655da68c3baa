"""The port's kernel ops (plain versions, as CPU tensors dispatch them)
against the reference package's ops on the same numpy inputs: int8 page
quantization, the page writer, dense flash attention and paged decode
attention. The JAX side runs its Pallas kernels in interpret mode.

Tolerances: int8 payloads and the page writer exact; float results
atol=rtol=1e-5 (float32 throughout, sums taken in another order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import kernels as jk  # noqa: E402
from repro.kernels import quant as jquant  # noqa: E402
from repro.kernels.decode_attention import ops as jdops  # noqa: E402
from repro.kernels.flash_attention import ops as jfops  # noqa: E402
from repro.kernels.page_io import ops as jpops  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.kernels import quant as tquant  # noqa: E402
from repro_torch.kernels.decode_attention import ops as tdops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tfops  # noqa: E402
from repro_torch.kernels.page_io import ops as tpops  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach")
                      else x)


# --------------------------------------------------------------- quant
@pytest.mark.parametrize("page", [16, 64])
@pytest.mark.parametrize("case", ["random", "zeros", "outlier"])
def test_quantize_pages_matches_reference(page, case):
    rng = np.random.default_rng(page)
    x = rng.standard_normal((3, page, 2, 20)).astype(np.float32)
    if case == "zeros":
        x[1] = 0.0
    elif case == "outlier":
        x[2] = 0.01 * x[2]
        x[2, 3, 1, 7] = 50.0
    jq, jsz = jquant.quantize_pages(jnp.asarray(x))
    tq, tsz = tquant.quantize_pages(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(tq), np.asarray(jq))
    np.testing.assert_allclose(_np(tsz), np.asarray(jsz), rtol=1e-7)
    np.testing.assert_allclose(
        _np(tquant.dequantize_pages(tq, tsz)),
        np.asarray(jquant.dequantize_pages(jq, jsz)), **TOL)


@pytest.mark.parametrize("case", ["random", "zeros", "outlier"])
def test_quantize_tokens_matches_reference(case):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 16, 2, 16)).astype(np.float32)
    if case == "zeros":
        x[0, 3] = 0.0
    elif case == "outlier":
        x[1, 2, 0, 5] = -80.0
    jq, jsz = jquant.quantize_tokens(jnp.asarray(x))
    tq, tsz = tquant.quantize_tokens(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(tq), np.asarray(jq))
    np.testing.assert_allclose(_np(tsz), np.asarray(jsz), rtol=1e-7)


# ---------------------------------------------------------- page writer
@pytest.mark.parametrize("kind", ["int8", "sz"])
def test_write_pages_exact(kind):
    rng = np.random.default_rng(3)
    nb, P, n_wp = 2, 12, 4
    phys = rng.permutation(P)[:n_wp].astype(np.int32)
    if kind == "int8":
        pool = rng.integers(-127, 128, (nb, P, 16, 2, 20)).astype(np.int8)
        tiles = rng.integers(-127, 128, (nb, n_wp, 16, 2, 20)).astype(
            np.int8)
    else:
        pool = rng.standard_normal((nb, P, 2, 2)).astype(np.float32)
        tiles = rng.standard_normal((nb, n_wp, 2, 2)).astype(np.float32)
    ref = jpops.write_pages(jnp.asarray(pool), jnp.asarray(tiles),
                            jnp.asarray(phys), impl="interpret")
    tpool = torch.from_numpy(pool.copy())
    out = tpops.write_pages(tpool, torch.from_numpy(tiles),
                            torch.from_numpy(phys))
    assert out is tpool                     # written in place
    np.testing.assert_array_equal(_np(out), np.asarray(ref))


# ------------------------------------------------------ flash attention
@pytest.mark.parametrize("causal,kv_offset,Sq,Skv,H,KV,D", [
    (True, 0, 16, 16, 4, 2, 16),
    (True, 0, 24, 24, 3, 1, 20),
    (False, 0, 8, 24, 4, 4, 16),
    (True, 8, 8, 16, 4, 2, 16),
])
def test_mha_matches_reference(causal, kv_offset, Sq, Skv, H, KV, D):
    rng = np.random.default_rng(Sq * 31 + D)
    q = rng.standard_normal((2, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((2, Skv, KV, D)).astype(np.float32)
    v = rng.standard_normal((2, Skv, KV, D)).astype(np.float32)
    ref = jfops.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, kv_offset=kv_offset, impl="interpret")
    out = tfops.mha(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), causal=causal, kv_offset=kv_offset)
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)


# ------------------------------------------------- paged decode attention
def _paged_inputs(rng, *, page, n_pages, B, H, KV, D, pool, lengths):
    P = B * n_pages + 2
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    bt = np.stack([rng.permutation(P)[:n_pages]
                   for _ in range(B)]).astype(np.int32)
    # entries past each sequence's valid pages are dead (stale ids that
    # ops clamps to page 0)
    for b, n in enumerate(lengths):
        bt[b, -(-min(n, n_pages * page) // page):] = P - 1
    shape = (P, page, KV, D)
    if pool == "fp":
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        return q, k, v, bt, None, None
    k8 = rng.integers(-127, 128, shape).astype(np.int8)
    v8 = rng.integers(-127, 128, shape).astype(np.int8)
    sz_shape = (P, KV, 2) if pool == "int8_page" else (P, page, KV, 2)
    ksz = np.stack([rng.uniform(0.005, 0.02, sz_shape[:-1]),
                    rng.uniform(-0.5, 0.5, sz_shape[:-1])],
                   -1).astype(np.float32)
    vsz = np.stack([rng.uniform(0.005, 0.02, sz_shape[:-1]),
                    rng.uniform(-0.5, 0.5, sz_shape[:-1])],
                   -1).astype(np.float32)
    return q, k8, v8, bt, ksz, vsz


@pytest.mark.parametrize("pool", ["fp", "int8_page", "int8_token"])
@pytest.mark.parametrize("page,rep", [(16, 3), (64, 1)])
def test_paged_decode_matches_reference(pool, page, rep):
    """Lengths of 1, on a page boundary, full and parked (past the table:
    every table entry is read and the engine masks the result)."""
    rng = np.random.default_rng(page + rep)
    n_pages, KV, D = 3, 2, 20
    full = n_pages * page
    lengths = [1, page, full, full + 5]
    q, k, v, bt, ksz, vsz = _paged_inputs(
        rng, page=page, n_pages=n_pages, B=len(lengths), H=KV * rep, KV=KV,
        D=D, pool=pool, lengths=lengths)
    kw_j = {} if ksz is None else dict(k_sz=jnp.asarray(ksz),
                                       v_sz=jnp.asarray(vsz))
    kw_t = {} if ksz is None else dict(k_sz=torch.from_numpy(ksz),
                                       v_sz=torch.from_numpy(vsz))
    ln = np.asarray(lengths, np.int32)
    ref = jdops.paged_decode_mha(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(bt),
                                 jnp.asarray(ln), impl="interpret", **kw_j)
    out = tdops.paged_decode_mha(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(bt),
                                 torch.from_numpy(ln), **kw_t)
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)


def test_clamp_dead_entries_matches_reference():
    bt = np.arange(12, dtype=np.int32).reshape(3, 4) + 1
    frontier = np.array([1, 16, 70], np.int32)
    ref = jdops.clamp_dead_entries(jnp.asarray(bt), 4, 16,
                                   jnp.asarray(frontier))
    out = tdops.clamp_dead_entries(torch.from_numpy(bt), 4, 16,
                                   torch.from_numpy(frontier))
    np.testing.assert_array_equal(_np(out), np.asarray(ref))


# --------------------------------------------------------------- dispatch
def test_dispatch_by_device_and_no_kernel_on_cpu():
    x = torch.zeros(2)
    assert tk.select_impl(x) == "reference"
    with pytest.raises(ValueError):
        tk.select_impl(x, "cuda")          # no kernel for a CPU tensor
    with pytest.raises(ValueError):
        tk.force_backend("pallas")
    tk.force_backend("reference")
    try:
        assert tk.select_impl(x) == "reference"
    finally:
        tk.force_backend(None)
    # the reference package's own dispatch is untouched by the port
    assert jk.select_impl("reference") == ("reference", False)


def test_reference_calls_counted_not_launches():
    tk.reset_counters()
    pool = torch.zeros(1, 4, 3)
    tpops.write_pages(pool, torch.ones(1, 1, 3),
                      torch.tensor([2], dtype=torch.int32))
    assert tk.REFERENCE_CALLS["write_pages"] == 1
    assert sum(tk.LAUNCHES.values()) == 0
    assert pool[0, 2].tolist() == [1.0, 1.0, 1.0]

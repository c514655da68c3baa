"""The port's paged chunked-prefill ops (plain versions, as CPU tensors
dispatch them) and the chunk path of its model against the reference
package on the same numpy inputs and weights. The JAX side runs its
Pallas kernels in interpret mode.

Tolerances: attention outputs atol=rtol=1e-5 for the ops and 1e-4
through the model (float32, sums taken in another order); the pools and
(scale, zero) rows the ops write are compared exactly; through the model
the written fp pools and (scale, zero) rows to 1e-5 and the int8 payloads
exactly."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.common.parallel import ParallelCtx  # noqa: E402
from repro.kernels.flash_attention import ops as jfops  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tfops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.module import layer_slice  # noqa: E402
from repro_torch.models.module import load_numpy_params  # noqa: E402

CTX = ParallelCtx(remat="none")
TOL = dict(atol=1e-5, rtol=1e-5)
B, C, PAGE, N_PAGES, KV, D = 2, 16, 8, 6, 2, 20
C0S = {"mixed": [0, 32], "deep": [32, 16]}


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else \
        np.asarray(x)


def _sz(rng, shape):
    return np.stack([rng.uniform(0.005, 0.02, shape),
                     rng.uniform(-0.5, 0.5, shape)], -1).astype(np.float32)


def _inputs(rng, rep, c0, pool):
    """Chunk queries, a pool with pages scattered through unique table
    entries, and garbage ids above each row's causal frontier."""
    H = KV * rep
    P = B * N_PAGES + 3
    q = rng.standard_normal((B, C, H, D)).astype(np.float32)
    bt = rng.permutation(P)[:B * N_PAGES].reshape(B, N_PAGES).astype(
        np.int32)
    c0 = np.asarray(c0, np.int32)
    dead = np.arange(N_PAGES)[None, :] * PAGE >= (c0 + C)[:, None]
    bt[dead] = P + 1000
    shape = (P, PAGE, KV, D)
    if pool == "fp":
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        return q, k, v, bt, c0, None, None
    k = rng.integers(-127, 128, shape).astype(np.int8)
    v = rng.integers(-127, 128, shape).astype(np.int8)
    sz_shape = (P, KV) if pool == "page" else (P, PAGE, KV)
    return q, k, v, bt, c0, _sz(rng, sz_shape), _sz(rng, sz_shape)


def _t(*xs):
    return [None if x is None else torch.from_numpy(x.copy()) for x in xs]


def _j(*xs):
    return [None if x is None else jnp.asarray(x) for x in xs]


# ------------------------------------------------------------------- ops
@pytest.mark.parametrize("c0", list(C0S))
@pytest.mark.parametrize("rep", [1, 3])
@pytest.mark.parametrize("pool", ["fp", "page", "token"])
def test_paged_prefill_mha_matches_reference(pool, rep, c0):
    """Gather-only chunk attention, sz none / per page / per token."""
    rng = np.random.default_rng(rep * 7 + len(c0) + len(pool))
    q, k, v, bt, c0v, ksz, vsz = _inputs(rng, rep, C0S[c0], pool)
    jq, jk, jv, jbt, jc0, jksz, jvsz = _j(q, k, v, bt, c0v, ksz, vsz)
    ref = jfops.paged_prefill_mha(jq, jk, jv, jbt, jc0, k_sz=jksz,
                                  v_sz=jvsz, impl="interpret")
    tq, tk_, tv, tbt, tc0, tksz, tvsz = _t(q, k, v, bt, c0v, ksz, vsz)
    tk.reset_counters()
    out = tfops.paged_prefill_mha(tq, tk_, tv, tbt, tc0, k_sz=tksz,
                                  v_sz=tvsz)
    assert tk.REFERENCE_CALLS["paged_prefill_mha"] == 1
    assert sum(tk.LAUNCHES.values()) == 0
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)


@pytest.mark.parametrize("c0", list(C0S))
@pytest.mark.parametrize("rep", [1, 3])
@pytest.mark.parametrize("quantized", [False, True])
def test_paged_prefill_insert_matches_reference(quantized, rep, c0):
    """The fused insert+attend ops: same output, and the pools (and int8
    (scale, zero) rows) they write in place equal the reference's
    exactly."""
    rng = np.random.default_rng(rep * 11 + len(c0) + quantized)
    q, k, v, bt, c0v, ksz, vsz = _inputs(rng, rep, C0S[c0],
                                         "page" if quantized else "fp")
    n_wp = C // PAGE
    if quantized:
        kn = rng.integers(-127, 128, (B, C, KV, D)).astype(np.int8)
        vn = rng.integers(-127, 128, (B, C, KV, D)).astype(np.int8)
        kszn, vszn = _sz(rng, (B, n_wp, KV)), _sz(rng, (B, n_wp, KV))
        jargs = _j(q, k, v, ksz, vsz, kn, vn, kszn, vszn, bt, c0v)
        ref = jfops.paged_prefill_insert_mha_q8(*jargs, impl="interpret")
        targs = _t(q, k, v, ksz, vsz, kn, vn, kszn, vszn, bt, c0v)
        out = tfops.paged_prefill_insert_mha_q8(*targs)
        pools = targs[1:5]
    else:
        kn = rng.standard_normal((B, C, KV, D)).astype(np.float32)
        vn = rng.standard_normal((B, C, KV, D)).astype(np.float32)
        jargs = _j(q, k, v, kn, vn, bt, c0v)
        ref = jfops.paged_prefill_insert_mha(*jargs, impl="interpret")
        targs = _t(q, k, v, kn, vn, bt, c0v)
        out = tfops.paged_prefill_insert_mha(*targs)
        pools = targs[1:3]
    np.testing.assert_allclose(_np(out[0]), np.asarray(ref[0]), **TOL)
    for i, pool in enumerate(pools):
        assert out[1 + i] is pool                  # written in place
        np.testing.assert_array_equal(_np(pool), np.asarray(ref[1 + i]))


# ----------------------------------------------------------------- model
N_SLOTS, MAX_SEQ, MPAGE = 2, 48, 8
POOLS = {"fp": ("fp", "page"), "int8": ("int8", "page"),
         "int8_token": ("int8", "token")}


def _model(pool):
    jc = dataclasses.replace(jconfigs.reduced("smollm_360m"),
                             dtype="float32")
    tc = dataclasses.replace(tconfigs.reduced("smollm_360m"),
                             dtype="float32")
    jp, _ = JM.init_model(jc, jax.random.PRNGKey(0))
    tp = load_numpy_params(jax.tree.map(np.asarray, jp), device="cpu")
    pool_dtype, gran = POOLS[pool]
    jcaches = JM.make_paged_decode_caches(jc, N_SLOTS, MAX_SEQ, MPAGE,
                                          pool_dtype=pool_dtype,
                                          sz_granularity=gran)
    tcaches = TM.make_paged_decode_caches(tc, N_SLOTS, MAX_SEQ, MPAGE,
                                          pool_dtype=pool_dtype,
                                          sz_granularity=gran, device="cpu")
    return jc, tc, jp, tp, jcaches, tcaches


def _assert_caches(tcaches, jcaches, pool):
    """fp pools and (scale, zero) rows to 1e-5 (each framework computes
    its own float32 K/V through the layer), int8 payloads equal."""
    for key, j in jcaches["pos0"].items():
        a, b = _np(tcaches["pos0"][key]), np.asarray(j)
        if pool != "fp" and key in ("k", "v"):
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("pool", list(POOLS))
def test_paged_prefill_chunk_attention_matches_reference(pool):
    """One layer's chunk attention at a deep chunk start, over a pool
    filled with earlier tokens' K/V, on the same weights."""
    jc, tc, jp, tp, jcaches, tcaches = _model(pool)
    rng = np.random.default_rng(len(pool))
    n_pages = MAX_SEQ // MPAGE
    row = rng.permutation(N_SLOTS * n_pages)[:n_pages].astype(np.int32)[
        None]
    jcache = {k: v[0] for k, v in jcaches["pos0"].items()}
    tcache = layer_slice(tcaches["pos0"], 0)
    for key in jcache:                   # earlier chunks: seeded values
        shape = jcache[key].shape
        if key in ("k", "v") and pool != "fp":
            val = rng.integers(-127, 128, shape).astype(np.int8)
        elif key.endswith("_sz"):
            val = _sz(rng, shape[:-1])
        else:
            val = rng.standard_normal(shape).astype(np.float32)
        jcache[key] = jnp.asarray(val)
        tcache[key].copy_(torch.from_numpy(val))
    x = rng.standard_normal((1, C, jc.d_model)).astype(np.float32)
    c0 = 32
    jpa = jax.tree.map(lambda a: a[0], jp["blocks"]["pos0"]["attn"])
    tpa = layer_slice(tp["blocks"]["pos0"]["attn"], 0)
    jout, jupd = jattn.paged_prefill_chunk_attention(
        jpa, jnp.asarray(x), jc, jcache, c0, jnp.asarray(row), MPAGE)
    tout, tupd = tattn.paged_prefill_chunk_attention(
        tpa, torch.from_numpy(x), tc, tcache, torch.tensor(c0),
        torch.from_numpy(row), MPAGE)
    assert tupd is tcache
    np.testing.assert_allclose(_np(tout), np.asarray(jout), atol=1e-4,
                               rtol=1e-4)
    _assert_caches({"pos0": tcache}, {"pos0": {**jcache, **jupd}}, pool)


@pytest.mark.parametrize("pool", list(POOLS))
def test_prefill_chunk_walk_matches_reference(pool):
    """`prefill_chunk` over a 48-token prompt in chunks of 16 through a
    scattered block row: last-token logits per chunk and the written
    pools equal the reference's."""
    jc, tc, jp, tp, jcaches, tcaches = _model(pool)
    rng = np.random.default_rng(3)
    n_pages = MAX_SEQ // MPAGE
    row = rng.permutation(N_SLOTS * n_pages)[:n_pages].astype(np.int32)[
        None]
    toks = rng.integers(0, jc.vocab_size, (1, MAX_SEQ)).astype(np.int32)
    tk.reset_counters()
    for i in range(MAX_SEQ // C):
        chunk = toks[:, i * C:(i + 1) * C]
        jlog, jcaches = JM.prefill_chunk(jp, jnp.asarray(chunk), jcaches, i,
                                         jc, CTX, jnp.asarray(row), MPAGE)
        tlog, tcaches = TM.prefill_chunk(tp, torch.from_numpy(chunk),
                                         tcaches, i, tc,
                                         torch.from_numpy(row), MPAGE)
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), atol=1e-4,
                                   rtol=1e-4)
    _assert_caches(tcaches, jcaches, pool)
    layers = tc.num_layers * (MAX_SEQ // C)
    name = {"fp": "paged_prefill_insert_mha",
            "int8": "paged_prefill_insert_mha_q8",
            "int8_token": "paged_prefill_mha"}[pool]
    assert tk.REFERENCE_CALLS[name] == layers
    assert sum(tk.LAUNCHES.values()) == 0


# ------------------------------------------------------ launch plan
@pytest.mark.parametrize("page", [16, 64])
@pytest.mark.parametrize("rep", [1, 3, 8, 16])
@pytest.mark.parametrize("D", [16, 20, 64, 112, 128, 256])
def test_launch_plan_fits_and_covers_every_row(D, rep, page):
    """The CUDA kernels' launch geometry (`paged_prefill.launch_plan`, and
    the 32-row plan the timing script launches), checked here because a
    refused launch shows only on the card: every
    plan fits a block's 227 KB of shared memory and 1024 threads; every
    (query position, head) row of a chunk is computed by exactly one
    block (one row slot per warp lane pair, within the block's slots);
    the key splits partition each block's key tiles, and each split's
    pages fit the block-table slice it stages."""
    from collections import Counter

    from repro_torch.kernels.flash_attention import paged_prefill as pp

    B, KV = 2, 2
    H = KV * rep
    for q_dt, kv_dt in ((torch.bfloat16, torch.bfloat16),
                        (torch.bfloat16, torch.int8),
                        (torch.float32, torch.float32),
                        (torch.float32, torch.int8)):
        for rows in ((None, 32) if q_dt == torch.bfloat16 else (None,)):
            for C, n_pages in ((1, 3), (5, 40), (page, 9), (128, 544 // page
                               + 2), (128, 32768 // page)):
                plan = (pp._mma_plan(B, C, H, KV, D, page, n_pages, kv_dt,
                                     rows=rows) if rows else
                        pp.launch_plan(B, C, H, KV, D, page, n_pages, q_dt,
                                       kv_dt))
                assert rows or plan.rows == (pp.ROWS if plan.tensor_core
                                             else 16)
                assert plan.tensor_core == (q_dt == torch.bfloat16)
                assert plan.smem_bytes <= pp.SMEM_LIMIT, plan
                assert plan.threads <= 1024 and plan.threads % 32 == 0
                assert plan.bq >= 1 and plan.bq * rep <= plan.rows
                assert plan.grid[1] == KV
                assert plan.grid[2] == B * plan.n_split <= 65535
                covered = Counter()
                for x in range(plan.grid[0]):
                    for qi in range(x * plan.bq, min(x * plan.bq + plan.bq,
                                                     C)):
                        for h in range(rep):
                            covered[qi, h] += 1
                assert len(covered) == C * rep
                assert set(covered.values()) == {1}
                # the kernel's split of a block's key tiles (its causal
                # frontier k_end <= n_pages * page) over n_split blocks
                top = n_pages * page
                for k_end in {k for k in (1, 64, 65, top // 2, top)
                              if k <= top}:
                    n_tiles = -(-k_end // pp.KEY_TILE)
                    tiles = []
                    for s in range(plan.n_split):
                        lo = s * n_tiles // plan.n_split
                        hi = (s + 1) * n_tiles // plan.n_split
                        tiles += range(lo, hi)
                        if hi > lo and plan.tensor_core:
                            pg_lo = lo * pp.KEY_TILE // page
                            pg_hi = (min(hi * pp.KEY_TILE, k_end) - 1) // page
                            assert pg_hi - pg_lo + 1 <= plan.n_tab
                    assert tiles == list(range(n_tiles))

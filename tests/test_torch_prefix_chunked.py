"""The port's chunked prefill and shared-prefix cache end to end on the
CPU: against its own serialized engine, prefix cache on against off, and
against the reference engine on the same seeded trace and weights
(reduced smollm, float32, page 8, chunk 8/16, substrate off, the port
priced with the reference's topology and chip numbers).

Gates (mirroring the reference's own serving tests): fp pools give
identical tokens; int8 pools keep per-request agreement >=
INT8_TOKEN_AGREEMENT; virtual metrics and prefix counters equal the
reference's to rel=1e-9; pager invariants hold after every run."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.common import hw as jhw  # noqa: E402
from repro.common.parallel import ParallelCtx  # noqa: E402
from repro.core import tiers as jtiers  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro.serving import make_scenario as jmake_scenario  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.common import hw as thw  # noqa: E402
from repro_torch.core import tiers as ttiers  # noqa: E402
from repro_torch.models.module import load_numpy_params  # noqa: E402
from repro_torch.serving import INT8_TOKEN_AGREEMENT  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    EngineConfig,
    PrefixCache,
    Request,
    ServingEngine,
    make_scenario,
)

CTX = ParallelCtx(remat="none")


def _ref_topology():
    jt = jtiers.v5e_topology()
    return ttiers.TierTopology(
        tiers=tuple(ttiers.TierSpec(**dataclasses.asdict(t))
                    for t in jt.tiers),
        shared_link_bw=jt.shared_link_bw,
        chips_per_pool=jt.chips_per_pool,
    )


def _ref_chip():
    c = jhw.V5E
    return thw.ChipSpec(name=c.name, peak_flops_bf16=c.peak_flops_bf16,
                        hbm_bytes=c.hbm_bytes, hbm_bw=c.hbm_bw,
                        link_bw=c.ici_link_bw, num_sms=0, smem_per_block=0,
                        l2_bytes=0.0)


def _cfg():
    return dataclasses.replace(tconfigs.reduced("smollm_360m"),
                               dtype="float32")


def _build(ecfg, params=None):
    return ServingEngine.build(_cfg(), ecfg, params=params, device="cpu",
                               topo=_ref_topology(), chip=_ref_chip())


def _agreement(a, b):
    n = min(len(a), len(b))
    return sum(x == y for x, y in zip(a[:n], b[:n])) / max(n, 1)


def _pager_invariants(p):
    """Free list, block table and refcounts consistent (mappings may
    alias: distinct live pages replace unique owners)."""
    owned = p.phys[p.valid]
    assert (owned >= 0).all()
    assert (p.ref >= 0).all()
    live = np.nonzero(p.ref > 0)[0]
    free = set(p._free_phys)
    assert len(free) == len(p._free_phys)
    assert free.isdisjoint(live.tolist())
    assert len(free) + len(live) == p.n_phys
    assert int(p.ref.sum()) == int(p.valid.sum()) + p.pins
    ids, counts = np.unique(owned, return_counts=True)
    assert (p.ref[ids] >= counts).all()
    bt = p.block_table()
    assert (bt[~p.valid] == 0).all()
    assert (bt[p.valid] == owned).all()
    used = p.local_bytes_used() + p.pool_bytes_used()
    assert used == pytest.approx(len(live) * p.page_bytes)


# --------------------------------------------------- chunked vs serialized
def test_engine_chunked_prefill_matches_serialized():
    """Chunked prefill is invisible to the sampled tokens on fp pools and
    lands its admissions in smaller inter-decode-step gaps."""
    out = {}
    for chunk in (None, 8):
        ecfg = EngineConfig(
            n_slots=2, max_seq=48, prefill_buckets=(32,), page_tokens=8,
            hot_window=8, local_budget_frac=0.5, admission="greedy",
            pool_dtype="fp", prefill_chunk=chunk,
        )
        eng = _build(ecfg)
        reqs = make_scenario("chat", 6, eng.cfg.vocab_size, seed=11,
                             prompt_buckets=(32,), gen_range=(4, 10),
                             arrival_rate=3e4)
        tk.reset_counters()
        stats = eng.run(reqs)
        assert (tk.REFERENCE_CALLS["paged_prefill_insert_mha"] > 0) == \
            bool(chunk)
        out[chunk] = (stats, [list(r.output) for r in reqs])
        _pager_invariants(eng.pager)
    (serial, serial_toks), (chunked, chunked_toks) = out[None], out[8]
    assert serial_toks == chunked_toks
    assert chunked.decode_stall.max() < serial.decode_stall.max()


# ------------------------------------------------------- prefix on vs off
def _shared_run(prefix_cache, *, pool_dtype="fp", prefill_chunk=None,
                n=8, seed=3):
    ecfg = EngineConfig(
        n_slots=4, max_seq=64, prefill_buckets=(32,), page_tokens=8,
        hot_window=16, local_budget_frac=0.5, admission="greedy",
        pool_dtype=pool_dtype, prefill_chunk=prefill_chunk,
        prefix_cache=prefix_cache,
    )
    eng = _build(ecfg)
    reqs = make_scenario("shared_prefix", n, eng.cfg.vocab_size, seed=seed,
                         system_tokens=24, prompt_buckets=(32,),
                         gen_range=(6, 12), arrival_rate=3e4)
    stats = eng.run(reqs)
    return eng, stats, [list(r.output) for r in reqs]


@pytest.mark.parametrize("chunk", [None, 16])
def test_engine_prefix_cache_parity_and_dedup(chunk):
    """fp pools: prefix cache ON vs OFF gives identical tokens while the
    trie dedups; the chunked path skips shared chunks, so ON spends no
    more virtual time than OFF."""
    _, stats_off, toks_off = _shared_run(False, prefill_chunk=chunk)
    eng_on, stats_on, toks_on = _shared_run(True, prefill_chunk=chunk)
    assert toks_on == toks_off
    assert stats_on.prefix["hits"] >= 6           # every re-arrival hits
    assert stats_on.prefix["hit_rate"] > 0.5
    assert stats_on.pager["shared_mapped_pages"] > 0
    assert stats_on.summary()["prefix_hit_rate"] == \
        stats_on.prefix["hit_rate"]
    assert stats_on.virtual_s <= stats_off.virtual_s + 1e-12
    assert not stats_off.prefix
    _pager_invariants(eng_on.pager)


@pytest.mark.parametrize("chunk", [None, 16])
def test_engine_prefix_cache_int8_token_agreement(chunk):
    """int8 pools share the (scale, zero) rows with the payload: ON vs OFF
    streams stay within the int8 agreement bar."""
    _, _, toks_off = _shared_run(False, pool_dtype="int8",
                                 prefill_chunk=chunk)
    eng, stats_on, toks_on = _shared_run(True, pool_dtype="int8",
                                         prefill_chunk=chunk)
    assert stats_on.prefix["hits"] > 0
    for on, off in zip(toks_on, toks_off):
        assert _agreement(on, off) >= INT8_TOKEN_AGREEMENT
    _pager_invariants(eng.pager)


def test_engine_cow_splits_shared_tail_page():
    """Two identical prompts whose bucket leaves a partial tail page: the
    second admission maps the donor's pages INCLUDING the partial tail,
    so each slot's first decode write COW-splits off the shared page
    through the copy cell — and the tokens still match the no-cache
    run."""
    out = {}
    for on in (False, True):
        ecfg = EngineConfig(
            n_slots=2, max_seq=24, prefill_buckets=(12,), page_tokens=8,
            hot_window=8, local_budget_frac=None, admission="greedy",
            pool_dtype="fp", prefix_cache=on,
        )
        eng = _build(ecfg)
        rng = np.random.default_rng(5)
        prompt = rng.integers(0, eng.cfg.vocab_size, 12).astype(np.int32)
        reqs = [Request(request_id=i, tokens=prompt.copy(),
                        max_new_tokens=6, arrival=0.0) for i in range(2)]
        eng.run(reqs)
        out[on] = (eng, [list(r.output) for r in reqs])
    eng_on, toks_on = out[True]
    assert toks_on == out[False][1]
    assert eng_on.pager.cow_splits >= 2
    _pager_invariants(eng_on.pager)


def test_prefix_cache_reclaim_under_free_list_pressure():
    """The pager's allocator reclaims trie-only pages (LRU leaves) before
    declaring the pool exhausted."""
    from repro_torch.serving import KVPager, PagerConfig

    p = KVPager(2, 32, 4.0, 0.0, PagerConfig(page_tokens=8, policy="none"))
    pc = PrefixCache(8)
    p.prefix_cache = pc
    toks = np.arange(32, dtype=np.int32)
    p.admit(0, 32)
    pc.insert(toks, p.phys[0], p, include_partial=False)
    p.release(0)                        # trie pins keep 4 pages alive
    assert pc.cached_pages == 4 and p.counters()["free_pages"] == 4
    p.admit(0, 32)
    p.admit(1, 32)                      # needs 4 more: the trie gives back
    assert pc.evicted_pages == 4 and pc.cached_pages == 0
    _pager_invariants(p)


# ---------------------------------------------- the port vs the reference
@pytest.mark.parametrize("chunk,pool_dtype", [(16, "fp"), (16, "int8"),
                                              (None, "fp")])
def test_engine_chunked_prefix_matches_reference(chunk, pool_dtype):
    """The port's chunked + prefix engine against the JAX engine on the
    same trace and weights: fp tokens identical (int8 within the
    agreement bar), virtual metrics, pager deltas and prefix counters
    equal to rel=1e-9."""
    jc = dataclasses.replace(jconfigs.reduced("smollm_360m"),
                             dtype="float32")
    jparams, _ = JM.init_model(jc, jax.random.PRNGKey(0))
    tparams = load_numpy_params(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    kw = dict(n_slots=4, max_seq=64, prefill_buckets=(32,), page_tokens=8,
              hot_window=16, local_budget_frac=0.5, admission="greedy",
              pool_dtype=pool_dtype, prefill_chunk=chunk, prefix_cache=True)
    trace = dict(n=8, vocab=jc.vocab_size, seed=3, system_tokens=24,
                 prompt_buckets=(32,), gen_range=(6, 12), arrival_rate=3e4)
    jeng = JServingEngine.build(jc, CTX, JEngineConfig(substrate="off",
                                                       **kw),
                                params=jparams)
    teng = _build(EngineConfig(substrate="off", **kw), params=tparams)
    jreqs = jmake_scenario("shared_prefix", **trace)
    treqs = make_scenario("shared_prefix", **trace)
    js, ts = jeng.run(jreqs), teng.run(treqs)
    for jr, tr_ in zip(jreqs, treqs):
        assert len(tr_.output) == tr_.max_new_tokens
        if pool_dtype == "fp":
            assert tr_.output == jr.output, jr.request_id
        else:
            assert _agreement(tr_.output, jr.output) >= INT8_TOKEN_AGREEMENT
    jsum, tsum = js.summary(), ts.summary()
    jsum.pop("tok_per_s_wall"), tsum.pop("tok_per_s_wall")
    assert tsum == pytest.approx(jsum, rel=1e-9)
    assert ts.pager == pytest.approx(js.pager, rel=1e-9)
    assert ts.prefix == pytest.approx(js.prefix, rel=1e-9)
    assert ts.prefix["hits"] >= 6
    np.testing.assert_allclose(ts.decode_stall, js.decode_stall, rtol=1e-9)


# ----------------------------------------------------------- validation
@pytest.mark.parametrize("override,match,err", [
    (dict(paged=False, pool_dtype="fp", prefill_chunk=8), "paged",
     ValueError),
    (dict(paged=False, pool_dtype="fp", prefix_cache=True), "paged",
     ValueError),
    (dict(page_tokens=8, prefill_chunk=4), "multiple", ValueError),
    (dict(page_tokens=8, prefill_buckets=(8, 24), prefill_chunk=16),
     "divide every prompt bucket", ValueError),
])
def test_chunked_and_prefix_config_validation(override, match, err):
    """The reference's configuration errors (tests/test_serving.py), for
    the archs the port has."""
    ecfg = EngineConfig(**{**dict(n_slots=2, max_seq=32,
                                  prefill_buckets=(8,)), **override})
    with pytest.raises(err, match=match):
        _build(ecfg)


def test_chunked_prompt_must_be_whole_chunks():
    eng = _build(EngineConfig(n_slots=2, max_seq=48, prefill_buckets=(16,),
                              page_tokens=8, prefill_chunk=16,
                              pool_dtype="fp"))
    req = Request(request_id=0, tokens=np.arange(12, dtype=np.int32),
                  max_new_tokens=2, arrival=0.0)
    with pytest.raises(ValueError, match="multiple of prefill_chunk 16"):
        eng.run([req])

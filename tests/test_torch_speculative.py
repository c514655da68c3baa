"""The port's speculative decoding on the CPU: the proposer and the
acceptance rule against the reference's, the verify cell against the
reference's, the speculative engine against the port's own greedy engine
and against the reference engine, and the reference's validation errors.
Reduced smollm, float32, fp pools unless named, substrate off, the port
priced with the reference's topology and chip numbers.

Gates (the reference's own): ngram proposals and acceptance identical;
verify picks identical and caches equal to 1e-5; speculative tokens equal
greedy's bit for bit on fp pools, and the reference engine's; `spec`
counters (verify steps, emitted, draft calls, acceptance) equal the
reference engine's with its draft weights loaded; int8 pools switch to
per-token sub-scales and keep agreement >= INT8_TOKEN_AGREEMENT; the
pager drains clean."""

import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.common import hw as jhw  # noqa: E402
from repro.common.parallel import ParallelCtx  # noqa: E402
from repro.core import tiers as jtiers  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.runtime import serve as jserve  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro.serving import accept_greedy as jaccept  # noqa: E402
from repro.serving import ngram_propose as jngram  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.common import hw as thw  # noqa: E402
from repro_torch.core import tiers as ttiers  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.module import load_numpy_params  # noqa: E402
from repro_torch.runtime import serve as tserve  # noqa: E402
from repro_torch.serving import INT8_TOKEN_AGREEMENT  # noqa: E402
from repro_torch.serving import EngineConfig  # noqa: E402
from repro_torch.serving import Request  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.serving import accept_greedy, ngram_propose  # noqa: E402

CTX = ParallelCtx(remat="none")
_SCRIPT = (pathlib.Path(__file__).resolve().parents[1] / "scripts"
           / "dev_serve_torch.py")
B, S, GEN, PAGE = 2, 8, 12, 4


def _dev_serve():
    spec = importlib.util.spec_from_file_location("dev_serve_torch", _SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cfgs():
    jc = dataclasses.replace(jconfigs.reduced("smollm_360m"),
                             dtype="float32")
    tc = dataclasses.replace(tconfigs.reduced("smollm_360m"),
                             dtype="float32")
    return jc, tc


def _jax_params(jc):
    jparams, _ = JM.init_model(jc, jax.random.PRNGKey(0))
    return jparams


def _to_torch(tree):
    return load_numpy_params(jax.tree.map(np.asarray, tree), device="cpu")


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


def _base(**kw):
    d = dict(n_slots=B, max_seq=S + GEN, prefill_buckets=(S,),
             page_tokens=PAGE, hot_window=8, local_budget_frac=0.5,
             admission="greedy", paged=True, pool_dtype="fp")
    d.update(kw)
    return d


def _prompts(vocab, seed=6):
    return np.random.default_rng(seed).integers(0, vocab, (B, S))


# ------------------------------------------------- proposer and ladder
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ngram_propose_matches_reference(seed):
    """Seeded histories with repeats (small vocab) and without, every
    draft count 1..5 and n-gram cap 1..4: identical proposals."""
    rng = np.random.default_rng(seed)
    for _ in range(25):
        vocab = int(rng.choice([3, 8, 1000]))
        hist = rng.integers(0, vocab, int(rng.integers(0, 30)))
        n_draft = int(rng.integers(0, 6))
        max_ngram = int(rng.integers(1, 5))
        np.testing.assert_array_equal(
            ngram_propose(hist, n_draft, max_ngram),
            jngram(hist, n_draft, max_ngram))


@pytest.mark.parametrize("seed", [0, 1])
def test_accept_greedy_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        k = int(rng.integers(2, 6))
        greedy = rng.integers(0, 4, k)
        cand = np.concatenate([[7], np.where(rng.random(k - 1) < 0.7,
                                             greedy[:-1], 9)])
        assert accept_greedy(cand, greedy) == jaccept(cand, greedy)


# ------------------------------------------------------- verify cell
@pytest.mark.parametrize("pool", ["fp", "int8"])
def test_verify_cell_matches_reference(pool):
    """S*k flattened rows through the paged decode: the greedy picks for
    every candidate position and the written pool equal the reference's
    cell on the same pool, candidates and block table (int8: per-token
    sub-scales)."""
    jc, tc = _cfgs()
    jparams = _jax_params(jc)
    tparams = _to_torch(jparams)
    k, n_slots, maxs = 4, 2, 24
    gran = "token" if pool == "int8" else "page"
    jcells_caches = JM.make_paged_decode_caches(
        jc, n_slots, maxs, PAGE, pool_dtype=pool, sz_granularity=gran)
    rng = np.random.default_rng(11)
    n_pages = maxs // PAGE
    bt = rng.permutation(n_slots * n_pages).reshape(n_slots, n_pages)
    bt = bt.astype(np.int32)
    # fill the pool with a prefilled prompt's K/V
    jcaches = {}
    for pos, c in jcells_caches.items():
        jcaches[pos] = {}
        for key, leaf in c.items():
            if leaf.dtype == jnp.int8:
                arr = rng.integers(-127, 128, leaf.shape).astype(np.int8)
            elif key.endswith("_sz"):
                arr = np.stack([0.01 + 0.01 * rng.random(leaf.shape[:-1]),
                                rng.random(leaf.shape[:-1]) - 0.5],
                               -1).astype(np.float32)
            else:
                arr = rng.standard_normal(leaf.shape).astype(np.float32)
            jcaches[pos][key] = jnp.asarray(arr)
    tcaches = {pos: {key: torch.from_numpy(np.array(v))
                     for key, v in c.items()} for pos, c in jcaches.items()}
    cand = rng.integers(0, jc.vocab_size, (n_slots, k)).astype(np.int32)
    t = np.array([5, 9], np.int32)
    jcell = jserve.build_decode_verify_paged(jc, CTX, PAGE, k)
    jg, jf, jout = jcell(jparams, jnp.asarray(cand), jcaches,
                         jnp.asarray(t), jnp.asarray(bt))
    tcell = tserve.build_decode_verify_paged(tc, PAGE, k)
    tk.reset_counters()
    tg, tf, tout = tcell(tparams, torch.from_numpy(cand), tcaches,
                         torch.from_numpy(t), torch.from_numpy(bt))
    assert tk.REFERENCE_CALLS["paged_decode_mha"] == tc.num_layers
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    for pos in jout:
        for key in jout[pos]:
            np.testing.assert_allclose(
                tout[pos][key].numpy().astype(np.float32),
                np.asarray(jout[pos][key]).astype(np.float32),
                atol=1e-5, rtol=1e-5, err_msg=f"{pos}/{key}")


# --------------------------------------------------------------- engine
@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_speculative_matches_greedy(mode):
    """The speculative engine (either proposer) emits the port's greedy
    engine's tokens bit for bit on fp pools, commits every token past
    each prefill token in fewer verify steps than greedy's decode steps,
    and drains the pager clean; the draft proposer runs flash_decode's
    plain version on its contiguous caches."""
    dst = _dev_serve()
    _, tc = _cfgs()
    params = TM.init_model(tc, device="cpu", seed=0)
    tk.reset_counters()
    r = dst.speculative_parity(tc, params, _prompts(tc.vocab_size), GEN,
                               mode, device="cpu", page_tokens=PAGE)
    assert r["exact"], r
    np.testing.assert_array_equal(r["tokens"], r["greedy"])
    sp = r["stats"].spec
    assert sp["verify_steps"] < r["greedy_stats"].steps
    assert 1.0 <= sp["accept_len_mean"] <= 4.0
    assert sp["emitted"] == B * (GEN - 1)
    assert (sp["draft_calls"] > 0) == (mode == "draft")
    assert (tk.REFERENCE_CALLS["decode_mha"] > 0) == (mode == "draft")
    p = r["engine"].pager
    assert sorted(p._free_phys) == list(range(p.n_phys))
    assert (p.ref == 0).all() and not p.valid.any()


@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_speculative_engine_matches_reference(mode):
    """Against the reference engine with the same weights (and, for the
    draft proposer, the reference's draft tree loaded into the cells):
    identical tokens, identical `spec` counters, virtual metrics equal
    to rel=1e-9."""
    jc, tc = _cfgs()
    jparams = _jax_params(jc)
    kw = _base(speculative=mode, speculative_k=4)
    jeng = JServingEngine.build(jc, CTX, JEngineConfig(substrate="off", **kw),
                                params=jparams)
    teng = ServingEngine.build(tc, EngineConfig(substrate="off", **kw),
                               params=_to_torch(jparams),
                               topo=_ref_topology(), chip=_ref_chip(),
                               device="cpu")
    if mode == "draft":
        teng.cells.draft_params = _to_torch(jeng.cells.draft_params)
    prompts = _prompts(jc.vocab_size, seed=8)
    jreqs = [JRequest(request_id=i, tokens=prompts[i], max_new_tokens=GEN)
             for i in range(B)]
    treqs = [Request(request_id=i, tokens=prompts[i], max_new_tokens=GEN)
             for i in range(B)]
    js, ts = jeng.run(jreqs), teng.run(treqs)
    for jr, tr_ in zip(jreqs, treqs):
        assert tr_.output == jr.output, jr.request_id
    assert ts.spec == pytest.approx(js.spec, rel=1e-12)
    jsum, tsum = js.summary(), ts.summary()
    jsum.pop("tok_per_s_wall"), tsum.pop("tok_per_s_wall")
    assert tsum == pytest.approx(jsum, rel=1e-9)
    assert ts.pager == pytest.approx(js.pager, rel=1e-9)


def test_speculative_int8_per_token_scales():
    """int8 pools under speculation switch to per-token sub-scales (5-D
    k_sz/v_sz) and stay within the drift bound of the (per-page) int8
    greedy stream, and equal the greedy stream on a per-token pool; with
    prefill_chunk the chunks run the gather-only paged-prefill path."""
    dst = _dev_serve()
    _, tc = _cfgs()
    params = TM.init_model(tc, device="cpu", seed=0)
    tk.reset_counters()
    r = dst.speculative_parity(tc, params, _prompts(tc.vocab_size), GEN,
                               "ngram", pool_dtype="int8", device="cpu",
                               page_tokens=PAGE, prefill_chunk=S)
    eng = r["engine"]
    assert eng.cells.sz_granularity == "token"
    for c in eng.caches.values():
        assert c["k_sz"].dim() == 5 and c["v_sz"].dim() == 5
    assert tk.REFERENCE_CALLS["paged_prefill_mha"] > 0
    assert r["min"] >= INT8_TOKEN_AGREEMENT, r
    # against greedy on the same per-token pool the quantization grid is
    # the same, so only speculation differs: bit for bit
    same, _, geng = dst.engine_greedy(
        tc, params, _prompts(tc.vocab_size), GEN, paged=True,
        pool_dtype="int8", sz_granularity="token", device="cpu",
        page_tokens=PAGE, prefill_chunk=S)
    assert geng.cells.verify_fn is None
    assert geng.caches["pos0"]["k_sz"].dim() == 5
    np.testing.assert_array_equal(r["tokens"], same)


# ----------------------------------------------------------- validation
@pytest.mark.parametrize("override,match", [
    (dict(paged=False, pool_dtype="int8"), "paged layout only"),
    (dict(paged=False, speculative="ngram"), "requires the paged layout"),
    (dict(speculative="ngram", speculative_k=1), "spec_k must be >= 2"),
    (dict(speculative="beam"), "unknown speculative mode"),
])
def test_speculative_validation_errors(override, match):
    """The reference's ValueErrors, word for word, through the engine."""
    _, tc = _cfgs()
    ecfg = EngineConfig(**_base(**override))
    with pytest.raises(ValueError, match=match):
        ServingEngine.build(tc, ecfg, device="cpu")


@pytest.mark.parametrize("kw,match", [
    (dict(speculative="ngram", pool_dtype="int8"),
     "need sz_granularity='token'"),
    (dict(speculative="draft"), "needs a draft_cfg"),
])
def test_cell_validation_errors(kw, match):
    """What the engine never passes but the cells still refuse, as the
    reference's `make_engine_cells` does."""
    _, tc = _cfgs()
    with pytest.raises(ValueError, match=match):
        tserve.make_engine_cells(tc, n_slots=2, max_seq=16, buckets=(8,),
                                 device="cpu", **kw)

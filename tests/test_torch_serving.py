"""The port's serving host side and engine against the reference package:
the KV pager replayed op for op, and one seeded chat trace served by both
engines (reduced smollm, float32, substrate off, the port priced with the
reference's topology and chip numbers).

Gates: pager state and byte counters equal; fp pools give identical
per-request tokens; int8 pools keep per-request lockstep agreement
>= INT8_TOKEN_AGREEMENT; the virtual-clock summary metrics and the pager
deltas equal to rel=1e-9, for both admission modes."""

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
from repro.serving import INT8_TOKEN_AGREEMENT  # noqa: E402
from repro.serving import KVPager as JKVPager  # noqa: E402
from repro.serving import PagerConfig as JPagerConfig  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro.serving import make_scenario as jmake_scenario  # noqa: E402
from repro.serving.engine import \
    AdmissionController as JAdmission  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.common import hw as thw  # noqa: E402
from repro_torch.core import tiers as ttiers  # noqa: E402
from repro_torch.models.module import load_numpy_params  # noqa: E402
from repro_torch.serving import EngineConfig as TEngineConfig  # noqa: E402
from repro_torch.serving import INT8_TOKEN_AGREEMENT as T_AGREE  # noqa: E402
from repro_torch.serving import KVPager as TKVPager  # noqa: E402
from repro_torch.serving import PagerConfig as TPagerConfig  # noqa: E402
from repro_torch.serving import ServingEngine as TServingEngine  # noqa: E402
from repro_torch.serving import make_scenario as tmake_scenario  # noqa: E402
from repro_torch.serving.engine import \
    AdmissionController as TAdmission  # noqa: E402

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


# ---------------------------------------------------------------- pager
def _pagers(policy, seed):
    kw = dict(page_tokens=8, local_budget_bytes=5 * 8 * 100.0,
              policy=policy, hot_window=16, cold_touch=0.05)
    jp = JKVPager(3, 64, 100.0, 12.0, JPagerConfig(**kw),
                  topo=jtiers.v5e_topology())
    tp = TKVPager(3, 64, 100.0, 12.0, TPagerConfig(**kw),
                  topo=_ref_topology())
    return jp, tp


def _assert_same_pager(jp, tp):
    np.testing.assert_array_equal(tp.block_table(), jp.block_table())
    np.testing.assert_array_equal(tp.ref, jp.ref)
    np.testing.assert_array_equal(tp.phys_tiers(), jp.phys_tiers())
    np.testing.assert_array_equal(tp.tier, jp.tier)
    np.testing.assert_array_equal(tp.lengths, jp.lengths)
    assert tp.counters() == pytest.approx(jp.counters(), rel=1e-12)


@pytest.mark.parametrize("policy", ["hotness", "static", "none"])
@pytest.mark.parametrize("seed", [0, 1])
def test_pager_replay_matches_reference(policy, seed):
    """Random admit/extend/ensure-tail/step/truncate/share/release
    sequences give identical tables, refcounts, tiers and bytes."""
    rng = np.random.default_rng(seed)
    jp, tp = _pagers(policy, seed)
    for _ in range(60):
        op = int(rng.integers(6))
        s = int(rng.integers(3))
        if op == 0:
            n = int(rng.integers(1, 40))
            for p in (jp, tp):
                p.admit(s, n)
        elif op == 1:
            n = int(jp.lengths[s] + rng.integers(0, 12))
            if jp.lengths[s] and n <= 64:
                for p in (jp, tp):
                    p.extend(s, n)
        elif op == 2:
            active = rng.random(3) < 0.7
            active &= jp.lengths > 0
            active &= jp.lengths < 63
            assert jp.ensure_tail_pages(active) == \
                tp.ensure_tail_pages(active)
            tj, tt = jp.step(active), tp.step(active)
            assert dataclasses.asdict(tt) == pytest.approx(
                dataclasses.asdict(tj), rel=1e-12)
        elif op == 3:
            assert jp.truncate(s) == tp.truncate(s)
        elif op == 4:
            # share slot s's first page into another fresh slot
            o = (s + 1) % 3
            if jp.valid[s, 0] and not jp.valid[o].any():
                pages = [int(jp.phys[s, 0])]
                for p in (jp, tp):
                    p.map_shared(o, pages, 8)
        else:
            for p in (jp, tp):
                p.release(s)
        _assert_same_pager(jp, tp)


# --------------------------------------------------------------- engine
def _agreement(a, b):
    n = max(len(a), len(b))
    return sum(x == y for x, y in zip(a, b)) / n if n else 1.0


def _engines(**kw):
    """The reference's engine and the port's on the same reduced float32
    smollm weights, the port priced with the reference's topology and
    chip."""
    jc = dataclasses.replace(jconfigs.reduced("smollm_360m"),
                             dtype="float32")
    tc = dataclasses.replace(tconfigs.reduced("smollm_360m"),
                             dtype="float32")
    jparams, _ = JM.init_model(jc, jax.random.PRNGKey(0))
    tparams = load_numpy_params(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    kw = dict(n_slots=4, max_seq=48, prefill_buckets=(16, 32),
              page_tokens=8, hot_window=16, local_budget_frac=0.5, **kw)
    jeng = JServingEngine.build(jc, CTX, JEngineConfig(substrate="off", **kw),
                                params=jparams)
    teng = TServingEngine.build(tc, TEngineConfig(substrate="off", **kw),
                                params=tparams,
                                topo=_ref_topology(), chip=_ref_chip(),
                                device="cpu")
    return jc, jeng, teng


@pytest.mark.parametrize("admission", ["greedy", "loi"])
@pytest.mark.parametrize("pool_dtype", ["fp", "int8"])
def test_engine_matches_reference(pool_dtype, admission):
    assert T_AGREE == INT8_TOKEN_AGREEMENT
    jc, jeng, teng = _engines(pool_dtype=pool_dtype, admission=admission)
    trace = dict(n=8, vocab=jc.vocab_size, seed=3, prompt_buckets=(16, 32),
                 gen_range=(4, 12), arrival_rate=2e5)
    jreqs = jmake_scenario("chat", **trace)
    treqs = tmake_scenario("chat", **trace)
    js, ts = jeng.run(jreqs), teng.run(treqs)
    for jr, tr_ in zip(jreqs, treqs):
        assert len(tr_.output) == tr_.max_new_tokens
        if pool_dtype == "fp":
            assert tr_.output == jr.output, jr.request_id
        else:
            assert _agreement(tr_.output, jr.output) >= INT8_TOKEN_AGREEMENT
    # the virtual clock and the pager see token counts, not token values
    jsum, tsum = js.summary(), ts.summary()
    jsum.pop("tok_per_s_wall"), tsum.pop("tok_per_s_wall")
    assert tsum == pytest.approx(jsum, rel=1e-9)
    assert ts.pager == pytest.approx(js.pager, rel=1e-9)
    assert js.max_concurrency > 1            # the trace really batches


@pytest.mark.parametrize("prior", ["catalog", "budget"])
def test_engine_with_catalog_prior_matches_reference(prior):
    """`catalog_arch` set: the port's engine seeds admission with the
    catalog prior priced on its own chip and topology (here the
    reference's v5e, one chip: non-zero at decode_32k), as
    `AdmissionController.from_catalog` computes it. The JAX engine prices
    the catalog on its 256-chip mesh, where the prior is 0, so both
    engines' admission controllers are then seeded with the same
    non-zero prior: the catalog one, or the whole corridor budget (which
    refuses a second slot until the measured LoI refines the prior). The
    trace gives the same tokens, virtual metrics, admission blocks and
    pager deltas (rel=1e-9)."""
    jc, jeng, teng = _engines(pool_dtype="fp", admission="loi",
                              catalog_arch="smollm_360m",
                              catalog_shape="decode_32k")
    own = TAdmission.from_catalog(_ref_topology(), "smollm_360m",
                                  "decode_32k", chip=_ref_chip())
    assert teng.admission.per_slot_loi == own.per_slot_loi > 0.0
    assert teng.admission.budget == pytest.approx(jeng.admission.budget,
                                                  rel=1e-9)
    loi = (own.per_slot_loi if prior == "catalog"
           else teng.admission.budget)
    jeng.admission = JAdmission(jeng.topo, prior_loi=loi, mode="loi")
    teng.admission = TAdmission(teng.topo, prior_loi=loi, mode="loi")
    trace = dict(n=8, vocab=jc.vocab_size, seed=4, prompt_buckets=(16, 32),
                 gen_range=(4, 12), arrival_rate=2e5)
    jreqs = jmake_scenario("chat", **trace)
    treqs = tmake_scenario("chat", **trace)
    js, ts = jeng.run(jreqs), teng.run(treqs)
    for jr, tr_ in zip(jreqs, treqs):
        assert tr_.output == jr.output, jr.request_id
    jsum, tsum = js.summary(), ts.summary()
    jsum.pop("tok_per_s_wall"), tsum.pop("tok_per_s_wall")
    assert tsum == pytest.approx(jsum, rel=1e-9)
    assert ts.pager == pytest.approx(js.pager, rel=1e-9)
    assert teng.admission.blocks == jeng.admission.blocks
    assert (teng.admission.blocks > 0) == (prior == "budget")


def test_engine_config_defaults_match_reference():
    """Every `EngineConfig` default is the reference's, `substrate`
    ("auto") included."""
    jd = {f.name: f.default for f in dataclasses.fields(JEngineConfig)}
    td = {f.name: f.default for f in dataclasses.fields(TEngineConfig)}
    assert set(td) == set(jd)
    assert {k for k in jd if jd[k] != td[k]} == set()
    assert td["substrate"] == jd["substrate"] == "auto"

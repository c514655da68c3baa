"""The port's fault layer against the reference package: the injector's
per-site Philox draws and lifecycle decisions for every named plan and
for one plan per fault site, the plans' validation, the pager's
freeze / thaw / drop_frozen against the reference pager (refcount cover
invariant under `validate=True`), and the engine's recovery paths on
reduced smollm in float32 beside the JAX engine on the same weights:
the pool-exhaustion preemption of `tests/test_serving.py`
(`test_engine_preempts_low_priority_under_pool_exhaustion`), a pinned
freeze -> drain -> thaw followed by `degrade_pool` with the substrate
on, and `evacuate`.

Gates: draws, decisions and counters equal; pager state arrays equal
after every operation; tokens equal (fp pools) to the uncontended /
uninterrupted run and to JAX's; `ServeStats.faults`, substrate ledger
counters and `summary()` equal to JAX's to rel=1e-9; pools drained
exactly free; placement gap 0 after every drain."""

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
from repro.serving import KVPager as JKVPager  # noqa: E402
from repro.serving import PagerConfig as JPagerConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import RequestQueue as JRequestQueue  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.common import hw as thw  # noqa: E402
from repro_torch.core import tiers as ttiers  # noqa: E402
from repro_torch.models.module import load_numpy_params  # noqa: E402
from repro_torch.serving import EngineConfig, KVPager  # noqa: E402
from repro_torch.serving import PagerConfig, Request  # noqa: E402
from repro_torch.serving import RequestQueue, ServingEngine  # noqa: E402
from repro_torch.serving import faults  # noqa: E402

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


# ---------------------------------------------------------- injector
SITE_PLANS = {
    "stall": dict(seed=3, stall_engine=1, stall_at_step=4, stall_s=0.5),
    "shrink": dict(seed=3, shrink_engine=0, shrink_at_step=2,
                   shrink_frac=0.25),
    "pool_lost": dict(seed=3, lose_pool_engine=1, lose_pool_at_step=5),
    "flaky_seeded": dict(seed=2**33 + 5, transfer_fail_rate=0.6,
                         max_retries=3, backoff_base_s=1e-3,
                         backoff_cap_s=3e-3),
}


def _drive(F, plan):
    """Every site of one injector, interleaved: transfer draws on three
    sites, backoff, and the lifecycle questions of two engines over ten
    steps."""
    inj = F.FaultInjector(plan)
    out = []
    for step in range(10):
        for site in ("substrate/page_out", "handoff", "substrate/page_in"):
            out.append(inj.transfer_fails(site))
        for eid in (0, 1):
            out += [inj.kill_now(eid, step), inj.stall_now(eid, step),
                    inj.shrink_now(eid, step), inj.pool_lost_now(eid, step)]
    out += [inj.backoff_s(a) for a in range(1, 12)]
    return out, inj.counters(), plan.active


@pytest.mark.parametrize("name", sorted(set(faults.PLANS)
                                        | set(SITE_PLANS)))
def test_injector_matches_reference(name):
    if name in SITE_PLANS:
        tplan = faults.FaultPlan(**SITE_PLANS[name])
        jplan = jfaults.FaultPlan(**SITE_PLANS[name])
    else:
        tplan, jplan = faults.make_plan(name), jfaults.make_plan(name)
        assert dataclasses.asdict(tplan) == dataclasses.asdict(jplan)
    assert _drive(faults, tplan) == _drive(jfaults, jplan)


def test_injector_sites_are_independent():
    """One site's draws never shift another's (the chaos schedule is a
    pure function of the plan however sites interleave)."""
    plan = faults.make_plan("transfer_flake")
    a, b = faults.FaultInjector(plan), faults.FaultInjector(plan)
    seq_a = [a.transfer_fails("substrate/page_in") for _ in range(40)]
    seq_b = []
    for _ in range(40):
        b.transfer_fails("substrate/page_out")
        seq_b.append(b.transfer_fails("substrate/page_in"))
    assert seq_a == seq_b and any(seq_a)


@pytest.mark.parametrize("kw", [
    dict(transfer_fail_rate=1.0), dict(transfer_fail_rate=-0.1),
    dict(max_retries=0), dict(shrink_frac=0.0), dict(shrink_frac=1.5),
])
def test_plan_validation_matches_reference(kw):
    with pytest.raises(ValueError) as want:
        jfaults.FaultPlan(**kw)
    with pytest.raises(ValueError) as got:
        faults.FaultPlan(**kw)
    assert str(got.value) == str(want.value)


def test_make_plan_unknown_raises():
    with pytest.raises(ValueError) as want:
        jfaults.make_plan("earthquake")
    with pytest.raises(ValueError) as got:
        faults.make_plan("earthquake")
    assert str(got.value) == str(want.value)
    assert not faults.make_plan("none").active


# ------------------------------------------------------------- pager
def _pagers(policy="hotness", budget=1200.0):
    kw = dict(page_tokens=4, local_budget_bytes=budget, policy=policy,
              hot_window=8, cold_touch=0.1, validate=True)
    return (KVPager(3, 32, 10.0, 0.0, PagerConfig(**kw)),
            JKVPager(3, 32, 10.0, 0.0, JPagerConfig(**kw)))


def _same(tp, jp):
    for name in ("valid", "lengths", "phys", "ref", "tier_phys"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name),
                                      err_msg=name)
    assert tp._free_phys == jp._free_phys
    assert tp.counters() == pytest.approx(jp.counters(), rel=1e-12)
    # the refcount cover invariant
    assert tp.ref.sum() == tp.valid.sum() + tp.pins


@pytest.mark.parametrize("policy,budget", [("hotness", 1200.0),
                                           ("static", 600.0),
                                           ("none", None)])
def test_pager_freeze_thaw_matches_reference(policy, budget):
    """Pinned and spilled freezes, thaws into other slots, dropped
    snapshots and steps in between, on both pagers: the same tables,
    refcounts, tiers and free lists after every operation. A pinned
    freeze retags the pages pool tier where a budget exists."""
    tp, jp = _pagers(policy, budget)
    for p in (tp, jp):
        p.admit(0, 9)
        p.admit(1, 14)
        p.admit(2, 5)
    _same(tp, jp)
    ops = [("step",), ("freeze", 1, "a", False), ("step",),
           ("freeze", 0, "b", True), ("thaw", 0, "a"), ("step",),
           ("freeze", 2, "c", False), ("admit", 1, 7), ("drop", "c"),
           ("drop", "b"), ("step",), ("freeze", 0, "d", False),
           ("thaw", 2, "d"), ("step",)]
    snaps = ({}, {})
    for op in ops:
        for p, sn in zip((tp, jp), snaps):
            if op[0] == "step":
                p.step(p.valid.any(axis=1))
            elif op[0] == "freeze":
                sn[op[2]] = p.freeze(op[1], spill=op[3])
            elif op[0] == "thaw":
                p.thaw(op[1], sn[op[2]])
            elif op[0] == "admit":
                p.admit(op[1], op[2])
            else:
                p.drop_frozen(sn[op[1]])
        if op[0] == "freeze":
            t, j = snaps[0][op[2]], snaps[1][op[2]]
            assert t["length"] == j["length"]
            if op[3]:
                assert t["pages"] is None and j["pages"] is None
            else:
                np.testing.assert_array_equal(t["pages"], j["pages"])
                if budget is not None:
                    assert (tp.tier_phys[t["pages"]] == 1).all()
        _same(tp, jp)
    with pytest.raises(ValueError, match="spilled"):
        tp.thaw(1, {"pages": None, "length": 3})
    for s in range(3):
        tp.release(s)
    tp.drop_frozen({"pages": None})
    assert sorted(tp._free_phys) == list(range(tp.n_phys))
    assert (tp.ref == 0).all() and tp.pins == 0
    assert tp.counters()["freezes"] == 4 and tp.counters()["thaws"] == 2


# ----------------------------------------------------------- engines
@pytest.fixture(scope="module")
def weights():
    jc = dataclasses.replace(jconfigs.reduced("smollm_360m"),
                             dtype="float32")
    tc = dataclasses.replace(tconfigs.reduced("smollm_360m"),
                             dtype="float32")
    jparams, _ = JM.init_model(jc, jax.random.PRNGKey(0))
    tparams = load_numpy_params(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jc, tc, jparams, tparams


PREEMPT_ECFG = dict(n_slots=2, max_seq=16, prefill_buckets=(8, 12),
                    page_tokens=4, hot_window=8, local_budget_frac=0.5,
                    admission="greedy", paged=True, pool_dtype="fp")


def _preempt(eng, req_cls, vocab, victim_priority=1):
    """The reference test's shape: pages stranded under a guard pin, a
    low-priority victim mid-decode, then a high-priority prompt that
    needs more pages than are free. Returns (uncontended-shape requests
    b and c, stats of the contended run, the held pages)."""
    rng = np.random.default_rng(21)
    tok_b = rng.integers(0, vocab, 8).astype(np.int32)
    tok_c = rng.integers(0, vocab, 12).astype(np.int32)
    sac = req_cls(request_id=7, tokens=tok_b.copy(), max_new_tokens=6,
                  priority=1)
    eng.run([sac], max_steps=2)
    slot = next(s for s in eng.batcher.slots if s.active)
    held = eng.pager.phys[slot.index, eng.pager.valid[slot.index]].copy()
    assert held.size == 3
    eng.pager.pin(held)
    eng._retire(slot)
    b = req_cls(request_id=0, tokens=tok_b, max_new_tokens=6,
                priority=victim_priority)
    eng.run([b], max_steps=4)
    assert eng.batcher.n_active == 1
    c = req_cls(request_id=1, tokens=tok_c, max_new_tokens=4, priority=0)
    assert eng.pager.counters()["free_pages"] < -(-c.prompt_len // 4)
    stats = eng.run([c])
    return b, c, stats, held, (tok_b, tok_c)


def test_engine_preemption_matches_reference(weights):
    """Admission under pool exhaustion spill-freezes the lower-priority
    slot, the high-priority request runs, and the victim resumes by
    teacher-forced refill: both streams equal the uncontended engine's
    (torch against torch) and JAX's, the fault counters equal JAX's,
    and the pool drains exactly free."""
    jc, tc, jparams, tparams = weights
    teng = ServingEngine.build(tc, EngineConfig(**PREEMPT_ECFG),
                               params=tparams, topo=_ref_topology(),
                               chip=_ref_chip(), device="cpu")
    jeng = JServingEngine.build(jc, CTX, JEngineConfig(**PREEMPT_ECFG),
                                params=jparams)
    tb, tcr, ts, held, (tok_b, tok_c) = _preempt(teng, Request,
                                                 tc.vocab_size)
    jb, jcr, js, jheld, _ = _preempt(jeng, JRequest, jc.vocab_size)
    np.testing.assert_array_equal(held, jheld)

    ref = ServingEngine.build(tc, EngineConfig(**PREEMPT_ECFG),
                              params=tparams, device="cpu")
    rb = Request(request_id=0, tokens=tok_b, max_new_tokens=6)
    rc = Request(request_id=1, tokens=tok_c, max_new_tokens=4)
    ref.run([rb, rc])
    assert tb.output == rb.output and tcr.output == rc.output
    assert tb.output == jb.output and tcr.output == jcr.output
    f = ts.faults
    assert f == pytest.approx(js.faults, rel=1e-9)
    assert f["preempts"] >= 1 and f["spills"] >= 1 and f["restores"] >= 1
    assert f["reprefilled_tokens"] > 0 and f["migrations_in"] == 0
    assert tcr.admitted < tb.finished
    tsum, jsum = ts.summary(), js.summary()
    tsum.pop("tok_per_s_wall"), jsum.pop("tok_per_s_wall")
    assert tsum == pytest.approx(jsum, rel=1e-9)
    teng.pager.unpin(held)
    p = teng.pager
    assert sorted(p._free_phys) == list(range(p.n_phys))
    assert (p.ref == 0).all() and p.pins == 0 and not teng.frozen


def test_no_victim_leaves_the_request_queued(weights):
    """With the victim in the same class as the incoming request there is
    nothing to preempt: the request stays queued until the running one
    finishes and frees its pages, and no fault counter moves."""
    _, tc, _, tparams = weights
    eng = ServingEngine.build(tc, EngineConfig(**PREEMPT_ECFG),
                              params=tparams, device="cpu")
    b, c, stats, held, _ = _preempt(eng, Request, tc.vocab_size,
                                    victim_priority=0)
    assert c.admitted >= b.finished
    assert len(b.output) == 6 and len(c.output) == 4
    assert stats.faults == {}
    eng.pager.unpin(held)
    assert eng.pager.counters()["free_pages"] == eng.pager.n_phys


def _serve_with_freeze(eng, reqs, queue_cls, *, freeze_at, degrade_at):
    """Pump `reqs`; after decode step `freeze_at` pin-freeze the youngest
    active slot, drain (its pages go out) and thaw it; degrade the pool
    after step `degrade_at`; drain and check the placement gap after
    every decode step. Returns (stats, gaps, frozen pages, the frozen
    pages' page_out count)."""
    q = queue_cls(reqs)
    cap = eng.begin_capture()
    gaps, pages = [], None
    while len(q) or eng.batcher.n_busy or eng.frozen:
        act = eng.pump(q)
        if act == "idle":
            nxt = q.next_arrival()
            if not np.isfinite(nxt):
                break
            eng.advance_to(nxt)
            continue
        if act != "decode":
            continue
        if eng.steps == freeze_at:
            victim = max((s for s in eng.batcher.slots if s.active),
                         key=lambda s: s.seq)
            pages = eng.freeze_slot(victim).pages
            out0 = eng.substrate.counters()["page_out_pages"]
            eng.substrate.drain(eng.pager, eng.caches, step=eng.steps)
            gaps.append(eng.pager.pool_bytes_used()
                        - eng.substrate.ledger.placement_bytes())
            n_out = eng.substrate.counters()["page_out_pages"] - out0
            assert set(pages.tolist()) <= eng.substrate._resident
            assert eng.thaw_slot(eng.frozen.pop(0))
        if eng.steps == degrade_at:
            eng.degrade_pool()
        eng.substrate.drain(eng.pager, eng.caches, step=eng.steps)
        gaps.append(eng.pager.pool_bytes_used()
                    - eng.substrate.ledger.placement_bytes())
    return eng.capture_stats(cap, reqs), gaps, pages, n_out


def _trace(req_cls, vocab):
    rng = np.random.default_rng(5)
    return [req_cls(request_id=i,
                    tokens=rng.integers(0, vocab, 8).astype(np.int32),
                    max_new_tokens=10, arrival=0.0) for i in range(3)]


def test_pinned_freeze_thaw_degrade_matches_reference(weights):
    """A pinned freeze tiers the slot's pages to the pool (the next drain
    pages them out), the thaw remaps them into a fresh slot and the
    rebalancer re-promotes the hot tail (page_in), `degrade_pool` retags
    everything local (the next drain pages the twin back in): tokens
    equal the uninterrupted run and JAX's, the gap is 0 after every
    drain, and the ledger, faults and summary equal JAX's."""
    jc, tc, jparams, tparams = weights
    kw = dict(n_slots=3, max_seq=24, prefill_buckets=(8,), page_tokens=4,
              hot_window=4, local_budget_frac=0.5, admission="greedy",
              pool_dtype="fp", substrate="auto")
    teng = ServingEngine.build(tc, EngineConfig(**kw), params=tparams,
                               topo=_ref_topology(), chip=_ref_chip(),
                               device="cpu")
    jeng = JServingEngine.build(jc, CTX, JEngineConfig(**kw),
                                params=jparams)
    when = dict(freeze_at=2, degrade_at=5)
    treqs, jreqs = _trace(Request, tc.vocab_size), _trace(JRequest,
                                                         jc.vocab_size)
    ts, tgaps, tpages, t_out = _serve_with_freeze(
        teng, treqs, RequestQueue, **when)
    js, jgaps, jpages, j_out = _serve_with_freeze(
        jeng, jreqs, JRequestQueue, **when)
    assert t_out == j_out > 0
    np.testing.assert_array_equal(tpages, jpages)
    assert tgaps == jgaps and all(g == 0 for g in tgaps)
    plain = _trace(Request, tc.vocab_size)
    ServingEngine.build(tc, EngineConfig(**kw), params=tparams,
                        device="cpu").run(plain)
    assert [r.output for r in treqs] == [r.output for r in plain]
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert ts.substrate["page_in_pages"] > 0
    assert ts.faults["preempts"] == 1 and ts.faults["restores"] == 1
    assert ts.faults["degraded"] == 1 and ts.faults["spills"] == 0
    assert ts.faults == pytest.approx(js.faults, rel=1e-9)
    tsub, jsub = dict(ts.substrate), dict(js.substrate)
    assert tsub.pop("mode") == jsub.pop("mode")
    assert tsub == pytest.approx(jsub, rel=1e-9)
    tsum, jsum = ts.summary(), js.summary()
    tsum.pop("tok_per_s_wall"), jsum.pop("tok_per_s_wall")
    assert tsum == pytest.approx(jsum, rel=1e-9)
    assert teng.pager.pool_bytes_used() == 0.0
    assert teng.pager.counters()["free_pages"] == teng.pager.n_phys


def test_evacuate_frees_the_pool_like_reference(weights):
    """`evacuate` mid-run hands back every slot and frozen snapshot
    (decode slots with their emitted history), and leaves the pool fully
    free with the substrate reconciled to empty: the same displaced
    requests as JAX's engine."""
    jc, tc, jparams, tparams = weights
    kw = dict(n_slots=3, max_seq=24, prefill_buckets=(8,), page_tokens=4,
              hot_window=4, local_budget_frac=0.5, admission="greedy",
              pool_dtype="fp")
    out = []
    for eng, req_cls, queue_cls, vocab in (
            (ServingEngine.build(tc, EngineConfig(**kw), params=tparams,
                                 topo=_ref_topology(), chip=_ref_chip(),
                                 device="cpu"), Request, RequestQueue,
             tc.vocab_size),
            (JServingEngine.build(jc, CTX, JEngineConfig(**kw),
                                  params=jparams), JRequest,
             JRequestQueue, jc.vocab_size)):
        q = queue_cls(_trace(req_cls, vocab))
        while eng.steps < 3:
            eng.pump(q)
        eng.freeze_slot(next(s for s in eng.batcher.slots if s.active))
        displaced = eng.evacuate()
        p = eng.pager
        assert p.counters()["free_pages"] == p.n_phys
        assert (p.ref == 0).all() and p.pins == 0 and not eng.frozen
        assert eng.substrate.ledger.placement_bytes() == 0.0
        assert eng.substrate.counters()["in_flight"] == 0
        out.append([(r.request_id, list(r.output)) for r in displaced])
    assert out[0] == out[1]
    assert len(out[0]) == 3


def test_fault_free_stats_are_empty(weights):
    _, tc, _, tparams = weights
    eng = ServingEngine.build(tc, EngineConfig(**dict(
        PREEMPT_ECFG, max_seq=32, prefill_buckets=(8,))),
        params=tparams, device="cpu")
    stats = eng.run(_trace(Request, tc.vocab_size))
    assert stats.faults == {}
    assert "fault_preempts" not in stats.summary()


def test_single_engine_stops_when_killed(weights):
    """A single engine has nowhere to recover to: `run` returns at the
    kill with the faults block present."""
    _, tc, _, tparams = weights
    eng = ServingEngine.build(tc, EngineConfig(**dict(
        PREEMPT_ECFG, max_seq=32, prefill_buckets=(8,))),
        params=tparams, device="cpu")
    eng.faults = faults.FaultInjector(faults.FaultPlan(
        kill_engine=0, kill_at_step=2))
    reqs = _trace(Request, tc.vocab_size)
    stats = eng.run(reqs)
    assert eng.steps == 2 and eng.pump(RequestQueue()) == "dead"
    assert stats.faults["preempts"] == 0 and "retries" in stats.faults

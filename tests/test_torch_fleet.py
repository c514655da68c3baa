"""The port's fleet layer against the reference package: placement
policies and the autoscaler over the `tests/test_fleet.py` cases (and
seeded random series), the handoff copy's plain version against the
reference's `roles.copy_pages`, and small fleets of reduced smollm in
float32 on fp pools, the JAX fleet beside the port's on the same weights
and trace: round-robin (and against a single engine), KV-load-aware with
cancellations, prefix-aware, the prefill/decode role split (handoff),
`chaos_smoke`, `transfer_flake`, a watchdog-recovered stall, a local
budget shrink, a lost pool tier and an autoscale drain.

Gates: placement and autoscale decisions equal; tokens equal;
`FleetStats.summary()`, `TransferLedger.counters()`, the fleet's and
each engine's `ServeStats.faults` equal to rel=1e-9; every pool drained
free (zero refcounts, zero pins, placement gap 0). The JAX engines of
each configuration are built once per module and cloned per fleet."""

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
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro.serving import fleet as jfleet  # noqa: E402
from repro.serving.faults import FaultPlan as JFaultPlan  # noqa: E402
from repro.serving.fleet import roles as jroles  # noqa: E402
from repro.serving.queue import \
    shared_prefix_stream as jshared_prefix_stream  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.common import hw as thw  # noqa: E402
from repro_torch.core import tiers as ttiers  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.module import load_numpy_params  # noqa: E402
from repro_torch.serving import EngineConfig, Request  # noqa: E402
from repro_torch.serving import ServingEngine, fleet  # noqa: E402
from repro_torch.serving.faults import FaultPlan  # noqa: E402
from repro_torch.serving.fleet import roles  # noqa: E402
from repro_torch.serving.queue import shared_prefix_stream  # noqa: E402

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


# ------------------------------------------------ placement policies
def _view(F, eid, *, slots=4, busy=0, queued=0, free=10, total=10,
          role="unified", accepting=True, queued_cost=None, busy_cost=None):
    return F.EngineView(
        engine_id=eid, n_slots=slots, busy=busy, queued=queued,
        free_pages=free, total_pages=total, role=role, accepting=accepting,
        queued_cost=queued_cost, busy_cost=busy_cost)


def _placement_round_robin(F):
    views = [_view(F, i) for i in range(3)]
    p, got = F.RoundRobinPlacement(), []
    for _ in range(7):
        e = p.place(views, [1, 2, 3])
        p.record(e, [1, 2, 3])
        got.append(e)
    try:
        F.RoundRobinPlacement().place([], [1])
        raised = False
    except ValueError:
        raised = True
    return got, raised


def _placement_kv_aware(F):
    p = F.KVLoadAwarePlacement()
    heavy = _view(F, 0, queued=1, queued_cost=96.0, busy_cost=0.0)
    light = _view(F, 1, queued=2, queued_cost=20.0, busy_cost=0.0)
    tight = _view(F, 0, queued_cost=0.0, busy_cost=0.0, free=2)
    roomy = _view(F, 1, queued_cost=0.0, busy_cost=0.0, free=9)
    a, b = _view(F, 0), _view(F, 1)
    views = (heavy, light, tight, roomy, a, b,
             _view(F, 0, queued=1), _view(F, 1, queued=2))
    return ([p.place([heavy, light], [1]), p.place(views[6:], [1]),
             p.place([tight, roomy], [1]), p.place([b, a], [1])],
            [F.kv_load_score(v) for v in views])


def _placement_prefix_aware(F):
    p = F.PrefixAwarePlacement(page_tokens=4)
    sys_prompt = list(range(8))
    p.record(1, sys_prompt + [20, 21, 22, 23])
    views = [_view(F, 0), _view(F, 1)]
    got = [p.place(views, sys_prompt + [30, 31, 32, 33]),
           p.place(views, [99] * 8)]
    q = F.PrefixAwarePlacement(page_tokens=2)
    q.record(1, [1, 2, 3, 4])
    q.record(0, [1, 2])
    got += [q.place(views, [1, 2, 3, 4, 9, 9]), q.place(views, [1, 2, 8, 8]),
            q.lookup([1, 2, 3, 4]), q.place([_view(F, 0)], [1, 2, 3, 4])]
    r = F.PrefixAwarePlacement(page_tokens=8)
    r.record(1, [1, 2, 3])
    got.append(r.lookup([1, 2, 3]))
    return got, (p.steered, p.cold, q.steered, q.cold)


def _placement_make_policy(F):
    names = [F.make_policy(n, page_tokens=4).name for n in F.POLICIES]
    errors = []
    for bad in (lambda: F.make_policy("least_recently_invented"),
                lambda: F.PrefixAwarePlacement(page_tokens=0)):
        try:
            bad()
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    return names, errors, F.make_policy("prefix_aware",
                                        page_tokens=4).page_tokens


def _placement_random(F):
    """Seeded random views and prompts through every policy."""
    rng = np.random.default_rng(7)
    out = []
    for name in F.POLICIES:
        p = F.make_policy(name, page_tokens=2)
        for _ in range(60):
            n = int(rng.integers(1, 4))
            views = [_view(F, int(e), slots=int(rng.integers(1, 5)),
                           busy=int(rng.integers(0, 4)),
                           queued=int(rng.integers(0, 4)),
                           free=int(rng.integers(0, 11)),
                           queued_cost=(float(rng.integers(0, 50))
                                        if rng.random() < 0.7 else None),
                           busy_cost=float(rng.integers(0, 50)))
                     for e in sorted(rng.choice(4, n, replace=False))]
            toks = rng.integers(0, 3, int(rng.integers(1, 9))).tolist()
            e = p.place(views, toks)
            p.record(e, toks)
            out.append(e)
    return out


PLACEMENT = {f.__name__[len("_placement_"):]: f for f in (
    _placement_round_robin, _placement_kv_aware, _placement_prefix_aware,
    _placement_make_policy, _placement_random)}


@pytest.mark.parametrize("case", sorted(PLACEMENT))
def test_placement_matches_reference(case):
    assert PLACEMENT[case](fleet) == PLACEMENT[case](jfleet)


# -------------------------------------------------------- autoscaler
AUTOSCALE = {
    # (config, [(occupancy, n_engines), ...]) — the reference test's cases
    "up_patience_cooldown": (
        dict(min_engines=1, max_engines=3, up_patience=2, down_patience=2,
             cooldown=2), [(2.0, 1), (2.0, 1), (2.0, 2), (2.0, 2), (2.0, 2)]),
    "down_patience_min_clamp": (
        dict(min_engines=1, max_engines=3, up_patience=1, down_patience=3,
             cooldown=0), [(0.0, 2)] * 3 + [(0.0, 1)] * 6),
    "midband_resets": (
        dict(min_engines=1, max_engines=2, up_patience=2, down_patience=2,
             cooldown=0), [(2.0, 1), (0.8, 1), (2.0, 1), (2.0, 1)]),
    "max_clamp": (
        dict(min_engines=1, max_engines=2, up_patience=1, down_patience=1,
             cooldown=0), [(5.0, 2)]),
    "random": (
        dict(min_engines=1, max_engines=4, high_watermark=1.2,
             low_watermark=0.3, up_patience=2, down_patience=3, cooldown=2),
        [(float(o), int(n)) for o, n in zip(
            np.random.default_rng(3).uniform(0.0, 2.0, 200),
            np.random.default_rng(4).integers(1, 5, 200))]),
}


@pytest.mark.parametrize("case", sorted(AUTOSCALE))
def test_autoscaler_matches_reference(case):
    kw, series = AUTOSCALE[case]

    def decide(F):
        a = F.Autoscaler(F.AutoscaleConfig(**kw))
        return [a.observe(o, n) for o, n in series], a.ups, a.downs

    assert decide(fleet) == decide(jfleet)


@pytest.mark.parametrize("kw", [
    dict(min_engines=3, max_engines=2),
    dict(high_watermark=0.2, low_watermark=0.5),
])
def test_autoscale_config_validation(kw):
    with pytest.raises(ValueError):
        jfleet.AutoscaleConfig(**kw)
    with pytest.raises(ValueError):
        fleet.AutoscaleConfig(**kw)


@pytest.mark.parametrize("kw", [
    dict(n_engines=0),
    dict(n_engines=1, roles=True),
    dict(n_engines=2, roles=True, autoscale="as"),
    dict(n_engines=2, autoscale="as4"),
    dict(n_engines=2, watchdog_s=0.0),
    dict(n_engines=2, roles=True, faults="kill"),
    dict(n_engines=2, roles=True, faults="stall"),
    dict(n_engines=2, roles=True, faults="flake"),
])
def test_fleet_config_validation_matches_reference(kw):
    """Roles refuse kill/stall plans (adopt needs the bucket prefill
    cell); transfer flaking under roles is fine."""
    def build(F, plan_cls):
        k = dict(kw)
        if k.get("autoscale") == "as":
            k["autoscale"] = F.AutoscaleConfig(max_engines=2)
        elif k.get("autoscale") == "as4":
            k["autoscale"] = F.AutoscaleConfig(max_engines=4)
        plans = {"kill": dict(kill_engine=1, kill_at_step=2),
                 "stall": dict(stall_engine=1, stall_s=1.0),
                 "flake": dict(transfer_fail_rate=0.25)}
        if "faults" in k:
            k["faults"] = plan_cls(seed=0, **plans[k["faults"]])
        try:
            F.FleetConfig(**k)
            return None
        except ValueError as e:
            return str(e)

    assert build(fleet, FaultPlan) == build(jfleet, JFaultPlan)


# ------------------------------------------------ the handoff copy
@pytest.mark.parametrize("pool_dtype", ["fp", "int8"])
def test_handoff_copy_plain_matches_reference(pool_dtype):
    """`roles.copy_pages` (the "handoff" stream of the page copy, plain on
    the CPU) lands the source pages' k, k_sz, v, v_sz at the destination
    ids exactly as the reference's `.at[:, dst].set(src[:, ids])`, and
    leaves every other page alone; one plain call per handoff."""
    jc = dataclasses.replace(jconfigs.reduced("smollm_360m"),
                             dtype="float32")
    tc = dataclasses.replace(tconfigs.reduced("smollm_360m"),
                             dtype="float32")
    n_slots, max_seq, page = 3, 32, 4
    rng = np.random.default_rng(1)
    src_np, dst_np = ({
        pos: {k: (rng.integers(-127, 128, leaf.shape).astype(leaf.dtype)
                  if np.dtype(leaf.dtype) == np.int8 else
                  rng.standard_normal(leaf.shape).astype(leaf.dtype))
              for k, leaf in c.items()}
        for pos, c in JM.make_paged_decode_caches(
            jc, n_slots, max_seq, page, pool_dtype=pool_dtype).items()}
        for _ in range(2))
    src_pages, dst_pages = [5, 0, 17, 9], [3, 22, 8, 1]
    want = jroles.copy_pages(
        jax.tree.map(jax.numpy.asarray, src_np),
        jax.tree.map(jax.numpy.asarray, dst_np), src_pages, dst_pages)
    tsrc = {pos: {k: torch.from_numpy(v.copy()) for k, v in c.items()}
            for pos, c in src_np.items()}
    tdst = {pos: {k: torch.from_numpy(v.copy()) for k, v in c.items()}
            for pos, c in dst_np.items()}
    assert set(tdst["pos0"]) == set(
        TM.make_paged_decode_caches(tc, n_slots, max_seq, page,
                                    pool_dtype=pool_dtype,
                                    device="cpu")["pos0"])
    tk.reset_counters()
    got = roles.copy_pages(tsrc, tdst, src_pages, dst_pages)
    assert got is tdst
    assert tk.REFERENCE_CALLS["handoff"] == 1
    assert sum(tk.LAUNCHES.values()) == 0
    for pos, c in want.items():
        for k, leaf in c.items():
            np.testing.assert_array_equal(got[pos][k].numpy(),
                                          np.asarray(leaf))
    with pytest.raises(ValueError, match="counts differ"):
        roles.copy_pages(tsrc, tdst, [1, 2], [3])


# ------------------------------------------------------ fleet runs
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


@pytest.fixture(scope="module")
def make_router(weights):
    """`make(ecfg_kw, fcfg_kw, port)` -> a FleetRouter of fresh engines
    over one engine per configuration (built once per module)."""
    jc, tc, jparams, tparams = weights
    bases = {}

    def make(ecfg_kw, fcfg_kw, port):
        key = (tuple(sorted(ecfg_kw.items())), port)
        if port:
            ecfg = EngineConfig(**ecfg_kw)
            if key not in bases:
                bases[key] = ServingEngine.build(
                    tc, ecfg, params=tparams, topo=_ref_topology(),
                    chip=_ref_chip(), device="cpu")
            b = bases[key]
            engines = [ServingEngine(tc, ecfg, b.params, b.cells,
                                     topo=_ref_topology(), chip=_ref_chip())
                       for _ in range(fcfg_kw.get("n_engines", 2))]
            return fleet.FleetRouter(engines, fleet.FleetConfig(**fcfg_kw))
        ecfg = JEngineConfig(**ecfg_kw)
        if key not in bases:
            bases[key] = JServingEngine.build(jc, CTX, ecfg, params=jparams)
        b = bases[key]
        engines = [JServingEngine(jc, CTX, ecfg, b.params, b.cells)
                   for _ in range(fcfg_kw.get("n_engines", 2))]
        return jfleet.FleetRouter(engines, jfleet.FleetConfig(**fcfg_kw))

    return make


def _ecfg(**kw):
    base = dict(n_slots=2, max_seq=14, prefill_buckets=(8,), page_tokens=4,
                hot_window=8, local_budget_frac=0.5, admission="greedy",
                pool_dtype="fp")
    base.update(kw)
    return base


def _stream(req_cls, vocab, n, gen=4, seed=11, gap=0.05):
    rng = np.random.default_rng(seed)
    return [req_cls(request_id=i,
                    tokens=rng.integers(0, vocab, 8).astype(np.int32),
                    max_new_tokens=gen, arrival=gap * i)
            for i in range(n)]


def _cancelled(req_cls, vocab):
    reqs = _stream(req_cls, vocab, 6, gen=6)
    reqs[1].cancel()
    reqs[3].cancel_at = reqs[3].arrival + 1e-5
    reqs[4].cancel_at = reqs[4].arrival + 1e-5
    return reqs


def _prefix(req_cls, vocab):
    mk = shared_prefix_stream if req_cls is Request else jshared_prefix_stream
    return mk(12, vocab, seed=3, system_tokens=24, prompt_buckets=(32,),
              gen_range=(4, 4), arrival_rate=4e4, n_systems=2)


def _autoscale_trace(req_cls, vocab):
    reqs = _stream(req_cls, vocab, 10, gen=4)
    for i, r in enumerate(reqs[:8]):
        r.arrival = 1e-5 * i
    reqs[8].arrival, reqs[9].arrival = 0.02, 0.05
    return reqs


def _fault(name):
    return {"chaos_smoke": dict(seed=0, transfer_fail_rate=0.10,
                                kill_engine=1, kill_at_step=3),
            "transfer_flake": dict(seed=0, transfer_fail_rate=0.25),
            "stall": dict(seed=0, stall_engine=1, stall_at_step=2,
                          stall_s=1.0),
            "shrink": dict(seed=0, shrink_engine=0, shrink_at_step=2,
                           shrink_frac=0.25),
            "pool_lost": dict(seed=0, lose_pool_engine=1,
                              lose_pool_at_step=3)}[name]


# name -> (ecfg overrides, fleet config (fault plan / autoscale by
# name), trace)
FLEETS = {
    "round_robin": ({}, dict(policy="round_robin"),
                    lambda R, v: _stream(R, v, 6)),
    "kv_aware_cancel": ({}, dict(policy="kv_aware"), _cancelled),
    "prefix_round_robin": (
        dict(max_seq=36, prefill_buckets=(32,), hot_window=16,
             prefix_cache=True), dict(policy="round_robin"), _prefix),
    "prefix_aware": (
        dict(max_seq=36, prefill_buckets=(32,), hot_window=16,
             prefix_cache=True), dict(policy="prefix_aware"), _prefix),
    "roles": (dict(max_seq=16, prefill_chunk=4), dict(roles=True),
              lambda R, v: _stream(R, v, 4)),
    "roles_flake": (dict(max_seq=16, prefill_chunk=4),
                    dict(roles=True, faults="transfer_flake"),
                    lambda R, v: _stream(R, v, 6)),
    "chaos_smoke": ({}, dict(faults="chaos_smoke"),
                    lambda R, v: _stream(R, v, 6, gen=6)),
    "transfer_flake": ({}, dict(faults="transfer_flake"),
                       lambda R, v: _stream(R, v, 6, gen=6)),
    "watchdog_stall": ({}, dict(faults="stall", watchdog_s=1e-3),
                       lambda R, v: _stream(R, v, 6)),
    "budget_shrink": ({}, dict(faults="shrink"),
                      lambda R, v: _stream(R, v, 6, gen=6)),
    "pool_lost": ({}, dict(faults="pool_lost"),
                  lambda R, v: _stream(R, v, 6, gen=6)),
    "autoscale_drain": ({}, dict(autoscale=dict(
        min_engines=1, max_engines=2, high_watermark=1.0,
        low_watermark=0.5, up_patience=1, down_patience=1, cooldown=0)),
        _autoscale_trace),
}


def _fcfg(F, plan_cls, kw):
    kw = dict(kw)
    if "faults" in kw:
        kw["faults"] = plan_cls(**_fault(kw["faults"]))
    if "autoscale" in kw:
        kw["autoscale"] = F.AutoscaleConfig(**kw["autoscale"])
    return dict(n_engines=2, **kw)


def _drained(router):
    """Every pool free once the prefix trie (if any) gives its cached
    pages back; the placement gap 0."""
    for h in router.handles:
        p, sub = h.engine.pager, h.engine.substrate
        assert p.pool_bytes_used() == sub.ledger.placement_bytes()
        if h.engine.prefix_cache is not None:
            h.engine.prefix_cache.reclaim(p, p.n_phys)
            sub.drain(p, h.engine.caches)
            assert p.pool_bytes_used() == sub.ledger.placement_bytes()
        assert p.counters()["free_pages"] == p.n_phys, h.engine_id
        assert (p.ref == 0).all() and p.pins == 0


@pytest.mark.parametrize("name", sorted(FLEETS))
def test_fleet_matches_reference(make_router, weights, name):
    jc, tc, _, _ = weights
    ecfg_kw, fcfg_kw, trace = FLEETS[name]
    ecfg_kw = _ecfg(**ecfg_kw)
    jrouter = make_router(ecfg_kw, _fcfg(jfleet, JFaultPlan, fcfg_kw),
                       port=False)
    trouter = make_router(ecfg_kw, _fcfg(fleet, FaultPlan, fcfg_kw),
                       port=True)
    jreqs, treqs = trace(JRequest, jc.vocab_size), trace(Request,
                                                         tc.vocab_size)
    tk.reset_counters()
    js, ts = jrouter.run(jreqs), trouter.run(treqs)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert sum(tk.LAUNCHES.values()) == 0
    jsum, tsum = js.summary(), ts.summary()
    assert tsum.pop("routed") == jsum.pop("routed")
    assert tsum == pytest.approx(jsum, rel=1e-9)
    assert ts.transfers == pytest.approx(js.transfers, rel=1e-9)
    assert ts.policy == js.policy
    assert ts.scale_events == pytest.approx(js.scale_events, rel=1e-9)
    tf, jf = dict(ts.faults), dict(js.faults)
    assert tf.pop("injected", None) == jf.pop("injected", None)
    assert tf == pytest.approx(jf, rel=1e-9)
    for te, je in zip(ts.per_engine, js.per_engine, strict=True):
        assert te.faults == pytest.approx(je.faults, rel=1e-9)
        assert te.steps == je.steps and te.tokens == je.tokens
        assert te.substrate.keys() == je.substrate.keys()
    _drained(trouter)
    if fcfg_kw.get("roles"):
        assert tk.REFERENCE_CALLS["handoff"] == ts.transfers["transfers"] > 0
        assert ts.transfers["pages"] > 0
    if fcfg_kw.get("faults") in ("chaos_smoke", "transfer_flake",
                                 "stall"):
        assert ts.faults["retries"] + ts.faults["engines_killed"] > 0
    if name == "budget_shrink":
        assert ts.faults["budget_shrinks"] == 1
    if name == "pool_lost":
        assert ts.faults["degraded"] == 1
        assert trouter.handles[1].engine.pager.cfg.policy == "none"
    if name == "chaos_smoke":
        f = ts.faults
        assert trouter.handles[1].dead
        assert f["engines_killed"] == 1 and f["recoveries"] == 1
        assert f["restores"] >= 1 and f["migrations_in"] >= 1
        assert f["reprefilled_tokens"] > 0 and f["retries"] >= 1


def test_fleet_round_robin_matches_single_engine(make_router, weights):
    """Placement is invisible to greedy tokens (torch against torch): the
    2-engine round-robin fleet replays the single engine's streams with
    both engines routed work; the fault-free fleet's faults stay {}."""
    _, tc, _, tparams = weights
    single = ServingEngine.build(tc, EngineConfig(**_ecfg()),
                                 params=tparams, device="cpu")
    solo = _stream(Request, tc.vocab_size, 6)
    single.run(solo)
    router = make_router(_ecfg(), dict(n_engines=2), port=True)
    reqs = _stream(Request, tc.vocab_size, 6)
    stats = router.run(reqs)
    assert [r.output for r in reqs] == [r.output for r in solo]
    assert min(stats.routed) > 0
    assert stats.faults == {} and all(s.faults == {}
                                      for s in stats.per_engine)
    assert "engines_killed" not in stats.summary()


def test_chaos_run_replays_exactly(make_router, weights):
    """The chaos schedule is a pure function of the plan: two runs of
    `chaos_smoke` give the same tokens and counters, equal to the
    fault-free fleet's tokens."""
    _, tc, _, _ = weights
    outs, faults = [], []
    clean = _stream(Request, tc.vocab_size, 6, gen=6)
    make_router(_ecfg(), dict(n_engines=2), port=True).run(clean)
    for _ in range(2):
        reqs = _stream(Request, tc.vocab_size, 6, gen=6)
        stats = make_router(_ecfg(), _fcfg(fleet, FaultPlan, dict(
            faults="chaos_smoke")), port=True).run(reqs)
        outs.append([r.output for r in reqs])
        faults.append(stats.faults)
    assert outs[0] == outs[1] == [r.output for r in clean]
    assert faults[0] == faults[1]


def test_fleet_build_shares_cells_and_params(weights):
    """`FleetRouter.build` builds one set of cells and one parameter tree
    and gives each engine its own pool and substrate."""
    _, tc, _, tparams = weights
    router = fleet.FleetRouter.build(
        tc, EngineConfig(**_ecfg()), fleet.FleetConfig(n_engines=3),
        params=tparams, device="cpu")
    engines = [h.engine for h in router.handles]

    def leaf(tree):
        while isinstance(tree, dict):
            tree = next(iter(tree.values()))
        return tree

    assert all(e.cells is engines[0].cells for e in engines)
    assert len({leaf(e.params).data_ptr() for e in engines}) == 1
    pools = {id(e.caches["pos0"]["k"]) for e in engines}
    assert len(pools) == 3
    assert len({id(e.substrate) for e in engines}) == 3


def _dev_serve():
    import importlib.util
    import pathlib

    path = (pathlib.Path(__file__).resolve().parents[1] / "scripts"
            / "dev_serve_torch.py")
    spec = importlib.util.spec_from_file_location("dev_serve_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("plan", [None, "chaos_smoke"])
def test_dev_serve_fleet_lanes(weights, plan, capsys):
    """The dev script's `--fleet 2` lanes (fleet parity + prefix-aware
    hit rate, and chaos parity under `--fault-plan chaos_smoke`) pass on
    the CPU, as the reference's CI lanes do."""
    _, tc, _, tparams = weights
    assert _dev_serve().fleet_lanes(tc, tparams, 2, plan, "cpu")
    assert "OK" in capsys.readouterr().out

"""The port's rack scheduler (`repro_torch.sched`) against the reference
package (`repro.sched`), and the engine's measured profile feeding it.

Every case of `tests/test_scheduler_sim.py` runs on both packages from
the same seeds, the port's profiles priced on the reference's v5e
topology (converted to the port's types): job streams, placements,
per-job start and finish times, slowdowns and summaries agree to 1e-12,
and the reference case's own assertions hold on the port's result. The
toy Fig 13 scheduler, `serving_stream`, `catalog_stream` (priced as the
reference prices it: the v5e chip and topology on 256 chips) and
`fleet_request_stream` are compared the same way. Then the engine's
`measured_profile` (`tests/test_serving.py::
test_measured_profile_feeds_scheduler`) against the JAX engine's, fed
through `serving_stream` and `simulate`; and the port's own defaults
(one H100 and its topology).
"""

import contextlib
import dataclasses
import functools
import importlib.util
import pathlib
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.sched as jsched  # noqa: E402
import repro_torch.sched as tsched  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.common import hw as jhw  # noqa: E402
from repro.common.parallel import ParallelCtx  # noqa: E402
from repro.core import interference as jitf  # noqa: E402
from repro.core import tiers as jtiers  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sched import scheduler as jtoy  # noqa: E402
from repro.sched import workload as jwork  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.common import hw as thw  # noqa: E402
from repro_torch.core import interference as titf  # noqa: E402
from repro_torch.core import quantify as tquantify  # noqa: E402
from repro_torch.core import tiers as ttiers  # noqa: E402
from repro_torch.models.module import load_numpy_params  # noqa: E402
from repro_torch.sched import scheduler as ttoy  # noqa: E402
from repro_torch.sched import workload as twork  # noqa: E402
from repro_torch.serving import EngineConfig, Request, ServingEngine  # noqa: E402,E501

CTX = ParallelCtx(remat="none")
TOL = 1e-12
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _cwd_without_records(tmp_path, monkeypatch):
    """Each test runs in an empty directory: `analyze` reads the port's
    records under the working directory's results/dryrun_torch/, so a
    dry-run left at the repo root cannot change what a test compares."""
    monkeypatch.chdir(tmp_path)


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


REF = _ref_topology()


@contextlib.contextmanager
def _priced_on_v5e():
    """The port's profiles priced as the reference prices them: the
    port's default topology swapped for the reference's v5e one, and
    `profile_for` on the v5e chip and topology on 256 chips."""
    orig = tquantify.profile_for
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttiers, "h100_topology", lambda: REF)
        mp.setattr(tquantify, "profile_for", functools.partial(
            orig, chip=_ref_chip(), topo=REF, n_chips=256))
        yield


def _tstream(n, **kw):
    with _priced_on_v5e():
        return tsched.synthetic_stream(n, **kw)


def _tprofile(*a, **k):
    with _priced_on_v5e():
        return tsched.profile_with_injected_loi(*a, **k)


J = types.SimpleNamespace(s=jsched, itf=jitf, toy=jtoy, work=jwork,
                          stream=jsched.synthetic_stream,
                          profile=jsched.profile_with_injected_loi)
T = types.SimpleNamespace(
    s=tsched, itf=titf, toy=ttoy, work=twork, stream=_tstream,
    profile=_tprofile)


# ---------------------------------------------------------- comparison
def _same(a, b, path="") -> None:
    """Equal structures: simulator results array by array and summary by
    summary, jobs by their fields and submission metrics, profiles by
    their fields; floats to TOL."""
    if hasattr(a, "slowdown") and hasattr(a, "pool_of"):
        for k in ("arrival", "start", "finish", "work", "pool_of",
                  "peak_occupancy", "slowdown", "wait", "stretch"):
            np.testing.assert_allclose(getattr(a, k), getattr(b, k),
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"{path}.{k}")
        _same(a.summary(), b.summary(), f"{path}.summary")
        assert a.n_events == b.n_events, path
    elif hasattr(a, "injected_loi") and hasattr(a, "job_id"):
        for k in ("job_id", "name", "arrival", "work", "injected_loi", "ic",
                  "t_pool", "t_local", "t_compute"):
            _same(getattr(a, k), getattr(b, k), f"{path}.{k}")
    elif hasattr(a, "pool_traffic") and hasattr(a, "topo"):
        for k in ("arch", "shape", "pool_traffic", "local_traffic",
                  "t_compute", "t_pool", "t_local"):
            _same(getattr(a, k), getattr(b, k), f"{path}.{k}")
        for k in ("injected_loi", "interference_coefficient"):
            _same(getattr(a, k)(), getattr(b, k)(), f"{path}.{k}")
    elif hasattr(a, "request_id") and hasattr(a, "tokens"):
        np.testing.assert_array_equal(a.tokens, b.tokens, err_msg=path)
        for k in ("request_id", "max_new_tokens", "arrival", "priority",
                  "tenant", "cancel_at"):
            _same(getattr(a, k), getattr(b, k), f"{path}.{k}")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=path)
    elif isinstance(a, (float, np.floating)) or isinstance(
            b, (float, np.floating)):
        assert a == pytest.approx(b, rel=TOL, abs=TOL), path
    else:
        assert a == b, path


def _both(fn):
    t, j = fn(T), fn(J)
    _same(t, j)
    return t


def _job(P, i, r, arrival=0.0, work=10.0):
    return P.s.TraceJob(job_id=i, name=f"j{i}", profile=P.profile(r),
                        arrival=arrival, work=work)


# ------------------------------------------------------------- cluster
def test_cluster_construction():
    def scenario(P):
        spec = P.s.ClusterSpec(n_racks=3, pools_per_rack=2, nodes_per_pool=4)
        c = P.s.Cluster.build(spec)
        return dict(racks=len(c.racks), pools=len(c.pools),
                    n_pools=spec.n_pools,
                    ids=[p.pool_id for p in c.pools],
                    rack_ids=[p.rack_id for p in c.pools],
                    cap=c.total_capacity, slots=spec.total_slots,
                    occ=c.occupancy,
                    open=all(p.is_open and p.free_slots == 4
                             for p in c.pools))

    d = _both(scenario)
    assert d["racks"] == 3
    assert d["pools"] == 6 == d["n_pools"]
    assert d["ids"] == list(range(6))
    assert d["rack_ids"] == [0, 0, 1, 1, 2, 2]
    assert d["cap"] == 24 == d["slots"]
    assert d["occ"] == 0 and d["open"]


def test_cluster_spec_validation():
    for P in (T, J):
        with pytest.raises(ValueError):
            P.s.ClusterSpec(n_racks=0)
        with pytest.raises(ValueError):
            P.s.ClusterSpec(nodes_per_pool=-1)


def test_pool_capacity_enforced():
    def scenario(P):
        c = P.s.build_cluster(1, 1, 2)
        p = c.pools[0]
        p.add(_job(P, 0, 0.1))
        p.add(_job(P, 1, 0.1))
        with pytest.raises(RuntimeError):
            p.add(_job(P, 2, 0.1))
        c.reset()
        return p.is_open, c.occupancy

    assert _both(scenario) == (True, 0)


def test_pool_background_loi():
    def scenario(P):
        p = P.s.build_cluster(1, 1, 4).pools[0]
        a, b = _job(P, 0, 0.3), _job(P, 1, 0.2)
        p.add(a)
        p.add(b)
        return (a, b, p.background_loi_for(a), p.total_injected_loi(),
                p.background_lois())

    a, b, bg_a, total, bgs = _both(scenario)
    assert bg_a == pytest.approx(b.injected_loi)
    assert total == pytest.approx(a.injected_loi + b.injected_loi)
    np.testing.assert_allclose(bgs, [b.injected_loi, a.injected_loi],
                               rtol=1e-12)


# ------------------------------------------------------------- policies
def test_aware_separates_loud_from_sensitive():
    def scenario(P):
        cluster = P.s.build_cluster(1, 2, 2)
        pol = P.s.InterferenceAwarePolicy()
        loud, fragile = _job(P, 0, 0.85), _job(P, 1, 0.7)
        p_loud = pol.select(loud, cluster, 0.0)
        p_loud.add(loud)
        p_fragile = pol.select(fragile, cluster, 0.0)
        tight = P.s.build_cluster(1, 1, 2)
        tight.pools[0].add(loud)
        return (p_loud.pool_id, p_fragile.pool_id,
                pol.select(fragile, tight, 0.0) is tight.pools[0],
                P.s.policies.marginal_colocation_cost(cluster.pools[0],
                                                      fragile))

    p_loud, p_fragile, forced, _ = _both(scenario)
    assert p_fragile != p_loud
    assert forced


def test_binpack_respects_corridor_budget():
    def scenario(P):
        cluster = P.s.build_cluster(1, 4, 4)
        pol = P.s.CorridorBinPackPolicy(loi_budget=0.6)
        for i in range(6):
            j = _job(P, i, 0.25)
            pol.select(j, cluster, 0.0).add(j)
        return ([p.total_injected_loi() for p in cluster.pools],
                [len(p.jobs) for p in cluster.pools])

    aggs, occ = _both(scenario)
    assert all(a <= 0.6 + 1e-9 for a in aggs)
    assert sum(1 for n in occ if n) == 3


def test_binpack_default_budget_from_topology():
    """The corridor budget derives from the pool topology: the
    reference's v5e topology gives the reference's budget; the port's
    default is its H100 topology's."""
    from repro_torch.core.interference import corridor_budget

    assert tsched.CorridorBinPackPolicy(topo=REF).loi_budget == \
        pytest.approx(jsched.CorridorBinPackPolicy().loi_budget, rel=TOL)
    assert tsched.CorridorBinPackPolicy().loi_budget == corridor_budget(
        ttiers.h100_topology())


def test_policy_factory():
    for P in (T, J):
        for name in ("fcfs", "random", "aware", "binpack"):
            assert P.s.make_policy(name, seed=1).name == name
        with pytest.raises(ValueError):
            P.s.make_policy("clairvoyant")
        assert isinstance(P.s.make_policy("aware"), P.s.Policy)
    assert tsched.DEFAULT_POLICIES == jsched.DEFAULT_POLICIES


# ------------------------------------------------------------ simulator
def test_conservation_invariants():
    def scenario(P):
        jobs = P.stream(300, seed=5)
        cluster = P.s.build_cluster(2, 2, 2)
        res = P.s.simulate(jobs, cluster, P.s.make_policy("aware"))
        return jobs, res, [p.capacity for p in cluster.pools], \
            cluster.occupancy

    _, res, caps, occ = _both(scenario)
    assert np.isfinite(res.start).all() and np.isfinite(res.finish).all()
    assert (res.pool_of >= 0).all() and (res.pool_of < 4).all()
    assert (res.start >= res.arrival - 1e-9).all()
    assert (res.finish > res.start).all()
    assert (res.slowdown >= 1.0 - 1e-9).all()
    assert (res.peak_occupancy <= caps).all()
    assert occ == 0


def test_simulator_deterministic():
    def scenario(P):
        jobs = P.stream(150, seed=9)
        return [P.s.simulate(jobs, P.s.build_cluster(2, 2, 2),
                             P.s.make_policy("random", seed=4))
                for _ in range(2)]

    r1, r2 = _both(scenario)
    np.testing.assert_array_equal(r1.pool_of, r2.pool_of)
    np.testing.assert_allclose(r1.finish, r2.finish, rtol=0, atol=0)


def test_no_contention_means_no_slowdown():
    def scenario(P):
        jobs = [_job(P, i, 0.5, arrival=100.0 * i, work=10.0)
                for i in range(5)]
        return P.s.simulate(jobs, P.s.build_cluster(1, 1, 4),
                            P.s.make_policy("fcfs"))

    res = _both(scenario)
    np.testing.assert_allclose(res.slowdown, 1.0, rtol=1e-9)
    np.testing.assert_allclose(res.wait, 0.0, atol=1e-9)


def test_two_loud_jobs_slow_each_other():
    def scenario(P):
        jobs = [_job(P, 0, 0.5, 0.0, 10.0), _job(P, 1, 0.5, 0.0, 10.0)]
        res = P.s.simulate(jobs, P.s.build_cluster(1, 1, 2),
                           P.s.make_policy("fcfs"))
        return res, 1.0 / jobs[0].sensitivity(jobs[1].injected_loi)

    res, expected = _both(scenario)
    np.testing.assert_allclose(res.slowdown, expected, rtol=1e-6)


def test_aware_variance_not_worse_than_random():
    res = _both(lambda P: P.s.run_policies(
        P.stream(400, seed=7), P.s.ClusterSpec(2, 2, 4),
        policy_names=("random", "aware"), seed=3))
    assert (res["aware"].summary()["var_slowdown"]
            <= res["random"].summary()["var_slowdown"])


def test_thousand_job_trace_is_fast():
    def scenario(P):
        jobs = P.stream(1000, seed=3)
        t0 = time.perf_counter()
        res = P.s.simulate(jobs, P.s.build_cluster(2, 2, 4),
                           P.s.make_policy("aware"))
        return res, time.perf_counter() - t0

    t, j = scenario(T), scenario(J)
    _same(t[0], j[0])
    assert t[1] < 10.0


def test_rescale_load_hits_target_utilization():
    def scenario(P):
        jobs = P.s.rescale_load(P.stream(200, seed=1), total_slots=16,
                                utilization=0.5)
        span = max(j.arrival for j in jobs)
        return jobs, sum(j.work for j in jobs) / (16 * span)

    _, offered = _both(scenario)
    assert offered == pytest.approx(0.5, rel=0.02)


def test_simulate_rejects_bad_input():
    for P in (T, J):
        with pytest.raises(ValueError):
            P.s.simulate([], P.s.build_cluster(1, 1, 1),
                         P.s.make_policy("fcfs"))
        bad = [_job(P, 0, 0.5, work=0.0)]
        with pytest.raises(ValueError):
            P.s.simulate(bad, P.s.build_cluster(1, 1, 1),
                         P.s.make_policy("fcfs"))


# ------------------------------------------- vectorized interference math
def test_vectorized_sensitivity_matches_scalar():
    def scenario(P):
        prof = P.profile(0.4)
        lois = np.linspace(0.0, 0.9, 16)
        return prof, prof.sensitivity_vec(lois), np.array(
            [prof.sensitivity(float(x)) for x in lois])

    _, vec, scalar = _both(scenario)
    np.testing.assert_allclose(vec, scalar, rtol=1e-12)


def test_progress_rates_match_sensitivity():
    def scenario(P):
        profs = [P.profile(r) for r in (0.1, 0.4, 0.8)]
        inj = np.array([p.injected_loi() for p in profs])
        bg = P.itf.background_lois(inj)
        rates = P.itf.progress_rates(
            np.array([p.t_pool for p in profs]),
            np.array([p.t_local for p in profs]),
            np.array([p.t_compute for p in profs]), bg)
        return rates, np.array([p.sensitivity(float(b))
                                for p, b in zip(profs, bg)])

    rates, expected = _both(scenario)
    np.testing.assert_allclose(rates, expected, rtol=1e-12)
    assert ((rates > 0.0) & (rates <= 1.0 + 1e-12)).all()


# --------------------------------------------------- the other streams
def test_synthetic_profile_and_serving_stream():
    def scenario(P):
        if P is T:
            with _priced_on_v5e():
                prof = tsched.synthetic_profile(0.6, 2e-3, 5e8)
        else:
            prof = jsched.synthetic_profile(0.6, 2e-3, 5e8)
        jobs = P.work.serving_stream(20, prof, seed=4, arrival_rate=2.0,
                                     steps=(100, 300), name="svc")
        return prof, jobs

    prof, jobs = _both(scenario)
    assert all(j.injected_loi == pytest.approx(prof.injected_loi())
               for j in jobs)
    assert jobs[0].name == "svc#0"


def test_fleet_request_stream_equals_reference():
    reqs = _both(lambda P: P.work.fleet_request_stream(
        40, 97, seed=6, cancel_fraction=0.25))
    assert {r.tenant for r in reqs} == {"batch", "interactive"}
    assert any(r.cancel_at is not None for r in reqs)
    with pytest.raises(ValueError):
        twork.fleet_request_stream(4, 97, cancel_fraction=1.5)


def test_catalog_stream_equals_reference():
    """`catalog_stream` over two archs and two shapes: the port's
    profiles priced as the reference prices them (v5e chip and topology,
    256 chips) give the reference's jobs."""
    kw = dict(seed=2, shapes=("decode_32k", "train_4k"),
              archs=("smollm_360m", "granite_3_2b"), pool_fraction=0.5,
              work_scale=0.02)
    with _priced_on_v5e():
        t = twork.catalog_stream(12, **kw)
    j = jwork.catalog_stream(12, **kw)
    _same(t, j)
    assert {job.name.split("#")[0] for job in t} <= {
        f"{a}:{s}" for a in kw["archs"] for s in kw["shapes"]}


def test_toy_scheduler_and_fig13_monte_carlo():
    """`sched.scheduler`: the random and aware one-shot placements, the
    aware batch mode, and the Fig 13 Monte-Carlo with its five-number
    summary, equal to the reference's."""
    def scenario(P):
        jobs = [P.toy.Job(f"w{i}", P.profile(r), steps=240)
                for i, r in enumerate((0.05, 0.6, 0.3, 0.8, 0.1, 0.45))]
        rnd = P.toy.RandomScheduler(3, 2, seed=1)
        placed_r = [rnd.place(j).pool_id for j in jobs]
        aware = P.toy.InterferenceAwareScheduler(3, 2)
        ok = aware.place_all(jobs)
        placed_a = [[j.name for j in p.jobs] for p in aware.pools]
        runs = {rng: P.toy.simulate_colocation(jobs[3], 50, loi_range=rng,
                                               seed=1)
                for rng in ((0.0, 0.5), (0.0, 0.2))}
        return (placed_r, ok, placed_a, runs,
                {k: P.toy.five_number_summary(v) for k, v in runs.items()},
                [j.ic for j in jobs])

    placed_r, ok, _, runs, summ, _ = _both(scenario)
    assert ok and len(placed_r) == 6
    assert summ[(0.0, 0.2)]["p75"] <= summ[(0.0, 0.5)]["p75"]


def test_schedule_jobs_example_runs():
    """`examples/schedule_jobs_torch.py` (its `main` with a small trace):
    every policy simulated, the Fig 13 lines printed."""
    spec = importlib.util.spec_from_file_location(
        "schedule_jobs_torch", ROOT / "examples" / "schedule_jobs_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lines = []
    results = mod.main(n_jobs=40, archs=("smollm_360m", "granite_3_2b"),
                       out=lines.append)
    assert set(results) == set(tsched.DEFAULT_POLICIES)
    assert any(line.lstrip().startswith("Fig13") for line in lines)
    for r in results.values():
        assert np.isfinite(r.finish).all()


# ------------------------------------ the engine's measured profile
def _engine_pair():
    jc = dataclasses.replace(jconfigs.reduced("smollm_360m"),
                             dtype="float32")
    tc = dataclasses.replace(tconfigs.reduced("smollm_360m"),
                             dtype="float32")
    jparams, _ = JM.init_model(jc, jax.random.PRNGKey(0))
    tparams = load_numpy_params(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    kw = dict(n_slots=2, max_seq=48, prefill_buckets=(16,), page_tokens=8,
              hot_window=8, local_budget_frac=0.3, admission="greedy")
    jeng = JServingEngine.build(jc, CTX, JEngineConfig(**kw),
                                params=jparams)
    teng = ServingEngine.build(tc, EngineConfig(**kw), params=tparams,
                               topo=REF, chip=_ref_chip(), device="cpu")
    return jc, jeng, teng


def _burst(cls, n, vocab, prompt_len, gen, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(request_id=i,
                tokens=rng.integers(0, vocab, prompt_len).astype(np.int32),
                max_new_tokens=gen, arrival=0.0)
            for i in range(n)]


def test_measured_profile_feeds_scheduler():
    """The reference's closed loop on both packages: before any step the
    profile raises; after a burst the port's measured profile equals the
    JAX engine's (per-step pool and local bytes, compute time, injected
    LoI, IC), and `serving_stream` + `simulate` on it give the
    reference's results; co-located serving jobs stretch each other when
    the profile is loud."""
    jc, jeng, teng = _engine_pair()
    for eng in (teng, jeng):
        with pytest.raises(RuntimeError):
            eng.measured_profile()
    jeng.run(_burst(JRequest, 4, jc.vocab_size, 16, 8, seed=9))
    teng.run(_burst(Request, 4, jc.vocab_size, 16, 8, seed=9))
    tprof, jprof = teng.measured_profile(), jeng.measured_profile()
    assert tprof.shape == jprof.shape == "serve_measured"
    for k in ("pool_traffic", "local_traffic", "t_compute", "t_pool",
              "t_local"):
        assert getattr(tprof, k) == pytest.approx(getattr(jprof, k),
                                                  rel=1e-9), k
    assert tprof.injected_loi() == pytest.approx(jprof.injected_loi(),
                                                 rel=1e-9)
    assert tprof.interference_coefficient() == pytest.approx(
        jprof.interference_coefficient(), rel=1e-9)
    assert tprof.pool_traffic >= 0 and tprof.t_compute > 0
    assert 0.0 <= tprof.injected_loi() <= 1.0

    def loop(P, prof):
        jobs = P.work.serving_stream(12, prof, seed=0, arrival_rate=50.0,
                                     steps=(200, 400))
        cluster = P.s.build_cluster(n_racks=1, pools_per_rack=1,
                                    nodes_per_pool=4)
        return jobs, P.s.simulate(jobs, cluster, P.s.make_policy("fcfs"))

    (tjobs, tres), (jjobs, jres) = loop(T, tprof), loop(J, jprof)
    assert [j.work for j in tjobs] == pytest.approx(
        [j.work for j in jjobs], rel=1e-9)
    np.testing.assert_allclose(tres.finish, jres.finish, rtol=1e-9)
    np.testing.assert_array_equal(tres.pool_of, jres.pool_of)
    assert all(j.injected_loi == pytest.approx(tprof.injected_loi())
               for j in tjobs)
    assert np.all(tres.finish >= tres.start)
    if tprof.injected_loi() > 0.05:
        assert float(tres.slowdown.max()) > 1.0


def test_measured_profile_on_the_port_defaults():
    """On the port's own defaults (one H100 and its topology) the profile
    is priced with the engine's topology and chip: per-step bytes as the
    pager counted them, compute at the H100's bf16 peak."""
    tc = dataclasses.replace(tconfigs.reduced("smollm_360m"),
                             dtype="float32")
    eng = ServingEngine.build(
        tc, EngineConfig(n_slots=2, max_seq=48, prefill_buckets=(16,),
                         page_tokens=8, hot_window=8,
                         local_budget_frac=0.3, admission="greedy",
                         prefetch="stream", cold_touch=0.2),
        device="cpu")
    eng.run(_burst(Request, 4, tc.vocab_size, 16, 8, seed=9))
    prof = eng.measured_profile()
    c = eng.pager.counters()
    assert prof.topo is eng.topo
    assert eng.topo.pool.bandwidth == ttiers.h100_topology().pool.bandwidth
    assert prof.pool_traffic == pytest.approx(c["pool_bytes"] / eng.steps)
    assert prof.t_compute == pytest.approx(eng._t_compute_s / eng.steps)
    # arrivals on the jobs' own time scale (a reduced model's step is
    # tens of nanoseconds at the H100's peak), so they overlap
    jobs = twork.serving_stream(6, prof, seed=1, steps=(50, 100),
                                arrival_rate=1.0 / (50 * prof.step_time()))
    res = tsched.simulate(jobs, tsched.build_cluster(1, 1, 2),
                          tsched.make_policy("aware"))
    assert np.isfinite(res.slowdown).all() and (res.slowdown >= 1 - 1e-9).all()

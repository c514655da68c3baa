"""The port's prefetch subsystem (`repro_torch.prefetch`) and the pager's
prediction-driven page-in against the reference package (`repro.prefetch`,
`repro.serving.kv_pager`).

Every case of `tests/test_prefetch.py` runs on both packages from the
same seed: the traces (touch streams and hints) and the pages each
predictor returns at every step are equal, every `PrefetchReport` field
and metric agrees to 1e-12, and the reference case's own assertions hold
on the port's result. The pager's prefetch cases of
`tests/test_serving.py` (demand share, the recorder, the engine with a
predictor, the excess fed to admission) compare counters and touch
streams with the reference pager's; a reduced smollm engine (float32, fp
pool, substrate "auto", emulated on the CPU) with `prefetch` in demand,
stream, next_line, ghb and adaptive, with and without n-gram
speculation, matches the JAX engine's tokens, every pager counter and
the virtual times to 1e-9. `scan_with_prefetch` on the CPU equals a plain
loop over the layers and the reference's scan.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.prefetch as jpf  # noqa: E402
import repro_torch.prefetch as tpf  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.common import hw as jhw  # noqa: E402
from repro.common.parallel import ParallelCtx  # noqa: E402
from repro.core import access as jacc  # noqa: E402
from repro.core import tiers as jtiers  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.prefetch import static as jstatic  # noqa: E402
from repro.prefetch.predictors import StaticSchedulePredictor as JStatic  # noqa: E402,E501
from repro.runtime import serve as jserve  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import KVPager as JKVPager  # noqa: E402
from repro.serving import PagerConfig as JPagerConfig  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro.serving import long_context_stream as jlong  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.common import hw as thw  # noqa: E402
from repro_torch.core import access as tacc  # noqa: E402
from repro_torch.core import tiers as ttiers  # noqa: E402
from repro_torch.models.module import load_numpy_params  # noqa: E402
from repro_torch.prefetch import static as tstatic  # noqa: E402
from repro_torch.prefetch.predictors import StaticSchedulePredictor as TStatic  # noqa: E402,E501
from repro_torch.serving import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.serving import KVPager, PagerConfig  # noqa: E402
from repro_torch.serving import long_context_stream  # noqa: E402

J = types.SimpleNamespace(pf=jpf, static=jstatic, Static=JStatic,
                          access=jacc, KVPager=JKVPager,
                          PagerConfig=JPagerConfig)
T = types.SimpleNamespace(pf=tpf, static=tstatic, Static=TStatic,
                          access=tacc, KVPager=KVPager,
                          PagerConfig=PagerConfig)
TOL = 1e-12
CTX = ParallelCtx(remat="none")


# ---------------------------------------------------------- comparison
def _same(a, b, path="") -> None:
    """Equal structures: reports field by field and metric by metric
    (floats to TOL), traces exactly, the recorded predictions exactly."""
    if hasattr(a, "accuracy") and dataclasses.is_dataclass(a):
        _same(dataclasses.asdict(a), dataclasses.asdict(b), path)
        for k in ("accuracy", "coverage", "timeliness", "excess",
                  "excess_bytes", "remote_accesses", "remote_bytes"):
            _same(getattr(a, k), getattr(b, k), f"{path}.{k}")
        _same(a.summary(), b.summary(), f"{path}.summary")
        _same(getattr(a, "preds", None), getattr(b, "preds", None),
              f"{path}.preds")
    elif dataclasses.is_dataclass(a) and not isinstance(a, type):
        _same(dataclasses.asdict(a), dataclasses.asdict(b), path)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=TOL, abs=TOL), path
    else:
        assert a == b, path


def _both(fn):
    """`fn(pkg)` on the port and on the reference; equal results (see
    `_same`). Returns the port's."""
    t, j = fn(T), fn(J)
    _same(t, j)
    return t


class _Spy:
    """Records every `predict` answer of a predictor (the pages it asks
    the engine to fetch), delegating everything else."""

    def __init__(self, inner):
        self.inner = inner
        self.name = inner.name
        self.log = []

    def start_step(self, hint=None):
        self.inner.start_step(hint)

    def observe(self, page):
        self.inner.observe(page)

    def predict(self, degree):
        out = self.inner.predict(degree)
        self.log.append(list(out))
        return out


def _trace(P, steps, n_pages=1 << 20, hints=None, page_bytes=4096.0):
    return P.pf.AccessTrace("t", "test", page_bytes, n_pages, steps,
                            hints=hints).validate()


def _run(P, steps, predictor, local=64, bw=16, degree=8, hints=None,
         n_pages=1 << 20):
    eng = P.pf.PrefetchEngine(P.pf.PrefetchConfig(
        local_pages=local, bw_pages_per_step=bw, degree=degree))
    spy = _Spy(predictor)
    r = eng.run(_trace(P, steps, n_pages, hints), spy)
    r.preds = spy.log
    return r


def _engine_run(P, trace, cfg, predictor):
    spy = _Spy(predictor)
    r = P.pf.PrefetchEngine(cfg).run(trace, spy)
    r.preds = spy.log
    return r


# ----------------------------------------------------------- predictors
def test_stride_predictor_nails_constant_stride():
    steps = [[100 + 3 * i] for i in range(64)]
    r = _both(lambda P: _run(P, steps, P.pf.make_predictor("stride")))
    assert r.accuracy > 0.85
    assert r.timeliness == pytest.approx(1.0)
    assert r.excess < 0.15
    assert r.demand_misses <= 4
    assert r.coverage > 0.9


def test_next_line_on_sequential_and_strided():
    seq = [[i] for i in range(64)]
    strided = [[5 * i] for i in range(64)]
    a, b = _both(lambda P: (
        _run(P, seq, P.pf.make_predictor("next_line")),
        _run(P, strided, P.pf.make_predictor("next_line"), degree=4)))
    assert a.coverage > 0.9
    assert b.coverage == 0.0
    assert b.excess == pytest.approx(1.0)


def test_stream_predictor_untangles_interleaved_streams():
    steps = [[i, 1_000_000 + 2 * i] for i in range(64)]
    a, b = _both(lambda P: (_run(P, steps, P.pf.make_predictor("stream")),
                            _run(P, steps, P.pf.make_predictor("stride"))))
    assert a.coverage > 0.85
    assert b.coverage < 0.5


def test_markov_predictor_learns_repeating_cycle():
    cycle = [7, 3, 11, 5, 2, 19, 13, 31, 23, 41, 37, 29]
    steps = [[cycle[i % len(cycle)]] for i in range(120)]
    a, b = _both(lambda P: (
        _run(P, steps, P.pf.make_predictor("markov"), local=4, degree=2),
        _run(P, steps, P.pf.make_predictor("stride"), local=4)))
    assert a.accuracy > 0.9
    assert a.coverage > 0.8
    assert b.coverage == 0.0


def test_adversarial_random_stream_defeats_learned_predictors():
    rng = np.random.default_rng(0)
    steps = [[int(p)] for p in rng.integers(0, 1 << 16, 256)]
    names = ("next_line", "stride", "stream", "markov")
    *learned, static = _both(lambda P: [
        _run(P, steps, P.pf.make_predictor(n), local=16) for n in names
    ] + [_run(P, steps, P.Static([s for s in steps]), local=16)])
    for name, r in zip(names, learned):
        assert r.coverage < 0.1, name
    assert static.accuracy == pytest.approx(1.0)
    assert static.coverage > 0.95


def test_static_predictor_accuracy_one_on_layer_stream():
    def scenario(P):
        t = P.static.layer_stream_trace(8, 4, epochs=3)
        cfg = P.pf.PrefetchConfig(local_pages=8, bw_pages_per_step=8,
                                  degree=4)
        return (t, _engine_run(P, t, cfg, P.pf.make_predictor(
                    "static", schedule=t.steps)),
                _engine_run(P, t, cfg, P.pf.make_predictor("demand")))

    _, r, base = _both(scenario)
    assert r.accuracy == pytest.approx(1.0)
    assert r.excess == pytest.approx(0.0)
    assert r.timeliness == pytest.approx(1.0)
    assert r.remote_accesses < base.remote_accesses


def test_frontier_predictor_uses_hints_only():
    rng = np.random.default_rng(1)
    steps = [[int(p) for p in rng.integers(0, 4096, 4)] for _ in range(50)]
    hints = steps[1:] + [[]]
    with_h, no_h = _both(lambda P: (
        _run(P, steps, P.pf.make_predictor("frontier"), hints=hints,
             n_pages=4096, local=32, bw=16, degree=8),
        _run(P, steps, P.pf.make_predictor("frontier"), n_pages=4096,
             local=32)))
    assert with_h.accuracy == pytest.approx(1.0)
    assert with_h.coverage > 0.8
    assert no_h.issued == 0


def test_make_predictor_unknown_name():
    for P in (T, J):
        with pytest.raises(ValueError):
            P.pf.make_predictor("oracle9000")
    assert tpf.zoo_names() == jpf.zoo_names()
    assert tpf.zoo_names(False) == jpf.zoo_names(False)


# -------------------------------------------------------------- engine
def test_engine_metric_invariants():
    def scenario(P):
        t = P.pf.sched_pool_trace(3, steps=80, pages_per_job=64)
        cfg = P.pf.PrefetchConfig(local_pages=24, bw_pages_per_step=8,
                                  degree=8)
        return t, cfg, P.pf.evaluate_zoo(t, cfg)

    t, cfg, reports = _both(scenario)
    for r in reports:
        assert 0.0 <= r.accuracy <= 1.0
        assert 0.0 <= r.coverage <= 1.0
        assert 0.0 <= r.excess <= 1.0
        assert r.useful + r.late <= r.issued
        assert r.local_hits + r.demand_misses + r.late == t.touches
        assert r.remote_accesses <= t.touches
        assert r.total_time >= cfg.t_compute * t.n_steps


def test_engine_bandwidth_cap_limits_prefetch():
    steps = [[4 * i + j for j in range(4)] for i in range(32)]
    tight, loose = _both(lambda P: (
        _run(P, steps, P.pf.make_predictor("next_line"), bw=4, degree=8),
        _run(P, steps, P.pf.make_predictor("next_line"), bw=12, degree=8)))
    assert tight.issued == 0
    assert loose.issued > 0 and loose.coverage > 0.8
    assert tight.local_hits + tight.demand_misses + tight.late == 128


def test_pool_latency_makes_shallow_prefetch_late():
    steps = [[i] for i in range(64)]

    def scenario(P):
        cfg = P.pf.PrefetchConfig(local_pages=64, bw_pages_per_step=16,
                                  degree=1, latency_steps=2)
        deep = dataclasses.replace(cfg, degree=8)
        t = _trace(P, steps)
        return (_engine_run(P, t, cfg, P.pf.make_predictor("next_line")),
                _engine_run(P, t, cfg, P.pf.make_predictor("demand")),
                _engine_run(P, t, deep, P.pf.make_predictor("next_line")))

    shallow, base, deep = _both(scenario)
    assert shallow.late > 0 and shallow.useful == 0
    assert shallow.accuracy > 0.95
    assert shallow.timeliness == 0.0
    assert shallow.coverage == 0.0
    assert shallow.remote_accesses == base.remote_accesses
    assert deep.timeliness > 0.9
    assert deep.coverage > 0.9
    assert deep.remote_accesses < shallow.remote_accesses


def test_demand_baseline_never_prefetches():
    def scenario(P):
        t = P.pf.kv_pager_trace(steps=32)
        return t, _engine_run(P, t, P.pf.PrefetchConfig(16, 8),
                              P.pf.make_predictor("demand"))

    _, r = _both(scenario)
    assert r.issued == 0 and r.accuracy == 0.0


def test_prefetch_config_validation():
    for P in (T, J):
        with pytest.raises(ValueError):
            P.pf.PrefetchConfig(local_pages=0, bw_pages_per_step=1)
        with pytest.raises(ValueError):
            P.pf.PrefetchConfig(local_pages=1, bw_pages_per_step=1,
                                latency_steps=0)


# ------------------------------------------------------ trace capture
def test_kv_pager_trace_shape_and_determinism():
    a, b = _both(lambda P: (P.pf.kv_pager_trace(steps=48),
                            P.pf.kv_pager_trace(steps=48)))
    assert a.steps == b.steps
    assert a.n_steps == 48
    assert a.source == "serving"
    assert all(0 <= p < a.n_pages for s in a.steps for p in s)


def test_trace_recorder_roundtrip():
    def scenario(P):
        rec = P.pf.TraceRecorder()
        rec.record([1, 2])
        rec.record([])
        rec.record(iter([3]))
        t = rec.to_trace("x", "test", 128.0, 8)
        rec.record([99])
        with pytest.raises(ValueError):
            rec.to_trace("x", "test", 128.0, 8)
        return t

    t = _both(scenario)
    assert t.steps == [[1, 2], [], [3]]


def test_sched_pool_trace_streams_are_sequential_per_job():
    t = _both(lambda P: P.pf.sched_pool_trace(2, steps=50, pages_per_job=64,
                                              seed=3))
    per_job = {0: [], 1: []}
    for s in t.steps:
        for p in s:
            per_job[p // 64].append(p % 64)
    for j, pages in per_job.items():
        assert pages, f"job {j} silent"
        assert set(np.unique(np.diff(pages))) <= {1, 1 - 64}


def test_bfs_trace_hints_are_next_step():
    b = _both(lambda P: P.pf.bfs_trace(n_vertices=512, avg_degree=8,
                                       page_bytes=256, chunk=16))
    t = b.trace
    assert t.hints is not None
    assert t.hints[:-1] == t.steps[1:]
    assert t.hints[-1] == []
    assert sum(len(lv) for lv in b.levels) <= b.n_vertices


def test_random_csr_and_bfs_levels_equal_reference():
    (ip, ix), levels = _both(lambda P: (
        P.pf.random_csr(300, 6, seed=4),
        P.pf.bfs_levels(*P.pf.random_csr(300, 6, seed=4), src=5)))
    assert ip[-1] == len(ix) and levels[0].tolist() == [5]


# ----------------------------------------------- BFS case study (§7.1)
def test_bfs_frontier_prefetch_cuts_remote_access_40pct():
    def scenario(P):
        t = P.pf.bfs_trace(n_vertices=8192, avg_degree=16, page_bytes=1024,
                           chunk=32).trace
        cfg = P.pf.PrefetchConfig(local_pages=max(8, t.n_pages // 16),
                                  bw_pages_per_step=40, degree=40)
        reports = P.pf.evaluate_zoo(
            t, cfg, predictors=["demand", "next_line", "stream", "frontier"])
        return reports, [P.pf.remote_reduction(reports, n)
                         for n in ("frontier", "next_line", "stream")]

    reports, (red, nl, st) = _both(scenario)
    assert red >= 0.40, f"frontier reduction {red:.2f} < 0.40"
    assert nl < 0.20
    assert st < 0.20
    base = next(r for r in reports if r.predictor == "demand")
    front = next(r for r in reports if r.predictor == "frontier")
    assert front.total_time < base.total_time


def test_excess_feedback_inflates_pool_traffic():
    def scenario(P):
        prof = [P.access.TensorAccess("x", 1000, 1.0, "param")]
        out = P.access.with_prefetch_excess(prof, 500.0)
        return (out, sum(a.traffic for a in out),
                P.access.with_prefetch_excess(prof, 0.0) == prof)

    _, total, same = _both(scenario)
    assert total == 1500 and same


# ------------------------------------------------------------------ GHB
def test_ghb_learns_second_order_delta_pattern():
    steps, page = [], 100
    for i in range(96):
        page += 1 if i % 2 == 0 else 3
        steps.append([page])
    ghb, stride = _both(lambda P: (_run(P, steps, P.pf.make_predictor("ghb")),
                                   _run(P, steps,
                                        P.pf.make_predictor("stride"))))
    assert ghb.accuracy > 0.85
    assert ghb.coverage > 0.8
    assert stride.coverage < 0.2
    assert ghb.remote_accesses < stride.remote_accesses


def test_ghb_runs_delta_chain_deep():
    steps = [[7 * i] for i in range(64)]
    r = _both(lambda P: _run(P, steps, P.pf.make_predictor("ghb"), degree=4))
    assert r.accuracy > 0.85
    assert r.coverage > 0.8


def _pager_run(P, pf, steps=120, recorder=False):
    """The reference's two-slot pager scenario (400-token slots, 256-token
    prompts, 8-token pages, a 4-page budget) under `pf`; returns the
    counters and, with `recorder`, the touch stream."""
    pcfg = P.PagerConfig(page_tokens=8, local_budget_bytes=4 * 8 * 100.0,
                         policy="hotness", hot_window=16, cold_touch=0.1,
                         prefetch=pf, prefetch_degree=8)
    p = P.KVPager(2, 400, bytes_per_token=100.0, resident_bytes=0.0,
                  pcfg=pcfg)
    if recorder:
        p.recorder = P.pf.TraceRecorder()
    p.admit(0, 256)
    p.admit(1, 256)
    for _ in range(steps):
        p.step(np.array([True, True]))
    return p.counters(), (p.recorder.steps if recorder else None)


def test_ghb_in_zoo_sweep_and_pager():
    def scenario(P):
        t = _trace(P, [[10 * i, 10 * i + 1] for i in range(48)],
                   n_pages=1024)
        reports = P.pf.evaluate_zoo(
            t, P.pf.PrefetchConfig(local_pages=16, bw_pages_per_step=8,
                                   degree=4))
        return reports, _pager_run(P, "ghb")

    reports, (c, _) = _both(scenario)
    assert any(r.predictor == "ghb" for r in reports)
    assert c["prefetch_useful"] > 0
    assert c["demand_share"] < 1.0


# ------------------------------------------------- adaptive switching
def _phased_trace():
    steps = [[1000 + i] for i in range(80)]
    cycle = [200, 210, 220, 500, 510, 520, 900, 910, 920, 40, 50, 60]
    for _ in range(8):
        steps.extend([[p] for p in cycle])
    return steps


def test_adaptive_switcher_beats_best_fixed_candidate():
    steps = _phased_trace()
    kw = dict(local=8, bw=4, degree=2)
    names = tpf.AdaptiveSwitcher.CANDIDATES
    assert names == jpf.AdaptiveSwitcher.CANDIDATES
    fixed, adaptive = _both(lambda P: (
        {n: _run(P, steps, P.pf.make_predictor(n), **kw) for n in names},
        _run(P, steps, P.pf.make_predictor("adaptive"), **kw)))
    best = min(r.remote_accesses for r in fixed.values())
    assert adaptive.remote_accesses <= best
    assert adaptive.coverage > 0.5


def _switcher_state(sw):
    return dict(active=sw.active, switches=sw.switches,
                accuracies=sw.accuracies(),
                names=[c.name for c in sw.candidates])


def test_adaptive_switcher_shadow_scores_and_switches():
    def scenario(P):
        sw = P.pf.make_predictor("adaptive", phase_steps=8, window=32, ttl=4)
        assert isinstance(sw, P.pf.AdaptiveSwitcher)
        assert sw.active == 0 and sw.switches == 0
        r = _run(P, _phased_trace(), sw, local=8, bw=4, degree=2)
        return r, _switcher_state(sw)

    _, s = _both(scenario)
    assert s["switches"] >= 1
    assert s["names"][s["active"]] == "markov"
    assert s["accuracies"][s["active"]] == max(s["accuracies"])


def test_adaptive_switcher_tie_keeps_incumbent():
    def scenario(P):
        sw = P.pf.AdaptiveSwitcher(phase_steps=4)
        r = _run(P, [[100 + i] for i in range(40)], sw, local=8, bw=4,
                 degree=2)
        return r, _switcher_state(sw)

    _, s = _both(scenario)
    assert s["names"][s["active"]] == "next_line"
    assert s["switches"] == 0


def test_adaptive_switcher_validation_and_pager_acceptance():
    for P in (T, J):
        with pytest.raises(ValueError, match="candidate"):
            P.pf.AdaptiveSwitcher(candidates=[])
        with pytest.raises(ValueError, match=">= 1"):
            P.pf.AdaptiveSwitcher(window=0)
        P.PagerConfig(page_tokens=8, prefetch="adaptive")
        with pytest.raises(ValueError, match="static"):
            P.PagerConfig(page_tokens=8, prefetch="static")


# ------------------------------------- the pager's prediction-driven page-in
def test_pager_prefetch_cuts_demand_share():
    """`tests/test_serving.py::test_pager_prefetch_cuts_demand_share` on
    both pagers, every predictor the pager takes: counters and touch
    streams equal the reference's; stream and next_line cut the demand
    share against the demand baseline."""
    names = ("demand", "next_line", "stride", "stream", "markov", "ghb",
             "adaptive")
    out = _both(lambda P: {pf: _pager_run(P, pf, recorder=True)
                           for pf in names})
    shares = {pf: c["demand_share"] for pf, (c, _) in out.items()}
    for pf, (c, touches) in out.items():
        assert touches and all(touches), pf
        if pf == "demand":
            assert c["prefetch_issued"] == 0
        elif pf in ("next_line", "stream"):
            assert 0 < c["prefetch_useful"] <= c["prefetch_issued"]
        assert (c["demand_pool_bytes"] + c["prefetch_pool_bytes"]
                == pytest.approx(c["pool_bytes"]))
    assert shares["stream"] < shares["demand"]
    assert shares["next_line"] < shares["demand"]


@pytest.mark.parametrize("name", ["frontier", "static", "oracle"])
def test_pager_prefetch_invalid_name(name):
    for P in (T, J):
        with pytest.raises(ValueError):
            P.PagerConfig(prefetch=name)


def test_pager_recorder_captures_touch_stream():
    def scenario(P):
        pcfg = P.PagerConfig(page_tokens=8, policy="none", hot_window=16,
                             cold_touch=0.1)
        p = P.KVPager(2, 128, bytes_per_token=100.0, resident_bytes=0.0,
                      pcfg=pcfg)
        p.recorder = P.pf.TraceRecorder()
        p.admit(0, 100)
        for _ in range(10):
            p.step(np.array([True, False]))
        t = p.recorder.to_trace("pager", "serving", p.page_bytes,
                                2 * p.n_pages)
        return t, p._page_of(int(p.lengths[0]) - 1), p.n_pages

    t, tail, n_pages = _both(scenario)
    assert t.n_steps == 10
    assert t.touches > 0
    assert all(any(g % n_pages >= tail - 2 for g in s) for s in t.steps)


@pytest.mark.parametrize("policy", ["hotness", "static"])
def test_pager_staged_pruned_by_truncate_release_and_rebalance(policy):
    """The three places that prune the staged set: speculation's
    `truncate`, a slot's `release` and `rebalance` (a promoted page's
    stage is moot). Every fifth step is a speculative verify: the
    engine's `ensure_tail_pages(lookahead=24)` maps three pages past the
    tail, the step commits 2 tokens for the last active slot and
    `truncate` drops the rest — pages next_line has staged (pool pages
    under `static`); slot 2 is released half way. On both pagers, after each step the
    staged sets and counters equal the reference's, and no staged entry
    names a page that is not a valid pool page."""
    def scenario(P):
        pcfg = P.PagerConfig(page_tokens=8, local_budget_bytes=4 * 8 * 100.0,
                             policy=policy, hot_window=16, cold_touch=0.2,
                             prefetch="next_line", prefetch_degree=8)
        p = P.KVPager(3, 400, bytes_per_token=100.0, resident_bytes=0.0,
                      pcfg=pcfg)
        for s, n in ((0, 256), (1, 200), (2, 120)):
            p.admit(s, n)
        snaps = []
        act, last = np.array([True, True, True]), 2
        for i in range(60):
            spec = i % 5 == 0
            if spec:
                p.ensure_tail_pages(act, lookahead=24)
            p.step(act, tokens=np.where(np.arange(3) == last, 2, 1)
                   if spec else None)
            if spec:
                for s in np.nonzero(act)[0]:
                    p.truncate(int(s))
            if i == 30:
                p.release(2)
                act, last = np.array([True, True, False]), 1
            staged = sorted(p._staged)
            for s, pg in staged:
                assert p.valid[s, pg] and p.tier_phys[p.phys[s, pg]] == 1
            snaps.append((staged, p.counters()))
        return snaps

    snaps = _both(scenario)
    assert any(staged for staged, _ in snaps)
    assert snaps[-1][1]["prefetch_issued"] > snaps[-1][1]["prefetch_useful"]


# ------------------------------------------------ scan_with_prefetch
def test_scan_with_prefetch_matches_plain_loop():
    """`tests/test_substrate.py::test_scan_with_prefetch_matches_plain_scan`
    on the port: equal to a plain loop bit for bit, and to the reference's
    scan_with_prefetch to float32 rounding."""
    L, d = 6, 16
    ws = np.array(jax.random.normal(jax.random.PRNGKey(0), (L, d, d)))
    bs = np.array(jax.random.normal(jax.random.PRNGKey(1), (L, d)))
    x0 = np.ones((d,), np.float32)

    def tbody(x, layer):
        y = torch.tanh(x @ layer["w"] + layer["b"])
        return y, y.sum()

    def jbody(x, layer):
        y = jnp.tanh(x @ layer["w"] + layer["b"])
        return y, y.sum()

    stacked = {"w": torch.from_numpy(ws), "b": torch.from_numpy(bs)}
    mask = {"w": True, "b": False}
    y1, outs1 = tstatic.scan_with_prefetch(tbody, torch.from_numpy(x0),
                                           stacked, mask, L)
    x, outs2 = torch.from_numpy(x0), []
    for i in range(L):
        x, o = tbody(x, {"w": stacked["w"][i], "b": stacked["b"][i]})
        outs2.append(o)
    assert torch.equal(y1, x)
    assert torch.equal(outs1, torch.stack(outs2))
    assert outs1.shape == (L,)
    jy, jouts = jstatic.scan_with_prefetch(
        jbody, jnp.asarray(x0), {"w": jnp.asarray(ws), "b": jnp.asarray(bs)},
        mask, L)
    np.testing.assert_allclose(y1.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(outs1.numpy(), np.asarray(jouts), rtol=1e-5,
                               atol=1e-5)


def test_scan_with_prefetch_none_outputs_and_nested_trees():
    """A body that returns no per-layer output (the reference's jit case)
    gives None outs; nested dicts of outputs stack leaf by leaf; a mask
    whose keys come in another order still pairs by key."""
    L, d = 4, 8
    stacked = {"w": torch.ones((L, d, d)), "n": {"g": torch.arange(
        L * d, dtype=torch.float32).reshape(L, d)}}
    mask = {"n": {"g": False}, "w": True}
    y, outs = tstatic.scan_with_prefetch(
        lambda x, p: (x @ p["w"] + p["n"]["g"], None), torch.ones(d),
        stacked, mask, L)
    assert outs is None and bool(torch.isfinite(y).all())
    _, outs = tstatic.scan_with_prefetch(
        lambda x, p: (x, {"a": {"g": p["n"]["g"][0], "w": p["w"].sum()}}),
        torch.ones(d), stacked, mask, L)
    assert outs["a"]["g"].tolist() == [float(i * d) for i in range(L)]
    assert outs["a"]["w"].tolist() == [float(d * d)] * L


def test_layer_stream_trace_equals_reference():
    _both(lambda P: P.static.layer_stream_trace(5, 3, epochs=2,
                                                page_bytes=512.0))


# ------------------------------------------------- the engine vs JAX
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


_BASE = dict(n_slots=2, max_seq=96, prefill_buckets=(64,), page_tokens=8,
             hot_window=16, local_budget_frac=0.4, admission="greedy",
             cold_touch=0.1, pool_dtype="fp", substrate="auto")


@pytest.fixture(scope="module")
def jax_side():
    """The reference's reduced smollm (float32), its weights as torch
    tensors, and its compiled cells for greedy and n-gram decoding —
    built once; each test wraps them in fresh engines."""
    jc = dataclasses.replace(jconfigs.reduced("smollm_360m"),
                             dtype="float32")
    tc = dataclasses.replace(tconfigs.reduced("smollm_360m"),
                             dtype="float32")
    jparams, _ = JM.init_model(jc, jax.random.PRNGKey(0))
    tparams = load_numpy_params(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    cells = {}
    for spec in ("off", "ngram"):
        cells[spec] = jserve.make_engine_cells(
            jc, CTX, None, None, n_slots=_BASE["n_slots"],
            max_seq=_BASE["max_seq"], buckets=_BASE["prefill_buckets"],
            enc_len=0, paged=True, page_tokens=_BASE["page_tokens"],
            prefill_chunk=0, pool_dtype="fp", sz_granularity="page",
            speculative=spec, spec_k=4, draft_cfg=None)
    return jc, tc, jparams, tparams, cells


def _engines(jax_side, **kw):
    jc, tc, jparams, tparams, cells = jax_side
    kw = dict(_BASE, **kw)
    jecfg = JEngineConfig(**kw)
    jeng = JServingEngine(jc, CTX, jecfg, jparams,
                          cells[jecfg.speculative])
    teng = ServingEngine.build(tc, EngineConfig(**kw), params=tparams,
                               topo=_ref_topology(), chip=_ref_chip(),
                               device="cpu")
    return jc, jeng, teng


def _serve_both(jc, jeng, teng, n=3, seed=2):
    trace = dict(seed=seed, prompt_bucket=64, gen_range=(8, 16),
                 arrival_rate=1e9)
    jreqs = jlong(n, jc.vocab_size, **trace)
    treqs = long_context_stream(n, jc.vocab_size, **trace)
    js, ts = jeng.run(jreqs), teng.run(treqs)
    for j, t in zip(jreqs, treqs):
        assert t.output == j.output, t.request_id
    jsum, tsum = js.summary(), ts.summary()
    jsum.pop("tok_per_s_wall"), tsum.pop("tok_per_s_wall")
    jsub, tsub = dict(js.substrate), dict(ts.substrate)
    assert tsub.pop("mode") == jsub.pop("mode") == "emulated"
    assert tsub == pytest.approx(jsub, rel=1e-9)
    assert tsum == pytest.approx(jsum, rel=1e-9)
    assert ts.pager == pytest.approx(js.pager, rel=1e-9)
    assert teng.virtual_s == pytest.approx(jeng.virtual_s, rel=1e-9)
    assert teng.admission.excess_loi == pytest.approx(
        jeng.admission.excess_loi, rel=1e-9, abs=1e-15)
    return ts, treqs


@pytest.mark.parametrize("speculative", ["off", "ngram"])
@pytest.mark.parametrize("prefetch", ["demand", "stream", "next_line",
                                      "ghb", "adaptive"])
def test_engine_prefetch_matches_reference(jax_side, prefetch, speculative):
    """The reduced engine with each predictor, greedy and speculative,
    substrate "auto": tokens, pager counters (issued, useful, demand and
    staged bytes), substrate counters and virtual times equal the JAX
    engine's. Every pool byte is classified demand or staged."""
    jc, jeng, teng = _engines(jax_side, prefetch=prefetch,
                              speculative=speculative, speculative_k=4)
    assert teng.pager.cfg.prefetch == prefetch
    assert teng.pager._predictor is not None
    ts, _ = _serve_both(jc, jeng, teng)
    c = ts.pager
    assert (c["demand_pool_bytes"] + c["prefetch_pool_bytes"]
            == pytest.approx(c["pool_bytes"]))
    if speculative == "ngram":
        assert ts.spec["verify_steps"] > 0


def test_engine_prefetch_tokens_and_virtual_time(jax_side):
    """`tests/test_serving.py::test_engine_prefetch_tokens_and_virtual_time`
    on the port (against the JAX engine too): the tokens under demand
    paging and under the stream predictor are the same, the demand share
    lower and the virtual clock no slower than 5% above."""
    out = {}
    for pf in ("demand", "stream"):
        jc, jeng, teng = _engines(jax_side, prefetch=pf)
        out[pf] = _serve_both(jc, jeng, teng)
    (dm, dm_reqs), (st, st_reqs) = out["demand"], out["stream"]
    assert [r.output for r in dm_reqs] == [r.output for r in st_reqs]
    assert st.pager["demand_share"] < dm.pager["demand_share"]
    assert st.virtual_s <= dm.virtual_s * 1.05


def test_engine_feeds_pager_excess_to_admission(jax_side):
    """`tests/test_serving.py::test_engine_feeds_pager_excess_to_admission`:
    a speculative pager predictor's excess bytes reach the admission
    controller's excess LoI, as in the JAX engine."""
    jc, jeng, teng = _engines(jax_side, prefetch="next_line",
                              cold_touch=0.2, local_budget_frac=0.3)
    _serve_both(jc, jeng, teng)
    assert teng.pager.counters()["prefetch_excess_bytes"] > 0
    assert teng.admission.excess_loi > 0.0


def test_engine_without_prefetch_has_no_predictor(jax_side):
    jc, jeng, teng = _engines(jax_side)
    assert teng.pager._predictor is None and teng.pager.recorder is None
    ts, _ = _serve_both(jc, jeng, teng)
    assert ts.pager["prefetch_issued"] == 0
    assert ts.pager["demand_pool_bytes"] == 0.0

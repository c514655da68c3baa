"""The port's three-level analysis (`repro_torch.core`) against the
reference's (`repro.core`), priced with the reference's v5e chip and
topology converted to the port's types and sharded over 256 chips (the
reference's single-pod mesh): the pure-numpy models equal to 1e-12, the
serve access profile of the port's meta state equal leaf for leaf, and
`analyze` levels 1-3 equal to 1e-9 for every arch of the catalog (the
ten of `configs.list_archs()`) at decode_32k, prefill_32k and train_4k
(the train access profile of the port's meta train state), and the
same three levels through `examples/quickstart_torch.py` on kimi-k2.
Then the port's own defaults: one H100 and its topology."""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.common import hw as jhw  # noqa: E402
from repro.common.config import SHAPES as JSHAPES  # noqa: E402
from repro.core import access as jacc  # noqa: E402
from repro.core import interference as jitf  # noqa: E402
from repro.core import placement as jplc  # noqa: E402
from repro.core import quantify as jq  # noqa: E402
from repro.core import roofline as jrl  # noqa: E402
from repro.core import tiers as jtiers  # noqa: E402
from repro.runtime import serve as jserve  # noqa: E402
from repro.runtime import train as jtrain  # noqa: E402
from repro.serving.engine import AdmissionController as JAdmission  # noqa
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.common import hw as thw  # noqa: E402
from repro_torch.common.config import SHAPES as TSHAPES  # noqa: E402
from repro_torch.core import access as tacc  # noqa: E402
from repro_torch.core import interference as titf  # noqa: E402
from repro_torch.core import placement as tplc  # noqa: E402
from repro_torch.core import quantify as tq  # noqa: E402
from repro_torch.core import roofline as trl  # noqa: E402
from repro_torch.core import tiers as ttiers  # noqa: E402
from repro_torch.runtime import serve as tserve  # noqa: E402
from repro_torch.runtime import train as ttrain  # noqa: E402
from repro_torch.serving.engine import AdmissionController as TAdmission  # noqa

ARCHS = tconfigs.list_archs()
DENSE = [a for a in ARCHS if tconfigs.get(a).family == "dense"]
SERVE_SHAPES = ["decode_32k", "prefill_32k"]
N_CHIPS = 256
TOL = 1e-12


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


def _close(a, b, rel):
    """Equal structures: floats to `rel` (relative, absolute near 0),
    everything else exactly."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k], rel)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, rel)
    elif isinstance(a, (bool, str, np.bool_)) or a is None:
        assert a == b
    else:
        assert math.isclose(float(a), float(b), rel_tol=rel, abs_tol=rel), \
            (a, b)


def _profiles(seed=0, n=24):
    """The same synthetic access profile as reference and port records."""
    rng = np.random.default_rng(seed)
    cats = ["param", "cache", "embed", "expert", "other"]
    rows = [(f"t{i}", int(rng.integers(1, 10**9)),
             float(rng.uniform(0.0, 4.0)), cats[i % len(cats)])
            for i in range(n)]
    return ([jacc.TensorAccess(*r) for r in rows],
            [tacc.TensorAccess(*r) for r in rows])


# --------------------------------------------------------- link model
def test_queueing_and_step_time_match_reference():
    rng = np.random.default_rng(1)
    rho = rng.uniform(-0.2, 1.2, 64)
    np.testing.assert_allclose(titf.queueing_slowdown(rho),
                               jitf.queueing_slowdown(rho), rtol=TOL)
    tp, tl, tc = (rng.uniform(0, 1e-2, 64) for _ in range(3))
    loi = rng.uniform(0, 1, 64)
    for overlap in (True, False):
        np.testing.assert_allclose(
            titf.step_time_vec(tp, tl, tc, loi, overlap),
            jitf.step_time_vec(tp, tl, tc, loi, overlap), rtol=TOL)
    inj = rng.uniform(0, 0.6, 8)
    np.testing.assert_allclose(titf.background_lois(inj),
                               jitf.background_lois(inj), rtol=TOL)
    bg = jitf.background_lois(inj)
    np.testing.assert_allclose(
        titf.progress_rates(tp[:8], tl[:8], tc[:8], bg),
        jitf.progress_rates(tp[:8], tl[:8], tc[:8], bg), rtol=TOL)
    assert titf.mdl_knee(0.4) == jitf.mdl_knee(0.4)
    assert titf.corridor_budget(_ref_topology()) == pytest.approx(
        jitf.corridor_budget(jtiers.v5e_topology()), rel=TOL)


@pytest.mark.parametrize("nflop", [0, 1, 2, 4, 8, 16, 64, 512, 4096])
def test_lbench_loi_matches_reference(nflop):
    for floor in (0.0, 1e-9):
        assert titf.lbench_loi(nflop, 1 << 20, _ref_topology(), floor) == \
            pytest.approx(jitf.lbench_loi(nflop, 1 << 20,
                                          jtiers.v5e_topology(), floor),
                          rel=TOL)


def test_lbench_intensity_sweep_matches_reference():
    _close(titf.lbench_intensity_sweep(_ref_topology()),
           jitf.lbench_intensity_sweep(jtiers.v5e_topology()), TOL)


def test_interference_profile_matches_reference():
    jt, tt = jtiers.v5e_topology(), _ref_topology()
    lois = np.linspace(0.0, 0.9, 10)
    for pool, local, tc in [(1e9, 2e10, 1e-3), (1e6, 1e9, 5e-2),
                            (3e8, 0.0, 0.0), (0.0, 5e9, 2e-3)]:
        jp = jitf.InterferenceProfile("a", "s", pool, local, tc, jt)
        tp = titf.InterferenceProfile("a", "s", pool, local, tc, tt)
        for name in ("t_pool", "t_local"):
            assert getattr(tp, name) == pytest.approx(getattr(jp, name),
                                                      rel=TOL)
        for loi in (0.0, 0.3, 0.95):
            for overlap in (True, False):
                assert tp.step_time(loi, overlap) == pytest.approx(
                    jp.step_time(loi, overlap), rel=TOL)
            assert tp.sensitivity(loi) == pytest.approx(
                jp.sensitivity(loi), rel=TOL)
        np.testing.assert_allclose(tp.sensitivity_vec(lois),
                                   jp.sensitivity_vec(lois), rtol=TOL)
        assert tp.step_time_no_pool() == jp.step_time_no_pool()
        assert tp.interference_coefficient() == pytest.approx(
            jp.interference_coefficient(), rel=TOL)
        assert tp.injected_loi() == pytest.approx(jp.injected_loi(),
                                                  rel=TOL)


# ------------------------------------------------- tiers and placement
@pytest.mark.parametrize("frac", [0.0, 0.25, 0.5, 0.95])
def test_emulated_matches_reference(frac):
    for ws in (1e6, 3e10, 5e12):
        j = jtiers.emulated(frac, ws)
        t = ttiers.emulated(frac, ws, base=_ref_topology())
        _close([dataclasses.asdict(s) for s in t.tiers],
               [dataclasses.asdict(s) for s in j.tiers], TOL)
        assert (t.shared_link_bw, t.chips_per_pool) == \
            (j.shared_link_bw, j.chips_per_pool)
        assert t.r_bw_pool == pytest.approx(j.r_bw_pool, rel=TOL)
        assert t.r_cap_pool() == pytest.approx(j.r_cap_pool(), rel=TOL)


def test_emulated_defaults_to_the_h100():
    t = ttiers.emulated(0.5, 1e11)
    assert t.local.bandwidth == thw.H100.hbm_bw
    assert t.pool.bandwidth == thw.H100_HOST.pcie_bw
    assert t.local.capacity == 0.5e11


@pytest.mark.parametrize(
    "policy", ["all_local", "first_touch", "hotness", "balanced_bw",
               "capacity"])
def test_placement_corridor_matches_reference(policy):
    jprof, tprof = _profiles()
    for frac in (0.25, 0.5, 0.75):
        jp = jplc.place(jprof, jtiers.emulated(frac, 1e10), policy, frac)
        tp = tplc.place(tprof, ttiers.emulated(frac, 1e10,
                                               base=_ref_topology()),
                        policy, frac)
        assert tp.assignment == jp.assignment
        _close(tplc.corridor_check(tp), jplc.corridor_check(jp), TOL)
        assert tp.slowdown == pytest.approx(jp.slowdown, rel=TOL)


# ------------------------------------------------------------ roofline
def test_roofline_matches_reference():
    rng = np.random.default_rng(2)
    chip = _ref_chip()
    for _ in range(20):
        r = rng.dirichlet(np.ones(3))
        bw = rng.uniform(1e9, 1e12, 3)
        assert trl.multi_tier_bandwidth(r, bw) == pytest.approx(
            jrl.multi_tier_bandwidth(r, bw), rel=TOL)
        ai = float(rng.uniform(0.01, 1e4))
        assert trl.attainable_flops(ai, r, bw, chip) == pytest.approx(
            jrl.attainable_flops(ai, r, bw, jhw.V5E), rel=TOL)
    assert trl.multi_tier_bandwidth([0.0, 0.0], [1e9, 1e9]) == \
        jrl.multi_tier_bandwidth([0.0, 0.0], [1e9, 1e9])
    assert trl.model_flops_train(123, 456) == \
        jrl.model_flops_train(123, 456)
    assert trl.attainable_flops(1e6, [1.0], [1e12]) == \
        thw.H100.peak_flops_bf16


# -------------------------------------------------------------- access
def test_access_models_match_reference():
    nested_opt = "/".join(("a", "opt", "nu"))     # an inner opt subtree
    for name in ("blocks/pos0/moe/w_up", "opt/mu/x", nested_opt,
                 "embed/embedding", "head/lm_head", "pos0/k", "pos3/v_sz",
                 "pos0/state", "blocks/pos0/attn/wq", "pos1/cross_k"):
        assert tacc._category(name) == jacc._category(name)
    for arch in ("granite_moe_1b_a400m", "smollm_360m"):
        jc = jconfigs.get(arch)
        for tokens in (0, 1, 7, 128, 4096):
            assert tacc.expected_expert_fraction(jc, tokens) == \
                pytest.approx(jacc.expected_expert_fraction(jc, tokens),
                              rel=TOL)
            if jc.num_experts:
                np.testing.assert_allclose(
                    tacc.expert_activation_probs(jc, tokens),
                    jacc.expert_activation_probs(jc, tokens), rtol=TOL)
    for args in [(32, 5, 64, 16, "int8"), (32, 5, 64, 16, "bf16"),
                 (40, 8, 128, 64, "fp", 2), (2, 1, 20, 4, "int8", 4,
                                            "token")]:
        assert tacc.kv_pool_token_bytes(*args) == \
            jacc.kv_pool_token_bytes(*args)
    for args in [(100, 0, 3, 10.0), (100, 60, 4, 84.0), (0, 0, 1, 5.0),
                 (64, 64, 8, 1.5)]:
        assert tacc.kv_dedup_token_bytes(*args) == pytest.approx(
            jacc.kv_dedup_token_bytes(*args), rel=TOL)
    with pytest.raises(ValueError):
        tacc.kv_dedup_token_bytes(10, 11, 2, 1.0)
    for seq in (1, 4096, 32768, 500_000):
        assert tacc.decode_cache_split(seq) == jacc.decode_cache_split(seq)
    jprof, tprof = _profiles(3)
    for excess in (0.0, 1e8):
        j = jacc.with_prefetch_excess(jprof, excess)
        t = tacc.with_prefetch_excess(tprof, excess)
        assert [dataclasses.astuple(a) for a in t] == \
            [dataclasses.astuple(a) for a in j]
    jx, jy = jacc.bandwidth_capacity_curve(jprof)
    tx, ty = tacc.bandwidth_capacity_curve(tprof)
    np.testing.assert_allclose(tx, jx, rtol=TOL)
    np.testing.assert_allclose(ty, jy, rtol=TOL)
    assert tacc.arithmetic_intensity(1e12, tprof, 5e6) == pytest.approx(
        jacc.arithmetic_intensity(1e12, jprof, 5e6), rel=TOL)


@pytest.mark.parametrize("shape", SERVE_SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_profile_of_meta_state_matches_reference(arch, shape):
    jc, tc = jconfigs.get(arch), tconfigs.get(arch)
    js, ts = JSHAPES[shape], TSHAPES[shape]
    jparams, _ = jserve.abstract_params(jc)
    tparams = tserve.abstract_params(tc)
    jcaches = tcaches = None
    if js.kind == "decode":
        jcaches = jserve.abstract_caches(jc, js.global_batch, js.seq_len)
        tcaches = tserve.abstract_caches(tc, ts.global_batch, ts.seq_len)
        assert all(v.device.type == "meta" for c in tcaches.values()
                   for v in c.values())
    j = jacc.serve_profile(jparams, jcaches, jc, js)
    t = tacc.serve_profile(tparams, tcaches, tc, ts)
    assert [(a.name, a.bytes, a.touches, a.category) for a in t] == \
        [(a.name, a.bytes, a.touches, a.category) for a in j]


def test_train_profile_waits_for_training():
    """Training is ported: the train access profile of the port's meta
    train state equals the reference's leaf for leaf, with and without
    remat (the name is kept from when it checked the refusal)."""
    for arch in ARCHS:
        jc, tc = jconfigs.get(arch), tconfigs.get(arch)
        jstate, _ = jtrain.abstract_train_state(jc)
        tstate = ttrain.abstract_train_state(tc)
        for remat in ("block", "none"):
            j = jacc.train_profile(jstate, jc, JSHAPES["train_4k"], remat)
            t = tacc.train_profile(tstate, tc, TSHAPES["train_4k"], remat)
            assert [(a.name, a.bytes, a.touches, a.category) for a in t] \
                == [(a.name, a.bytes, a.touches, a.category) for a in j]
            assert {a.category for a in t} >= {"moment", "embed"}


# ------------------------------------------------------------- analyze
@pytest.mark.parametrize("shape", SERVE_SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_analyze_matches_reference(arch, shape):
    """Levels 1-3 equal the reference's (no dry-run record) at every
    pool fraction, priced with the reference's chip, topology and
    256-chip mesh."""
    for frac in ("auto", 0.25, 0.5, 0.75):
        for policy in ("hotness", "balanced_bw"):
            j = jq.analyze(arch, shape, policy=policy, pool_fraction=frac,
                           use_dryrun=False)
            t = tq.analyze(arch, shape, policy=policy, pool_fraction=frac,
                           chip=_ref_chip(), topo=_ref_topology(),
                           n_chips=N_CHIPS)
            _close(t.level1, j.level1, 1e-9)
            _close(t.level2, j.level2, 1e-9)
            _close(t.level3, j.level3, 1e-9)
            assert t.placement.assignment == j.placement.assignment


def test_quickstart_matches_reference():
    """`examples/quickstart_torch.py` on its default kimi-k2 x decode_32k,
    priced with the reference's chip, topology and 256 chips: each of its
    three policies' levels equal the reference's `analyze` (no dry-run
    record) at pool fraction 0.5, as `examples/quickstart.py` calls it."""
    import importlib.util
    import pathlib

    path = (pathlib.Path(__file__).resolve().parents[1] / "examples"
            / "quickstart_torch.py")
    spec = importlib.util.spec_from_file_location("quickstart_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.N_CHIPS == N_CHIPS
    got = mod.run(chip=_ref_chip(), topo=_ref_topology())
    assert tuple(got) == ("first_touch", "hotness", "balanced_bw")
    for policy, t in got.items():
        j = jq.analyze("kimi-k2-1t-a32b", "decode_32k", policy=policy,
                       pool_fraction=0.5, use_dryrun=False)
        _close(t.level1, j.level1, 1e-9)
        _close(t.level2, j.level2, 1e-9)
        _close(t.level3, j.level3, 1e-9)


@pytest.mark.parametrize("arch", DENSE)
def test_analyze_runs_on_its_h100_defaults(arch):
    """One H100 card with `h100_topology()`: 80 GB of HBM take the
    prefill state whole (no pool) except qwen2.5-32b's, and every decode
    state at 32k x 128 sequences spills to the pool."""
    for shape in SERVE_SHAPES:
        an = tq.analyze(arch, shape)
        t = tq.analyze(arch, shape, chip=thw.H100,
                       topo=ttiers.h100_topology(), n_chips=1)
        _close(an.level1, t.level1, 0.0)
        _close(an.level2, t.level2, 0.0)
        _close(an.level3, t.level3, 0.0)
        assert an.profile.topo.pool.bandwidth == thw.H100_HOST.pcie_bw
        budget = tq.HBM_STATE_BUDGET * thw.H100.hbm_bytes
        total = an.level1["footprint_bytes_per_chip"]
        assert an.level2["pool_fraction"] == pytest.approx(
            max(0.0, min(0.95, 1.0 - budget / total)), rel=TOL)
        if shape == "decode_32k":
            assert an.level2["pool_fraction"] > 0.5
            assert an.level3["injected_loi"] > 0.0
        else:
            assert (an.level2["pool_fraction"] > 0.0) == \
                (arch == "qwen2_5_32b")
        for v in an.level3["sensitivity"].values():
            assert 0.0 < v <= 1.0
    assert tq.profile_for(arch).pool_traffic == \
        tq.analyze(arch, "decode_32k").profile.pool_traffic


def test_analyze_of_the_ssm_arch_on_its_h100_defaults():
    """mamba2-780m on one H100: its decode state is a fixed SSM state and
    conv tails per sequence, not a 32k-token KV cache, so the serve state
    (weights included) fits the HBM budget whole at both shapes, and the
    state leaves are priced as cache."""
    for shape in SERVE_SHAPES:
        an = tq.analyze("mamba2_780m", shape)
        budget = tq.HBM_STATE_BUDGET * thw.H100.hbm_bytes
        assert an.level1["footprint_bytes_per_chip"] < budget
        assert an.level2["pool_fraction"] == 0.0
        assert an.level2["policy"] == "all_local"
    prof = tq._profile(tconfigs.get("mamba2_780m"), TSHAPES["decode_32k"])
    kinds = {a.name.split("/")[-1]: a.category for a in prof}
    for leaf in ("state", "tail_x", "tail_B", "tail_C"):
        assert kinds[leaf] == "cache", (leaf, kinds)


def test_lbench_loi_on_the_h100_topology():
    """The reference's model as it is: its 2e-10 s per flop per element
    does not saturate the H100's 64 GB/s pool link at nflop=1 (it does
    the v5e's 16 GB/s one)."""
    assert titf.lbench_loi(1, 1 << 20, ttiers.h100_topology()) == \
        pytest.approx(0.625, rel=TOL)
    assert titf.lbench_loi(1, 1 << 20, _ref_topology()) == pytest.approx(1.0)


def test_analyze_refuses_train_shapes_and_dry_runs(tmp_path, monkeypatch):
    """Train shapes run, and dry-run records are read (ROADMAP A15, the
    port's own records under results/dryrun_torch/): with no record the
    compute time is the analytic one; a record of a mesh prices that
    mesh's cards (ROADMAP A16c) and is refused on any other number. The
    name is kept from when both were refused."""
    monkeypatch.chdir(tmp_path)
    for shape in ("decode_32k", "train_4k"):
        a = tq.analyze("smollm_360m", shape, use_dryrun=True)
        b = tq.analyze("smollm_360m", shape, use_dryrun=False)
        _close(a.level1, b.level1, 0)
    rec = {"status": "ok", "mesh": "16x16", "roofline": {"t_compute_s": 1.0}}
    with pytest.raises(ValueError, match="mesh 16x16 .256 cards."):
        tq.analyze("smollm_360m", "train_4k", dryrun_record=rec, n_chips=2)
    assert tq.analyze("smollm_360m", "train_4k", dryrun_record=rec,
                      n_chips=256).profile.t_compute == 1.0
    an = tq.analyze("smollm_360m", "train_4k")
    assert an.level1["footprint_bytes_per_chip"] > 0
    assert tq.analyze("jamba_1_5_large_398b", "train_4k").level2[
        "pool_fraction"] > 0.5


@pytest.mark.parametrize("arch", ARCHS)
def test_analyze_train_matches_reference(arch):
    """Levels 1-3 at train_4k equal the reference's (no dry-run record),
    priced with the reference's chip, topology and 256-chip mesh."""
    for frac in ("auto", 0.5):
        j = jq.analyze(arch, "train_4k", pool_fraction=frac,
                       use_dryrun=False)
        t = tq.analyze(arch, "train_4k", pool_fraction=frac,
                       chip=_ref_chip(), topo=_ref_topology(),
                       n_chips=N_CHIPS)
        _close(t.level1, j.level1, 1e-9)
        _close(t.level2, j.level2, 1e-9)
        _close(t.level3, j.level3, 1e-9)
        assert t.placement.assignment == j.placement.assignment


# ---------------------------------------------- catalog admission prior
@pytest.mark.parametrize("shape", SERVE_SHAPES)
@pytest.mark.parametrize("arch", DENSE)
def test_catalog_prior_matches_reference(arch, shape):
    """`profile_for` priced with the reference's chip, topology and mesh
    gives the reference's profile, and the admission prior seeded from
    it (injected LoI over the shape's global batch) equals the
    reference's to 1e-9: 0 on that mesh, where 256 v5e cards hold every
    serve state in HBM."""
    jp = jq.profile_for(arch, shape)
    tp = tq.profile_for(arch, shape, chip=_ref_chip(), topo=_ref_topology(),
                        n_chips=N_CHIPS)
    for name in ("pool_traffic", "local_traffic", "t_compute"):
        assert math.isclose(getattr(tp, name), getattr(jp, name),
                            rel_tol=1e-9, abs_tol=1e-12), name
    for loi in (0.0, 0.3, 0.9):
        assert tp.sensitivity(loi) == pytest.approx(jp.sensitivity(loi),
                                                    rel=1e-9)
    assert tp.interference_coefficient() == pytest.approx(
        jp.interference_coefficient(), rel=1e-9)
    ja = JAdmission.from_catalog(jtiers.v5e_topology(), arch, shape)
    ta = TAdmission.from_catalog(_ref_topology(), arch, shape,
                                 chip=_ref_chip(), n_chips=N_CHIPS)
    assert math.isclose(ta.per_slot_loi, ja.per_slot_loi, rel_tol=1e-9,
                        abs_tol=1e-12)
    assert ta.budget == pytest.approx(ja.budget, rel=1e-9)


@pytest.mark.parametrize("arch", DENSE)
def test_catalog_prior_on_its_h100_defaults(arch):
    """One H100: the decode_32k state spills to the pool, so the prior is
    the workload's injected LoI per sequence of the shape's batch, > 0."""
    ctl = TAdmission.from_catalog(ttiers.h100_topology(), arch, "decode_32k")
    want = (tq.analyze(arch, "decode_32k").profile.injected_loi()
            / TSHAPES["decode_32k"].global_batch)
    assert want > 0.0 and ctl.per_slot_loi == pytest.approx(want, rel=TOL)
    assert TAdmission.from_catalog(ttiers.h100_topology(), None,
                                   "decode_32k").per_slot_loi == 0.0

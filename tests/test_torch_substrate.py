"""The port's physical memory substrate against the reference package:
capability-mode resolution, the transfer ledger, the pool twin, the
`TierSubstrate` drains against a live engine, and the engine contract —
reduced smollm, float32, int8 and fp pools, bucket and chunked prefill,
the JAX engine with `substrate="auto"` (emulated on the CPU) beside the
port's on the same weights and trace.

Gates: ledger counters and `summary()` substrate fields equal the
reference's to rel=1e-9; after every drain the ledger's placement bytes
equal the pager's pool footprint (gap 0); tokens are the same with the
substrate on and off (the substrate never writes the device pool)."""

import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.common import hw as jhw  # noqa: E402
from repro.common.parallel import ParallelCtx  # noqa: E402
from repro.core import tiers as jtiers  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.runtime import capability as jcap  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import RequestQueue as JRequestQueue  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro.serving import make_scenario as jmake_scenario  # noqa: E402
from repro.serving.substrate import SubstrateLedger as JLedger  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.common import hw as thw  # noqa: E402
from repro_torch.core import tiers as ttiers  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.module import load_numpy_params  # noqa: E402
from repro_torch.runtime import capability as tcap  # noqa: E402
from repro_torch.serving import EngineConfig  # noqa: E402
from repro_torch.serving import RequestQueue, ServingEngine  # noqa: E402
from repro_torch.serving import make_scenario  # noqa: E402
from repro_torch.serving.substrate import SubstrateLedger  # noqa: E402
from repro_torch.serving.substrate import TierSubstrate  # noqa: E402
from repro_torch.serving.substrate import tier_substrate as tsub_mod  # noqa: E402,E501
from repro_torch.serving.substrate.ledger import KINDS, HostDone  # noqa: E402,E501

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


def _cfgs(arch="smollm_360m"):
    return (dataclasses.replace(jconfigs.reduced(arch), dtype="float32"),
            dataclasses.replace(tconfigs.reduced(arch), dtype="float32"))


# -------------------------------------------- capability mode resolver
@pytest.mark.parametrize("requested", ["off", "emulated", "auto",
                                       "physical", "hbm"])
@pytest.mark.parametrize("host_input", [False, True])
@pytest.mark.parametrize("internal", [False, True])
def test_resolve_matches_reference(requested, host_input, internal):
    kw = dict(host_input=host_input, host_output=internal,
              internal=internal)
    try:
        want = jcap.resolve_substrate_mode(requested, **kw)
    except (ValueError, RuntimeError) as e:
        with pytest.raises(type(e), match="substrate"):
            tcap.resolve_substrate_mode(requested, **kw)
        return
    assert tcap.resolve_substrate_mode(requested, **kw) == want


def test_cpu_probes_resolve_auto_to_emulated():
    """No card: no pinned host memory to map, so "auto" emulates (as
    XLA:CPU does) and "physical" raises."""
    for probe in (tcap.supports_host_input, tcap.supports_host_output,
                  tcap.supports_internal_transfer):
        assert probe("cpu") is False
    assert tcap.substrate_mode("auto", "cpu") == "emulated"
    with pytest.raises(RuntimeError, match="physical"):
        tcap.substrate_mode("physical", "cpu")


@pytest.fixture
def fake_card(monkeypatch):
    """The probes as on a card whose pinned memory allocates: the mapping
    probe's outcome is whatever `host_device_ptr` does."""
    from repro_torch.kernels.page_io import page_io

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(tcap, "_host_input", lambda d: True)
    monkeypatch.setattr(tcap, "_pinned", lambda: torch.zeros(8))
    tcap._internal.cache_clear()
    yield page_io
    tcap._internal.cache_clear()


@pytest.mark.parametrize("mapped", [False, True])
def test_mapping_probe_decides_the_mode(fake_card, monkeypatch, mapped):
    """A failed mapping (`HostMappingError`) resolves "auto" to
    "emulated" and makes "physical" raise; a mapped twin is physical."""
    def host_device_ptr(t):
        if not mapped:
            raise fake_card.HostMappingError("not mapped")
        return 1 << 40

    monkeypatch.setattr(fake_card, "host_device_ptr", host_device_ptr)
    want = "physical" if mapped else "emulated"
    assert tcap.substrate_mode("auto", "cuda") == want
    assert tcap.supports_internal_transfer("cuda") is mapped
    if not mapped:
        with pytest.raises(RuntimeError, match="physical"):
            tcap.substrate_mode("physical", "cuda")


def test_probe_propagates_build_errors(fake_card, monkeypatch):
    """A kernel build or library layout failure is not a "no": it raises
    out of the probe, and is not cached as one."""
    def host_device_ptr(t):
        raise RuntimeError("nvcc failed for page_io.cu")

    monkeypatch.setattr(fake_card, "host_device_ptr", host_device_ptr)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="nvcc"):
            tcap.substrate_mode("auto", "cuda")


# ------------------------------------------------------ ledger contract
def _replay(ledger):
    ledger.record("page_out", 4, step=0, payload=(1,))
    ledger.record("page_in", 1, step=1)
    ledger.record("drop", 2, step=1)
    ledger.record("handoff", 3, step=2)
    ledger.record("retry", 2, step=3)
    return ledger


@pytest.mark.parametrize("mode", ["physical", "emulated"])
def test_ledger_accounting_matches_reference(mode):
    t = _replay(SubstrateLedger(page_bytes=100.0, mode=mode))
    j = JLedger(page_bytes=100.0, mode=mode)
    j.record("page_out", 4, step=0, payload=(jax.numpy.zeros(2),))
    for kind, n, step in (("page_in", 1, 1), ("drop", 2, 1),
                          ("handoff", 3, 2), ("retry", 2, 3)):
        j.record(kind, n, step=step)
    assert t.counters() == j.counters()
    assert t.counters()["in_flight"] == 1
    assert t.placement_bytes() == 100.0
    assert t.sync() == j.sync() == 1
    assert t.counters() == j.counters()
    assert t.events[0].payload == ()
    assert [dataclasses.astuple(e) for e in t.events] == \
        [dataclasses.astuple(e) for e in j.events]


def test_ledger_rejects_unknown_kind():
    with pytest.raises(ValueError, match="stream kind"):
        SubstrateLedger(1.0, "emulated").record("promote", 1, step=0)
    assert KINDS == ("page_out", "page_in", "drop", "handoff", "retry")


# ---------------------------------------------------------- pool twin
@pytest.mark.parametrize("pool_dtype,gran", [("int8", "page"),
                                             ("int8", "token"),
                                             ("fp", "page")])
def test_pool_twin_mirrors_paged_leaves_only(pool_dtype, gran):
    jc, tc = _cfgs()
    jc_ = JM.make_paged_decode_caches(jc, 2, 32, 8, pool_dtype=pool_dtype,
                                      sz_granularity=gran)
    tc_ = TM.make_paged_decode_caches(tc, 2, 32, 8, pool_dtype=pool_dtype,
                                      sz_granularity=gran, device="cpu")
    jtwin = jblocks.init_pool_twin(jc_)
    twin = tblocks.init_pool_twin(tc_)
    assert twin and set(twin) == set(jtwin)
    for pos, sub in twin.items():
        assert set(sub) == set(jtwin[pos])
        assert set(sub) <= set(tblocks.PAGED_LEAF_NAMES)
        for name, leaf in sub.items():
            assert tuple(leaf.shape) == jtwin[pos][name].shape
            assert leaf.dtype == tc_[pos][name].dtype
            assert leaf.device == tc_[pos][name].device
            assert not leaf.any() and leaf is not tc_[pos][name]


# ---------------------------------------------------------- engines
def _ecfg(**kw):
    base = dict(n_slots=2, max_seq=32, prefill_buckets=(8,), page_tokens=4,
                hot_window=4, local_budget_frac=0.35, admission="greedy")
    base.update(kw)
    return base


def _port(ecfg_kw, arch="smollm_360m", params=None):
    _, tc = _cfgs(arch)
    return tc, ServingEngine.build(tc, EngineConfig(**_ecfg(**ecfg_kw)),
                                   params=params, device="cpu",
                                   topo=_ref_topology(), chip=_ref_chip())


def _burst(n, vocab, prompt_len, gen, seed=0):
    from repro_torch.serving import Request

    rng = np.random.default_rng(seed)
    return [Request(request_id=i,
                    tokens=rng.integers(0, vocab, prompt_len).astype(
                        np.int32),
                    max_new_tokens=gen, arrival=0.0) for i in range(n)]


def test_default_engine_builds_an_emulated_substrate():
    """`EngineConfig()` (substrate "auto") on the CPU builds the substrate
    in emulated mode, its twin on the pool's device."""
    _, tc = _cfgs()
    eng = ServingEngine.build(tc, EngineConfig(), device="cpu")
    assert EngineConfig().substrate == "auto"
    assert eng.substrate is not None and eng.substrate.enabled
    assert eng.substrate.mode == "emulated"
    leaf = eng.substrate.twin["pos0"]["k"]
    assert leaf.device.type == "cpu" and not leaf.is_pinned()
    assert eng.substrate.page_bytes == pytest.approx(eng.pager.page_bytes)


def test_substrate_must_be_resolved_and_pinned():
    _, tc = _cfgs()
    caches = TM.make_paged_decode_caches(tc, 2, 32, 8, device="cpu")
    for bad in ("auto", "off", "hbm"):
        with pytest.raises(ValueError, match="resolve"):
            TierSubstrate(caches, bad)
    with pytest.raises(ValueError, match="pinned_host"):
        TierSubstrate(caches, "emulated", host_memory_kind="device")


def test_substrate_disabled_on_ssm_only_stack_and_when_off():
    _, eng = _port(dict(page_tokens=8, pool_dtype="fp", substrate="auto"),
                   arch="mamba2_780m")
    assert eng.substrate is None           # no paged KV leaves to place
    sub = TierSubstrate(eng.caches, "emulated")
    assert not sub.enabled
    assert sub.drain(eng.pager, eng.caches) == {}
    assert sub.counters()["events"] == 0
    tc, eng = _port(dict(substrate="off"))
    assert eng.substrate is None
    stats = eng.run(_burst(2, tc.vocab_size, 8, 4), max_steps=6)
    assert not stats.substrate
    assert "substrate_transfer_bytes" not in stats.summary()


def test_drain_reconciles_out_in_drop_streams():
    """Page-out on first spill, page-in on promotion, drop on free — over
    a run that admits, spills and completes; one plain page_out call per
    drain that had pages to move."""
    tc, eng = _port({})
    tk.reset_counters()
    eng.run(_burst(4, tc.vocab_size, 8, 6, seed=3))
    c = eng.substrate.counters()
    assert c["page_out_pages"] > 0 and c["page_in_pages"] > 0
    assert c["drop_pages"] > 0             # completed slots freed pages
    assert c["page_out_bytes"] == pytest.approx(
        c["page_out_pages"] * eng.substrate.page_bytes)
    assert c["in_flight"] == 0
    n_out = sum(1 for e in eng.substrate.ledger.events
                if e.kind == "page_out")
    assert tk.REFERENCE_CALLS["page_out"] == n_out
    assert tk.REFERENCE_CALLS["page_in"] == sum(
        1 for e in eng.substrate.ledger.events if e.kind == "page_in")
    assert sum(tk.LAUNCHES.values()) == 0
    assert eng.pager.pool_bytes_used() == pytest.approx(
        c["placement_bytes"])


def test_streams_move_the_pages_they_name(monkeypatch):
    """Each page_out lands the pool's pages in the twin as they are at
    the drain, and each page_in's scratch holds the twin's pages: checked
    at every decode step's drain. The ledger keeps only the completion
    handle, never the scratch."""
    tc, eng = _port({})
    page_ins = []
    copy = tsub_mod.page_ops.copy_pages

    def spy(dst, dst_ids, src, src_ids, *, name, **kw):
        copy(dst, dst_ids, src, src_ids, name=name, **kw)
        if name == "page_in":
            page_ins.append((src_ids.clone(), [d.clone() for d in dst]))

    monkeypatch.setattr(tsub_mod.page_ops, "copy_pages", spy)
    q = RequestQueue(_burst(4, tc.vocab_size, 8, 6, seed=3))
    outs = ins = 0
    while len(q) or eng.batcher.n_busy:
        before = set(eng.substrate._resident)
        n_events = len(eng.substrate.ledger.events)
        if eng.pump(q) != "decode":
            continue
        new = sorted(eng.substrate._resident - before)
        for p in new:
            for name, leaf in eng.substrate.twin["pos0"].items():
                assert torch.equal(leaf[:, p], eng.caches["pos0"][name][:, p])
        outs += len(new)
        for e in eng.substrate.ledger.events[n_events:]:
            assert all(isinstance(h, HostDone) for h in e.payload)
            if e.kind == "page_in":
                ids, got = page_ins.pop(0)
                assert len(ids) == e.n_pages
                twin = list(eng.substrate.twin["pos0"].values())
                for g, t in zip(got, twin, strict=True):
                    assert torch.equal(g, t[:, ids.long()])
                ins += 1
    assert outs > 0 and ins > 0 and not page_ins


def test_handoff_recording():
    tc, eng = _port({})
    eng.run(_burst(2, tc.vocab_size, 8, 4))
    before = eng.substrate.counters()
    eng.substrate.record_handoff(3, step=eng.steps)
    c = eng.substrate.counters()
    assert c["handoff_pages"] == before["handoff_pages"] + 3
    assert c["handoff_bytes"] == pytest.approx(
        before["handoff_bytes"] + 3 * eng.substrate.page_bytes)
    assert c["resident_pages"] == before["resident_pages"]
    eng.substrate.record_handoff(0)        # no-op, not an event
    assert eng.substrate.counters()["events"] == c["events"]


def test_int8_pool_substrate_measures_quantized_bytes():
    """The int8 twin carries the quantized payload plus the (scale, zero)
    leaves: measured page bytes equal the pager's and the reference
    engine's, and are under half the fp pool's."""
    jc, _ = _cfgs()
    tc, eng8 = _port(dict(pool_dtype="int8"))
    _, engf = _port(dict(pool_dtype="fp"))
    jeng = JServingEngine.build(jc, CTX, JEngineConfig(**_ecfg(
        pool_dtype="int8", substrate="auto")))
    assert eng8.substrate.page_bytes == pytest.approx(eng8.pager.page_bytes)
    assert eng8.substrate.page_bytes == jeng.substrate.page_bytes
    assert eng8.substrate.page_bytes < 0.5 * engf.substrate.page_bytes
    eng8.run(_burst(4, tc.vocab_size, 8, 6, seed=3))
    assert eng8.pager.pool_bytes_used() == pytest.approx(
        eng8.substrate.counters()["placement_bytes"])


# ------------------------------------------ the engine contract vs JAX
def _pair(**kw):
    jc, tc = _cfgs()
    jparams, _ = JM.init_model(jc, jax.random.PRNGKey(0))
    tparams = load_numpy_params(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    kw = dict(n_slots=3, max_seq=48, prefill_buckets=(16, 32),
              page_tokens=8, hot_window=8, local_budget_frac=0.35,
              admission="greedy", **kw)
    jeng = JServingEngine.build(jc, CTX, JEngineConfig(substrate="auto", **kw),
                                params=jparams)
    teng = ServingEngine.build(tc, EngineConfig(substrate="auto", **kw),
                               params=tparams, topo=_ref_topology(),
                               chip=_ref_chip(), device="cpu")
    toff = ServingEngine.build(tc, EngineConfig(substrate="off", **kw),
                               params=tparams, topo=_ref_topology(),
                               chip=_ref_chip(), device="cpu")
    return jc, jeng, teng, toff


def _run_checked(eng, reqs, queue_cls):
    """Serve `reqs` pump by pump; after every decode step reconcile and
    check the placement gap. Returns (stats, drains checked)."""
    q = queue_cls(reqs)
    cap = eng.begin_capture()
    checks = 0
    while len(q) or eng.batcher.n_busy:
        act = eng.pump(q)
        if act == "decode":
            eng.substrate.drain(eng.pager, eng.caches, step=eng.steps)
            assert eng.pager.pool_bytes_used() == pytest.approx(
                eng.substrate.counters()["placement_bytes"], abs=0)
            checks += 1
        elif act == "idle":
            nxt = q.next_arrival()
            if not np.isfinite(nxt):
                break
            eng.advance_to(nxt)
    return eng.capture_stats(cap, reqs), checks


@pytest.mark.parametrize("chunk", [None, 8])
@pytest.mark.parametrize("pool_dtype", ["fp", "int8"])
def test_engine_substrate_matches_reference(pool_dtype, chunk):
    jc, jeng, teng, toff = _pair(pool_dtype=pool_dtype,
                                 prefill_chunk=chunk)
    assert teng.substrate.mode == jeng.substrate.mode == "emulated"
    assert teng.substrate.page_bytes == jeng.substrate.page_bytes
    trace = dict(n=6, vocab=jc.vocab_size, seed=5, prompt_buckets=(16, 32),
                 gen_range=(6, 14), arrival_rate=2e5)
    jreqs = jmake_scenario("chat", **trace)
    treqs = make_scenario("chat", **trace)
    oreqs = make_scenario("chat", **trace)
    js, jchecks = _run_checked(jeng, jreqs, JRequestQueue)
    ts, tchecks = _run_checked(teng, treqs, RequestQueue)
    toff.run(oreqs)
    assert tchecks == jchecks > 0
    assert ts.substrate["page_out_pages"] > 0
    assert ts.substrate["page_in_pages"] > 0
    tsub, jsub = dict(ts.substrate), dict(js.substrate)
    assert tsub.pop("mode") == jsub.pop("mode") == "emulated"
    assert tsub == pytest.approx(jsub, rel=1e-9)
    tsum, jsum = ts.summary(), js.summary()
    for k in ("substrate_transfer_bytes", "substrate_placement_bytes"):
        assert tsum[k] == pytest.approx(jsum[k], rel=1e-9)
    tsum.pop("tok_per_s_wall"), jsum.pop("tok_per_s_wall")
    assert tsum == pytest.approx(jsum, rel=1e-9)
    for t, o, j in zip(treqs, oreqs, jreqs):
        assert t.output == o.output, t.request_id     # on == off
        if pool_dtype == "fp":
            assert t.output == j.output, t.request_id

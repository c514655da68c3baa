"""The port's dry-run against the reference's: the cell matrix and the
meta input specs, the cost model (`repro_torch.profiler.cost`) against
`torch.utils.flop_counter` and against the reference's HLO cost model,
the hotspot groups, the roofline report, the dry-run records and
`analyze` reading them.

How each side counts causal attention: on the CPU paths compared here
both packages run their plain attention, which computes every (query,
key) pair of the score matrix and masks the upper triangle, so both
count the full S x S products (and the reference's `analyze_hlo` sees
the same masked einsums the port dispatches). On the meta path the port
counts a `flash_mha` unit's unmasked pairs only (`attn_pairs`, what the
CUDA kernel computes), checked on its own below.

Tolerances: products equal to `FlopCounterMode`'s exactly; total flops
within 5% of `analyze_hlo` (the elementwise ops are priced by the
reference's per-element approximation, not by op fusion); the roofline
report and `analyze` given the same record equal to rel=1e-9; the
microbatch extrapolation exact."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.common import hw as jhw  # noqa: E402
from repro.common.config import MeshConfig as JMeshConfig  # noqa: E402
from repro.common.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.common.parallel import ParallelCtx  # noqa: E402
from repro.core import quantify as jq  # noqa: E402
from repro.core import roofline as jrl  # noqa: E402
from repro.core import tiers as jtiers  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.profiler.hlo import HloCostModel, analyze_hlo  # noqa: E402
from repro.runtime import train as jtrain  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.common import hw as thw  # noqa: E402
from repro_torch.common.config import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.core import quantify as tq  # noqa: E402
from repro_torch.core import roofline as trl  # noqa: E402
from repro_torch.core import tiers as ttiers  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as sops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.module import load_numpy_params  # noqa: E402
from repro_torch.profiler import cost, hotspots  # noqa: E402
from repro_torch.runtime import serve as tserve  # noqa: E402
from repro_torch.runtime import train as ttrain  # noqa: E402

CTX = ParallelCtx(remat="none")
N_CHIPS = 256


def _ref_topology():
    jt = jtiers.v5e_topology()
    return ttiers.TierTopology(
        tiers=tuple(ttiers.TierSpec(**dataclasses.asdict(t))
                    for t in jt.tiers),
        shared_link_bw=jt.shared_link_bw,
        chips_per_pool=jt.chips_per_pool)


def _ref_chip():
    """The reference's v5e with its links' aggregate as `link_bw` (what
    its roofline divides wire bytes by)."""
    c = jhw.V5E
    return thw.ChipSpec(name=c.name, peak_flops_bf16=c.peak_flops_bf16,
                        hbm_bytes=c.hbm_bytes, hbm_bw=c.hbm_bw,
                        link_bw=jhw.bidir_ici_bw(c), num_sms=0,
                        smem_per_block=0, l2_bytes=0.0)


@pytest.fixture(autouse=True)
def _cwd_without_records(tmp_path, monkeypatch):
    """Each test runs in an empty directory: `analyze` reads the port's
    records under the working directory's results/dryrun_torch/, so a
    dry-run left at the repo root cannot change what a test compares."""
    monkeypatch.chdir(tmp_path)


def _close(a, b, rel):
    if isinstance(b, dict):
        assert set(a) == set(b)
        for k in b:
            _close(a[k], b[k], rel)
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, rel)
    elif isinstance(b, (bool, str)) or b is None:
        assert a == b
    else:
        assert a == pytest.approx(b, rel=rel, abs=1e-300)


# ------------------------------------------------------------ the matrix
def test_all_cells_match_reference():
    assert tconfigs.all_cells() == jconfigs.all_cells()
    for arch in tconfigs.list_archs():
        assert [s.name for s in tconfigs.shapes_for(arch)] == \
            [s.name for s in jconfigs.shapes_for(arch)]


@pytest.mark.parametrize("arch,shape", jconfigs.all_cells())
def test_input_specs_match_reference(arch, shape):
    j = jspecs.input_specs(arch, shape)
    t = tspecs.input_specs(arch, shape)

    def flat(tree, pre=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items()
                    for k2, v2 in flat(v, f"{pre}/{k}").items()}
        return {pre: tree}

    jf, tf = flat(j), flat(t)
    assert set(jf) == set(tf)
    for k, js in jf.items():
        ts = tf[k]
        assert ts.device.type == "meta"
        assert tuple(ts.shape) == tuple(js.shape), k
        assert str(ts.dtype).removeprefix("torch.") == str(js.dtype), k


# -------------------------------------------------------- the cost model
def _weights(arch):
    jc = dataclasses.replace(jconfigs.reduced(arch), dtype="float32")
    tc = dataclasses.replace(tconfigs.reduced(arch), dtype="float32")
    jparams, _ = JM.init_model(jc, jax.random.PRNGKey(0))
    tparams = load_numpy_params(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jc, tc, jparams, tparams


B, SEQ = 2, 32


def _steps(arch):
    """{step: (reference jitted fn, its args, port fn, its args)} on the
    CPU at B=2, S=32: prefill, one decode step at position 3 and a train
    step (no remat, one microbatch)."""
    jc, tc, jp, tp = _weights(arch)
    toks = np.arange(B * SEQ, dtype=np.int32).reshape(B, SEQ) % 50
    ttoks = np.arange(B * (SEQ + 1), dtype=np.int32).reshape(
        B, SEQ + 1) % 50
    jstate, _ = jtrain.init_train_state(jc, jax.random.PRNGKey(0))
    return {
        "prefill": (
            lambda p, b: JM.prefill(p, b, jc, CTX, SEQ),
            (jp, {"tokens": jnp.asarray(toks)}),
            lambda p, b: TM.prefill(p, b, tc, SEQ),
            (tp, {"tokens": torch.tensor(toks)})),
        "decode": (
            lambda p, t, c, s: JM.decode_step(p, t, c, s, jc, CTX),
            (jp, jnp.zeros((B,), jnp.int32), JM.make_decode_caches(
                jc, B, SEQ), jnp.int32(3)),
            lambda p, t, c, s: TM.decode_step(p, t, c, s, tc),
            (tp, torch.zeros(B, dtype=torch.int32),
             TM.make_decode_caches(tc, B, SEQ, device="cpu"),
             torch.tensor(3))),
        "train": (
            jtrain.build_train_step(jc, CTX, JTrainConfig(remat="none")),
            (jstate, {"tokens": jnp.asarray(ttoks)}),
            ttrain.build_train_step(tc, TrainConfig(remat="none")),
            (ttrain.init_train_state(tc, device="cpu"),
             {"tokens": torch.tensor(ttoks)})),
    }


@pytest.mark.parametrize("arch", ["smollm_360m", "granite_moe_1b_a400m",
                                  "mamba2_780m"])
def test_products_equal_flop_counter(arch):
    from torch.utils.flop_counter import FlopCounterMode

    for name, (_, _, fn, args) in _steps(arch).items():
        _, mode = cost.run_counted(fn, *args)
        fc = FlopCounterMode(display=False)
        with fc:
            fn(*_steps(arch)[name][3])
        assert mode.product_flops == fc.get_total_flops(), name
        assert mode.flops >= mode.product_flops > 0


@pytest.mark.parametrize("step", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", ["smollm_360m", "granite_moe_1b_a400m",
                                  "mamba2_780m"])
def test_total_flops_near_reference_hlo(arch, step):
    jfn, jargs, tfn, targs = _steps(arch)[step]
    want = analyze_hlo(jax.jit(jfn).lower(*jargs).compile().as_text())
    got = cost.analyze_step(tfn, *targs)
    assert got.flops == pytest.approx(want.flops, rel=0.05)
    assert got.wire_bytes == 0.0 and got.collective_by_kind == {}


def _prefill_cost(cfg, S):
    sb = tserve.make_bundle(cfg, batch=1, max_seq=S)
    ins = tspecs.cell_specs(cfg, ShapeConfig("p", S, 1, "prefill"))
    return cost.analyze_step(sb.prefill_fn, sb.abstract_params,
                             ins["batch"])


def test_prefill_bytes_linear_in_seq():
    """The twin of the reference's `test_scan_hbm_not_quadratic`: the
    prompt pass's bytes grow with S, not S^2 (the attention unit bills
    q, k, v, o and the lse, not the scores)."""
    cfg = tconfigs.get("smollm_360m")
    small, big = _prefill_cost(cfg, 1024), _prefill_cost(cfg, 16384)
    ratio = big.hbm_bytes / small.hbm_bytes
    assert ratio < 20, ratio          # 16x longer prompts
    assert big.flops / small.flops > 16   # the attention is quadratic


def test_units_price_the_kernels_and_run_only_on_meta():
    """A unit's flops and bytes are its kernel's `cost(...)`, the
    attention's counted over the unmasked pairs; outside the cost mode,
    or on a CPU tensor inside it, the plain version runs."""
    cfg = tconfigs.reduced("smollm_360m")
    shape = ShapeConfig("t", 32, 2, "train")
    st = ttrain.abstract_train_state(cfg)
    step = ttrain.build_train_step(cfg, TrainConfig(remat="block"))
    c = cost.analyze_step(step, st, tspecs.train_batch_specs(cfg, shape))
    # remat by block: every layer's forward runs twice, its backward once
    assert c.units == {"flash_mha": 2 * cfg.num_layers,
                       "flash_mha_bwd": cfg.num_layers}
    q = torch.empty(2, 32, 4, 16, device="meta")
    k = torch.empty(2, 32, 2, 16, device="meta")
    _, mode = cost.run_counted(lambda q, k: fops.mha(q, k, k), q, k)
    f, b = fops.mha_cost(q.shape, k.shape, itemsize=4)
    assert mode.units == {"flash_mha": 1} and (mode.flops, mode.fused) == \
        (f, b)
    assert f == 4 * 16 * fops.attn_pairs(2, 32, 32, 4, True)
    tk.reset_counters()
    qc, kc = torch.randn(1, 8, 2, 8), torch.randn(1, 8, 1, 8)
    _, mode = cost.run_counted(lambda q, k: fops.mha(q, k, k), qc, kc)
    assert mode.units == {} and tk.REFERENCE_CALLS["mha"] == 1
    assert not tk.costed(q)


@pytest.mark.parametrize("Sq,Skv,off,causal", [
    (1, 1, 0, True), (17, 17, 0, True), (8, 40, 32, True), (40, 8, 0, True),
    (5, 9, -3, True), (33, 70, 5, True), (12, 30, 0, False)])
def test_attn_pairs_closed_form(Sq, Skv, off, causal):
    loop = 3 * 2 * (sum(max(0, min(Skv, off + i + 1)) for i in range(Sq))
                    if causal else Sq * Skv)
    assert fops.attn_pairs(3, Sq, Skv, 2, causal, off) == loop


@pytest.mark.parametrize("S", [1, 63, 64, 65, 128, 200])
def test_ssd_flops_closed_form(S):
    B, H, P, N, Q = 2, 3, 8, 16, 64
    loop = 0
    for c0 in range(0, S, Q):
        L = min(Q, S - c0)
        loop += 2 * (L * (L + 1) // 2 * (N + P) + 2 * L * P * N)
    assert sops.ssd_flops(B, S, H, P, N) == B * H * loop
    from repro_torch.kernels.ssd_scan import ssd_scan

    assert ssd_scan.Q == Q


def test_decode_unit_reads_the_whole_extent():
    q = torch.empty(4, 8, 64, device="meta")
    k = torch.empty(4, 100, 2, 64, device="meta")
    _, mode = cost.run_counted(
        lambda q, k: dops.decode_mha(q, k, k, 5), q, k)
    assert mode.units == {"flash_decode": 1}
    assert (mode.flops, mode.fused) == dops.decode_cost(
        q.shape, k.shape, 4 * 100, itemsize=4)


@pytest.mark.parametrize("arch", ["smollm_360m", "mamba2_780m"])
def test_hotspot_groups_sum_to_totals(arch):
    cfg = tconfigs.reduced(arch)
    st = ttrain.abstract_train_state(cfg)
    step = ttrain.build_train_step(cfg, TrainConfig())
    batch = tspecs.train_batch_specs(cfg, ShapeConfig("t", 32, 2, "train"))
    total = cost.analyze_step(step, st, batch)
    for depth in (1, 3, 6):
        agg = hotspots.hotspots(step, st, batch, depth=depth)
        assert sum(v["flops"] for v in agg.values()) == \
            pytest.approx(total.flops, rel=1e-12)
        assert sum(v["bytes"] for v in agg.values()) == \
            pytest.approx(total.hbm_bytes, rel=1e-12)
        assert sum(v["count"] for v in agg.values()) > 0
    assert any(k.startswith("model.loss_fn") for k in agg)
    assert any(k.startswith("(backward)/") for k in agg)


# --------------------------------------------------------- the roofline
@pytest.mark.parametrize("wire", [0.0, 3.5e9])
def test_roofline_report_matches_reference(wire):
    coll = {"all-reduce": wire} if wire else {}
    jc = HloCostModel(flops=4.2e15, hbm_bytes=7.1e12, hbm_bytes_raw=9e12,
                      wire_bytes=wire, collective_by_kind=coll,
                      warnings=["w"])
    tc = cost.CostModel(flops=4.2e15, hbm_bytes=7.1e12, hbm_bytes_raw=9e12,
                        wire_bytes=wire, collective_by_kind=coll,
                        warnings=["w"])
    j = jrl.report("smollm_360m", "train_4k", "16x16", jc, n_devices=256,
                   model_flops=6e17)
    t = trl.report("smollm_360m", "train_4k", "16x16", tc, n_devices=256,
                   model_flops=6e17, chip=_ref_chip())
    _close(dataclasses.asdict(t), dataclasses.asdict(j), 1e-9)
    _close(t.row(), j.row(), 1e-9)
    h = trl.report("a", "s", "1", tc, n_devices=1, model_flops=1e15)
    assert h.t_compute == tc.flops / thw.H100.peak_flops_bf16
    assert h.t_collective == (wire / thw.H100.link_bw if wire else 0.0)


# ------------------------------------------------------ records, analyze
@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The port's dry-run records of smollm-360m's decode_32k and
    prefill_32k at published widths (meta tensors)."""
    out = tmp_path_factory.mktemp("dryrun_torch")
    recs = dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                        "--outdir", str(out)])
    recs += dryrun.main(["--arch", "smollm-360m", "--shape", "prefill_32k",
                         "--outdir", str(out)])
    return out, recs


def test_dryrun_records(records):
    out, recs = records
    for rec in recs:
        assert rec["status"] == "ok" and rec["mesh"] == "1"
        path = out / f"smollm_360m_{rec['shape']}_1.json"
        assert json.loads(path.read_text()) == rec
        assert set(rec) >= {"memory_analysis", "hlo_cost", "roofline",
                            "dispatch_cost"}
        assert rec["hlo_cost"]["wire_bytes_per_device"] == 0
        assert rec["roofline"]["t_collective_s"] == 0
        assert rec["memory_analysis"]["argument_bytes"] > 0
        units = rec["dispatch_cost"]["units"]
        cfg = tconfigs.get("smollm_360m")
        key = "flash_decode" if rec["shape"] == "decode_32k" else \
            "flash_mha"
        assert units == {key: cfg.num_layers}
    dec = recs[0]
    assert dec["roofline"]["dominant"] == "memory"


def test_analyze_with_record_matches_reference(records):
    """The same record through both packages' `analyze` on the one card
    it was traced on (the reference's chip and topology, a 1 x 1 mesh):
    levels 1-3 equal to rel=1e-9, the compute time the record's."""
    _, recs = records
    one = JMeshConfig((1, 1), ("data", "model"))
    for rec in recs:
        j = jq.analyze("smollm_360m", rec["shape"], dryrun_record=rec,
                       mesh_cfg=one)
        t = tq.analyze("smollm_360m", rec["shape"], dryrun_record=rec,
                       chip=_ref_chip(), topo=_ref_topology(), n_chips=1)
        _close(t.level1, j.level1, 1e-9)
        _close(t.level2, j.level2, 1e-9)
        _close(t.level3, j.level3, 1e-9)
        assert tq.t_compute_for(tconfigs.get("smollm_360m"), None, 1,
                                dryrun_record=rec) == \
            rec["roofline"]["t_compute_s"]


def test_analyze_reads_the_ports_records_only(records, tmp_path,
                                              monkeypatch):
    out, recs = records
    monkeypatch.chdir(tmp_path)
    # no record: the analytic compute time, as use_dryrun=False
    a = tq.analyze("smollm_360m", "decode_32k", use_dryrun=True)
    b = tq.analyze("smollm_360m", "decode_32k", use_dryrun=False)
    _close(a.level1, b.level1, 0)
    # a reference-style record under results/dryrun/ is never read
    (tmp_path / "results" / "dryrun").mkdir(parents=True)
    (tmp_path / "results" / "dryrun" /
     "smollm_360m_decode_32k_16x16.json").write_text(json.dumps(
         {"status": "ok", "mesh": "16x16",
          "roofline": {"t_compute_s": 123.0}}))
    _close(tq.analyze("smollm_360m", "decode_32k").level1, b.level1, 0)
    # the port's record under results/dryrun_torch/ is
    (tmp_path / "results" / "dryrun_torch").mkdir(parents=True)
    rec = recs[0]
    (tmp_path / "results" / "dryrun_torch" /
     "smollm_360m_decode_32k_1.json").write_text(json.dumps(rec))
    assert tq.load_dryrun_record("smollm-360m", "decode_32k") == rec
    c = tq.analyze("smollm_360m", "decode_32k")
    assert c.level1["arithmetic_intensity"] == pytest.approx(
        rec["roofline"]["t_compute_s"] * thw.H100.peak_flops_bf16
        / c.level1["traffic_bytes_per_step_per_chip"], rel=1e-12)
    tq._profile_for_cached.cache_clear()
    p = tq.profile_for("smollm_360m", use_dryrun=True)
    assert p.t_compute == pytest.approx(rec["roofline"]["t_compute_s"])
    from repro_torch.sched.workload import catalog_stream

    jobs = catalog_stream(4, archs=["smollm_360m"], use_dryrun=True)
    assert len(jobs) == 4 and jobs[0].profile.t_compute == p.t_compute
    tq._profile_for_cached.cache_clear()


@pytest.mark.parametrize("mesh,n_chips", [("16x16", 1), ("1", 2),
                                          ("1", 256)])
def test_record_priced_on_other_cards_names_a16(mesh, n_chips):
    """A record prices one rank of the mesh it was traced on (A16c): a
    mesh record over another number of cards, or a one-card record over
    several, raises; a record over as many cards as its mesh holds is
    read (`tests/test_torch_mesh_dryrun.py`)."""
    rec = {"status": "ok", "mesh": mesh, "roofline": {"t_compute_s": 1.0}}
    with pytest.raises(ValueError, match=f"mesh {mesh} "):
        tq.analyze("smollm_360m", "decode_32k", dryrun_record=rec,
                   n_chips=n_chips)


def test_records_are_read_on_one_card_only(records, tmp_path):
    """Over a number of cards that names no mesh (`quantify.MESH_OF_CHIPS`:
    1, 256, 512) no record is read from disk: the analytic compute time,
    whether or not the cell's one-card record exists."""
    _, recs = records
    (tmp_path / "results" / "dryrun_torch").mkdir(parents=True)
    (tmp_path / "results" / "dryrun_torch" /
     "smollm_360m_decode_32k_1.json").write_text(json.dumps(recs[0]))
    a = tq.analyze("smollm_360m", "decode_32k", n_chips=2)
    b = tq.analyze("smollm_360m", "decode_32k", n_chips=2, use_dryrun=False)
    _close(a.level1, b.level1, 0)


def test_mesh_records_and_flags_name_a16(tmp_path):
    """The mesh flags are ported (A16c): `--mesh 2x2` and `--multi-pod`
    write a record of the mesh's rank 0 named by the mesh, `--no-fsdp`
    alone is refused by the parser; a 16x16 record prices 256 cards; the
    serve bundle takes a `DeviceMesh` or an `AbstractMesh`, nothing
    else."""
    rec = {"status": "ok", "mesh": "16x16",
           "roofline": {"t_compute_s": 1.0}}
    a = tq.analyze("smollm_360m", "decode_32k", dryrun_record=rec,
                   n_chips=256)
    assert a.profile.t_compute == 1.0
    for flag, name, n in ((["--mesh", "2x2"], "2x2", 4),
                          (["--multi-pod"], "2x16x16", 512)):
        (got,) = dryrun.main(["--arch", "smollm-360m", "--shape",
                              "decode_32k", "--outdir", str(tmp_path),
                              *flag])
        assert got["status"] == "ok" and got["mesh"] == name
        assert got["n_devices"] == n
        assert got["hlo_cost"]["wire_bytes_per_device"] > 0
        assert json.loads((tmp_path / f"smollm_360m_decode_32k_{name}.json")
                          .read_text()) == got
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                     "--outdir", str(tmp_path), "--no-fsdp"])
    with pytest.raises(TypeError, match="DeviceMesh"):
        tserve.make_bundle(tconfigs.reduced("smollm_360m"), batch=1,
                           max_seq=8, mesh=object())


def test_failed_cell_is_recorded_and_exits_1(tmp_path, monkeypatch,
                                             capsys):
    def boom(*a, **k):
        raise RuntimeError("cannot trace on meta")

    monkeypatch.setattr(dryrun, "lower_cell", boom)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                     "--outdir", str(tmp_path)])
    assert e.value.code == 1
    rec = json.loads((tmp_path / "smollm_360m_decode_32k_1.json")
                     .read_text())
    assert rec["status"] == "error" and "cannot trace" in rec["error"]
    assert "FAIL smollm_360m decode_32k" in capsys.readouterr().out


@pytest.mark.parametrize("tier", ["none", "hotness"])
def test_microbatch_extrapolation_is_exact(tier):
    """Above 3 microbatches the train cell is extrapolated from its steps
    of 2 and 3: equal to tracing all of them."""
    from repro_torch.runtime import tiering

    cfg = tconfigs.reduced("smollm_360m")
    shape = ShapeConfig("t", 32, 8, "train")
    tcfg = TrainConfig(microbatches=4)
    assert dryrun.cell_parts(cfg, shape, 4) == [2, 3]
    got, _, _, _ = dryrun.cell_cost(cfg, shape, remat=tcfg.remat,
                                    microbatches=4, tier_policy=tier)
    bundle = ttrain.make_bundle(cfg, tcfg)
    st = bundle.abstract_state
    if tier != "none":
        st, bundle, _ = tiering.apply_tier_shardings(
            cfg, tcfg, bundle, shape, policy=tier, pool_fraction=0.5)
    want = cost.analyze_step(bundle.step_fn, st,
                             tspecs.train_batch_specs(cfg, shape))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)

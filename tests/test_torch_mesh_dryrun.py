"""The dry-run and the analysis over a mesh (`launch.dryrun --mesh`,
`--multi-pod`; `launch.mesh.AbstractMesh`; the collectives of
`common.parallel` under the cost mode; `core.quantify.analyze` reading a
mesh record), on the CPU.

* The meta trace of rank 0 of a (2, 2) `AbstractMesh` issues the same
  collectives (kind, input shape, axis, in order) as rank 0 of a real
  (2, 2) mesh of 4 gloo ranks (`dev_serve_torch.mesh_collectives_rank`),
  for a decode step of the serve bundle and a train step (two
  microbatches, remat by block) of reduced granite-3-2b.
* Wire bytes follow the reference's ring model (`repro.profiler.hlo`),
  counted by hand for each kind, and a traced step's wire bytes are the
  sum over its collectives.
* A (1, 1) mesh's record equals the one-card record but for its mesh
  name (no collective runs: wire 0); a mesh record prices the mesh's
  cards: `analyze(n_chips=256)` reads the 16x16 record's `t_compute_s`,
  as the reference's `analyze` reads its 16x16 record (levels 1-3 to
  1e-9 with the reference's chip, topology and the same record).
* Every reduced arch's decode step and train step (two microbatches,
  remat by block) on a (2, 2) mesh traces with collectives and the
  meshless cell's kernel units; the train cells of the SSM, hybrid,
  encoder-decoder and vision-prefix stacks at published widths (depth
  cut to one layer period) write `ok` records over `--mesh 2x2`.
* mamba2-780m over a 1x32 mesh, whose model axis cuts its heads (1.5 of
  48 a rank, run as virtual heads of 32): every cell traces, and the
  decode step gathers each layer's SSM state over `model`, priced by the
  ring model."""

import dataclasses
import json
import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.common.config import MeshConfig as JMeshConfig  # noqa: E402
from repro.core import quantify as jq  # noqa: E402
from repro.core import tiers as jtiers  # noqa: E402
from repro.common import hw as jhw  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.common import hw as thw  # noqa: E402
from repro_torch.common.config import ShapeConfig  # noqa: E402
from repro_torch.common.parallel import (  # noqa: E402
    ParallelCtx,
    _reduce_scatter,
    all_gather,
    all_to_all,
    psum,
)
from repro_torch.core import quantify as tq  # noqa: E402
from repro_torch.core import tiers as ttiers  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.profiler import cost  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import dev_serve_torch as dst  # noqa: E402

DECODE = (4, 16)            # batch, max_seq
TRAIN = (8, 16, 2)          # batch, seq, microbatches


@pytest.fixture(autouse=True)
def _cwd_without_records(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)


def _granite():
    return dataclasses.replace(tconfigs.reduced("granite_3_2b"),
                               dtype="float32")


@pytest.fixture(scope="module")
def real_collectives():
    """Rank 0's collectives on a real (2, 2) mesh of 4 gloo ranks."""
    got = tmesh.run_ranks(dst.mesh_collectives_rank, 4,
                          (_granite(), 2, 2, DECODE, TRAIN, "cpu"),
                          device="cpu", threads=1, timeout_s=120,
                          wall_s=300)
    return got[0]


def _meta_cost(kind: str, mesh=None):
    cfg = _granite()
    mesh = mesh or tmesh.AbstractMesh((2, 2), ("data", "model"))
    if kind == "decode":
        shape = ShapeConfig("decode_t", DECODE[1], DECODE[0], "decode")
        return dryrun.part_cost(cfg, shape, mesh=mesh)[0]
    B, S, k = TRAIN
    shape = ShapeConfig("train_t", S, B, "train")
    return dryrun.part_cost(cfg, shape, microbatches=k, mesh=mesh)[0]


@pytest.mark.parametrize("kind", ["decode", "train"])
def test_meta_trace_issues_the_real_collectives(real_collectives, kind):
    got = _meta_cost(kind)
    want = [(k, tuple(s), a) for k, s, a in real_collectives[kind]]
    assert got.collectives == want
    assert got.collective_counts == {
        k: sum(1 for c in want if c[0] == k) for k in {c[0] for c in want}}
    assert got.wire_bytes > 0


def _ring(kind: str, nbytes: int, n: int) -> float:
    return {"all-reduce": 2 * nbytes, "all-gather": n * nbytes}.get(
        kind, nbytes) * (n - 1) / n


def test_wire_bytes_follow_the_ring_model():
    """One collective of each kind on a (2, 4) mesh, counted by hand:
    all-reduce of 4 x 8 float32 over model (n 4) 2 * 128 * 3/4 = 192,
    all-gather of 4 x 8 bf16 over data (n 2) out 128 * 1/2 = 64,
    all-to-all of 4 x 8 float32 over model 128 * 3/4 = 96, a
    reduce-scatter of 8 x 8 float32 over data 256 * 1/2 = 128."""
    mesh = tmesh.AbstractMesh((2, 4), ("data", "model"))
    ctx = ParallelCtx(mesh=mesh, dp_axes=("data",), tp_axis="model")
    a = torch.empty(4, 8, device="meta")
    b = torch.empty(4, 8, dtype=torch.bfloat16, device="meta")
    c = torch.empty(8, 8, device="meta")

    def step():
        psum(a, ctx, "model")
        all_gather(b, ctx, "data", 0)
        all_to_all(a, ctx, "model")
        return _reduce_scatter(c, ctx, "data", 0)

    _, mode = cost.run_counted(step)
    assert mode.by_kind == {"all-reduce": 192, "all-gather": 64,
                            "all-to-all": 96, "reduce-scatter": 128}
    assert mode.wire == 480
    assert [k for k, _, _ in mode.collectives] == [
        "all-reduce", "all-gather", "all-to-all", "reduce-scatter"]
    # a real tensor over an AbstractMesh has no process group to run on
    with pytest.raises(RuntimeError, match="no process group"):
        psum(torch.ones(2), ctx, "model")


def test_step_wire_is_the_sum_of_its_collectives():
    """The float32 decode step's wire bytes: the ring model over each of
    its collectives (every one moves float32), summed."""
    got = _meta_cost("decode")
    sizes = {"data": 2, "model": 2}
    total = sum(_ring(k, 4 * _numel(s), sizes[a])
                for k, s, a in got.collectives)
    assert got.wire_bytes == pytest.approx(total, rel=1e-12)
    assert sum(got.collective_by_kind.values()) == pytest.approx(
        got.wire_bytes, rel=1e-12)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _record(tmp, *flags):
    (rec,) = dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                          "--outdir", str(tmp), *flags])
    return rec


def test_one_by_one_mesh_record_equals_one_card(tmp_path):
    one = _record(tmp_path)
    mesh = _record(tmp_path, "--mesh", "1x1")
    assert mesh["mesh"] == "1x1" and one["mesh"] == "1"
    assert mesh["hlo_cost"]["wire_bytes_per_device"] == 0
    assert mesh["hlo_cost"]["collective_counts"] == {}
    for rec in (one, mesh):
        rec.pop("mesh")
        rec.pop("wall_s")
    assert mesh == one


def test_analyze_reads_the_16x16_record(tmp_path):
    rec = _record(tmp_path / "results" / "dryrun_torch", "--mesh", "16x16")
    assert rec["n_devices"] == 256 and rec["status"] == "ok"
    assert tq.load_dryrun_record("smollm-360m", "decode_32k", "16x16") == rec
    a = tq.analyze("smollm_360m", "decode_32k", n_chips=256)
    b = tq.analyze("smollm_360m", "decode_32k", n_chips=256,
                   use_dryrun=False)
    t = rec["roofline"]["t_compute_s"]
    assert a.profile.t_compute == t != b.profile.t_compute
    assert a.level1["arithmetic_intensity"] == pytest.approx(
        t * thw.H100.peak_flops_bf16
        / a.level1["traffic_bytes_per_step_per_chip"], rel=1e-12)
    # the same record through the reference's analyze on its 16x16 mesh
    j = jq.analyze("smollm_360m", "decode_32k", dryrun_record=rec,
                   mesh_cfg=JMeshConfig((16, 16), ("data", "model")))
    jt, c = jtiers.v5e_topology(), jhw.V5E
    ref_topo = ttiers.TierTopology(
        tiers=tuple(ttiers.TierSpec(**dataclasses.asdict(t))
                    for t in jt.tiers),
        shared_link_bw=jt.shared_link_bw, chips_per_pool=jt.chips_per_pool)
    ref_chip = thw.ChipSpec(name=c.name, peak_flops_bf16=c.peak_flops_bf16,
                            hbm_bytes=c.hbm_bytes, hbm_bw=c.hbm_bw,
                            link_bw=jhw.bidir_ici_bw(c), num_sms=0,
                            smem_per_block=0, l2_bytes=0.0)
    t_ref = tq.analyze("smollm_360m", "decode_32k", dryrun_record=rec,
                       chip=ref_chip, topo=ref_topo, n_chips=256)
    for lvl in ("level1", "level2", "level3"):
        _close(getattr(t_ref, lvl), getattr(j, lvl))


def _close(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
    elif isinstance(a, (int, float)) and not isinstance(a, bool):
        assert a == pytest.approx(b, rel=1e-9, abs=1e-12)
    else:
        assert a == b


@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_mesh_decode_per_arch(arch):
    """Every arch's decode step traces on a (2, 2) mesh: the same kernel
    units as its meshless cell (a rank runs every layer), with
    collectives on the wire."""
    cfg = tconfigs.reduced(arch)
    mesh = tmesh.AbstractMesh((2, 2), ("data", "model"))
    shape = ShapeConfig("decode_t", 16, 4, "decode")
    c = dryrun.part_cost(cfg, shape, mesh=mesh)[0]
    assert c.units == dryrun.part_cost(cfg, shape)[0].units
    if not (cfg.num_encoder_layers or cfg.family in ("ssm", "hybrid")):
        assert c.units == {"flash_decode": cfg.num_layers}
    assert c.wire_bytes > 0 and c.collective_counts["all-gather"] > 0


@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_mesh_train_per_arch(arch):
    """Every arch's train step (two microbatches, remat by block) traces
    on a (2, 2) mesh: the meshless step's kernel units (a rank runs
    every layer of every microbatch on its rows), the FSDP gathers and
    their reduce-scatter backward on the wire."""
    cfg = tconfigs.reduced(arch)
    mesh = tmesh.AbstractMesh((2, 2), ("data", "model"))
    shape = ShapeConfig("train_t", 16, 4, "train")
    c, _, _, mb = dryrun.part_cost(cfg, shape, microbatches=2, mesh=mesh)
    assert mb == 2
    assert c.units == dryrun.part_cost(cfg, shape, microbatches=2)[0].units
    assert c.wire_bytes > 0
    assert c.collective_counts["all-gather"] > 0
    assert c.collective_counts["reduce-scatter"] > 0


def _one_period(cfg):
    """`cfg` cut to one period of its layer pattern (widths kept)."""
    from repro_torch.models import blocks

    n = blocks.super_period(cfg)
    return dataclasses.replace(cfg, num_layers=n, num_encoder_layers=min(
        cfg.num_encoder_layers, n))


@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-1.5-large-398b",
                                  "seamless-m4t-large-v2", "paligemma-3b"])
def test_stack_train_cells_write_ok_records(arch, tmp_path, monkeypatch):
    """The train_4k cells of the SSM, hybrid, encoder-decoder and
    vision-prefix stacks over `--mesh 2x2` (published widths, depth cut
    to one layer period, two microbatches: one piece, traced in this
    process) write `ok` records with wire bytes and exit 0; each
    SSM-bearing cell launches the scan, each attention-bearing one the
    flash forward and its backward."""
    get = tconfigs.get
    monkeypatch.setattr(tconfigs, "get", lambda a: _one_period(get(a)))
    (rec,) = dryrun.main(["--arch", arch, "--shape", "train_4k", "--mesh",
                          "2x2", "--microbatches", "2",
                          "--outdir", str(tmp_path)])
    name = tconfigs.canonical(arch)
    assert rec == json.loads((tmp_path / f"{name}_train_4k_2x2.json")
                             .read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 4
    assert rec["hlo_cost"]["wire_bytes_per_device"] > 0
    units = rec["dispatch_cost"]["units"]
    cfg = get(name)
    assert ("ssd_scan" in units) == cfg.sub_quadratic
    assert ("flash_mha_bwd" in units) == (cfg.family != "ssm")


def test_ssm_head_cut_mesh_gathers_the_state_each_layer():
    """mamba2-780m (48 heads of 64, d_inner 3072, state 128) over a 1x32
    `AbstractMesh`, depth cut to 2 layers: a rank holds 96 channels of
    `d_inner`, 1.5 heads, run as 3 virtual heads of 32. Every cell of
    the arch (train with one microbatch) traces with collectives and
    the meshless cell's scan units; the decode step issues one
    all-gather of the rank's (B, 96, 128) float32 state block over
    `model` a layer, each priced n (n - 1) / n of its input's bytes
    (the ring model, n 32), and its state stays whole: every head at
    the rank's slots."""
    cfg = dataclasses.replace(tconfigs.get("mamba2_780m"), num_layers=2)
    mesh = tmesh.AbstractMesh((1, 32), ("data", "model"))
    assert cfg.d_inner // 32 == 96 and cfg.ssm_heads % 32
    for shape in tconfigs.shapes_for("mamba2_780m"):
        kw = dict(microbatches=1) if shape.kind == "train" else {}
        c = dryrun.part_cost(cfg, shape, mesh=mesh, **kw)[0]
        assert c.wire_bytes > 0, shape.name
        assert c.units == dryrun.part_cost(cfg, shape, **kw)[0].units
        if shape.kind != "decode":
            continue
        B, N = shape.global_batch, cfg.ssm_state
        gathers = [g for g in c.collectives
                   if g == ("all-gather", (B, 96, N), "model")]
        assert len(gathers) == cfg.num_layers, c.collectives
        wire = 4 * B * 96 * N * 32 * 31 / 32
        assert c.collective_by_kind["all-gather"] >= cfg.num_layers * wire
    from repro_torch.runtime import serve as tserve

    sb = tserve.make_bundle(cfg, batch=4, max_seq=16, mesh=mesh)
    assert sb.cache_pspecs["pos0"]["state"] == (None, None, None, None,
                                                None)

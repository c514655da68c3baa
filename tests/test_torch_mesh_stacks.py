"""Serving SSM, hybrid and encoder-decoder stacks on a mesh, on the CPU: 4
gloo ranks spawned once for the module (`launch.mesh.run_ranks`) as a
dp2tp2 mesh, every case of the module in that one set of ranks (a
one-rank (1, 1) set beside it), float32, reduced configs, against the
meshless ops, the port's meshless engine and the JAX meshless engine on
the same weights (the reference's `init_model(PRNGKey(0))` carried over
as numpy) and prompts.

* `ssm_block` and `ssm_decode_step` of reduced mamba2 (8 heads, 4 a
  rank; the B / C tails' 16 channels split too) within 1e-5 of meshless:
  outputs, and the rank's state and tails against the meshless ones cut
  by `cache_pspec`; `make_ssm_state(ctx=)` gives the spec's local
  shapes.
* An SSM head cut across two ranks (d_inner % tp == 0, H % tp != 0; the
  rank runs its block of `d_inner` as virtual heads): reduced mamba2
  with d_model 48 and heads of 32 (3 heads, 1.5 a rank) and reduced
  jamba with heads of 128 (1 head, half a rank). `ssm_block` and
  `ssm_decode_step` within 1e-5 of meshless, the state whole and
  bit-equal on both tp ranks; their paged fp and contiguous engines'
  tokens equal the JAX meshless engine's, and their resident leaves the
  port's meshless engine's cut by the specs (the state whole).
* Cross-attention of reduced seamless: the prefill and the decode on the
  paged layout's cross-KV (the rank's KV heads) and on the contiguous
  one's (every head at the rank's block of encoder positions, merged
  over tp) within 1e-5 of meshless.
* The paged engine (fp and int8 pools) and the contiguous engine of
  reduced mamba2, jamba and seamless over dp2tp2, each built by
  `ServingEngine.build(mesh=)` with its defaults: fp tokens equal the JAX
  meshless engine's, int8 at least `INT8_TOKEN_AGREEMENT` of them; every
  rank's tokens equal; each rank's slot-resident leaves (SSM state, conv
  tails, cross-KV) within 1e-5 of the port's meshless engine's cut by
  `paged_cache_pspec` / `cache_pspec`, a quarter of their bytes; the data
  replicas of each paged pool bit-equal. Seamless's frame embeddings are
  the JAX engine's, handed to every engine. Jamba's MoE layers run
  `moe_ep` on the mesh and `moe_dense` without one; its capacity factor
  is 8.0, at which `moe_ep` drops no token (`moe_dense` never drops).
* (1, 1) over one gloo rank: tokens, every pool leaf and every resident
  leaf bit-equal to the meshless engine's."""

import dataclasses
import pathlib
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.common.parallel import ParallelCtx as JCtx  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.common.parallel import ParallelCtx  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.module import layer_slice  # noqa: E402
from repro_torch.models.module import load_numpy_params  # noqa: E402
from repro_torch.runtime import sharding as tshd  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from repro_torch.serving.engine import INT8_TOKEN_AGREEMENT  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import dev_serve_torch as dst  # noqa: E402

ARCHS = ("mamba2_780m", "jamba_1_5_large_398b", "seamless_m4t_large_v2")
DP, TP = 2, 2
N_REQ, S, GEN = 4, 8, 6
TOL = dict(atol=1e-5, rtol=1e-5)
# the SSM head cut across the tp ranks: (arch, overrides)
CUT = {"mamba2_cut": ("mamba2_780m", dict(d_model=48, ssm_head_dim=32)),
       "jamba_cut": ("jamba_1_5_large_398b", dict(ssm_head_dim=128))}
RUNS = (dict(pool_dtype="fp", name="pool fp", resident=True),
        dict(pool_dtype="int8", name="pool int8"),
        dict(paged=False, pool_dtype="fp", name="contiguous fp",
             resident=True))
# a head cut keeps the state whole over model (1/dp of it a rank)
CUT_RUNS = tuple(dict(r, whole=("state",)) for r in (RUNS[0], RUNS[2]))
ONE_RUNS = (dict(pool_dtype="int8", name="pool int8"),
            dict(paged=False, pool_dtype="fp", name="contiguous fp"))
STUB = SimpleNamespace(shape={"data": DP, "model": TP})


def _cfgs(arch, **over):
    if arch == "jamba_1_5_large_398b":
        over = dict(capacity_factor=8.0, **over)
    return (dataclasses.replace(jconfigs.reduced(arch), dtype="float32",
                                **over),
            dataclasses.replace(tconfigs.reduced(arch), dtype="float32",
                                **over))


def _any_cfgs(name):
    """`_cfgs` of an arch of ARCHS or a head-cut variant of CUT."""
    if name in CUT:
        arch, over = CUT[name]
        return _cfgs(arch, **over)
    return _cfgs(name)


def _weights(jc):
    jp, _ = JM.init_model(jc, jax.random.PRNGKey(0))
    return jp, jax.tree.map(np.asarray, jp)


def _prompts(vocab):
    return np.random.default_rng(1).integers(0, vocab, (N_REQ, S))


def _jax_extras(jc):
    """The JAX engine's frontend embeddings of each request (numpy), or
    None for a token-only arch."""
    if not jc.frontend:
        return None
    host = SimpleNamespace(cfg=jc)
    return {i: {k: np.asarray(v) for k, v in JServingEngine._frontend_extras(
        host, JRequest(request_id=i, tokens=np.zeros(S, np.int32),
                       max_new_tokens=GEN, arrival=0.0), S).items()}
        for i in range(N_REQ)}


def _run_fields(run):
    return {k: v for k, v in run.items()
            if k not in ("name", "resident", "extras", "whole")}


def _port_engine(tc, np_params, run, extras):
    ecfg = dst.mesh_ecfg(N_REQ, S, GEN, **_run_fields(run))
    eng = ServingEngine.build(tc, ecfg, device="cpu",
                              params=load_numpy_params(np_params,
                                                       device="cpu"))
    if extras is not None:
        eng._frontend_extras = dst.fixed_extras(extras, "cpu")
    prompts = _prompts(tc.vocab_size)
    reqs = [Request(request_id=i, tokens=prompts[i], max_new_tokens=GEN,
                    arrival=0.0) for i in range(N_REQ)]
    eng.run(reqs)
    return dict(tokens=np.stack([np.asarray(r.output) for r in reqs]),
                digests=dst.pool_digests(eng.caches),
                pool_bytes=dst.pool_nbytes(eng.caches),
                resident_digests=dst.resident_digests(eng.caches),
                resident_bytes=dst.resident_nbytes(eng.caches),
                resident={k: x.numpy() for k, x in
                          dst.resident_leaves(eng.caches).items()},
                cache_pspecs=(tshd.paged_cache_pspec if eng.cells.paged
                              else tshd.cache_pspec)(
                    eng.cells.abstract_caches, ("data",), "model", STUB))


def _jax_tokens(jc, jp, run):
    kw = dataclasses.asdict(dst.mesh_ecfg(N_REQ, S, GEN, **_run_fields(run)))
    ecfg = JEngineConfig(**{k: v for k, v in kw.items()
                            if k in JEngineConfig.__dataclass_fields__})
    eng = JServingEngine.build(jc, JCtx(remat="none"), ecfg, params=jp)
    prompts = _prompts(jc.vocab_size)
    reqs = [JRequest(request_id=i, tokens=prompts[i], max_new_tokens=GEN,
                     arrival=0.0) for i in range(N_REQ)]
    eng.run(reqs)
    return np.stack([np.asarray(r.output) for r in reqs])


def _op_cases():
    """The SSM case (reduced mamba2), the cross case (reduced seamless)
    and the head-cut SSM cases (CUT): global weights and inputs as
    numpy."""
    rng = np.random.default_rng(2)
    out = {}
    for arch, kind in (("mamba2_780m", "ssm"),
                       ("seamless_m4t_large_v2", "cross"),
                       *((name, f"ssm {name}") for name in CUT)):
        jc, tc = _any_cfgs(arch)
        _, np_params = _weights(jc)
        d = tc.d_model
        case = dict(kind=kind.split()[0], cfg=tc, params=np_params,
                    x=rng.normal(0, 1, (4, S, d)).astype(np.float32),
                    x1=rng.normal(0, 1, (4, 1, d)).astype(np.float32))
        if kind == "cross":
            case["enc"] = rng.normal(0, 1, (4, 2 * S, d)).astype(np.float32)
        out[kind] = case
    return out


@pytest.fixture(scope="module")
def runs():
    ops = _op_cases()
    arch_runs, inputs = {}, {}
    for arch in (*ARCHS, *CUT):
        jc, tc = _any_cfgs(arch)
        jp, np_params = _weights(jc)
        ex = _jax_extras(jc)
        arch_runs[arch] = [dict(r, extras=ex) if ex else r
                           for r in (CUT_RUNS if arch in CUT else RUNS)]
        inputs[arch] = (jc, tc, jp, np_params, ex)
    calls = {4: [(dst.mesh_stack_ops_rank, (DP, TP, list(ops.values()),
                                            "cpu"))]
             + [(dst.mesh_rank, (inputs[a][1], DP, TP, inputs[a][3],
                                 _prompts(inputs[a][1].vocab_size), GEN,
                                 arch_runs[a], "cpu"))
                for a in (*ARCHS, *CUT)],
             1: [(dst.mesh_rank, (inputs[a][1], 1, 1, inputs[a][3],
                                  _prompts(inputs[a][1].vocab_size), GEN,
                                  [dict(r, extras=inputs[a][4])
                                   if inputs[a][4] else r
                                   for r in ONE_RUNS], "cpu"))
                 for a in ARCHS]}
    got, errors = {}, []

    def spawn(world):
        try:
            got[world] = tmesh.run_ranks(
                dst.mesh_calls, world, (calls[world],), device="cpu",
                threads=1, timeout_s=120, wall_s=600)
        except BaseException as e:      # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=spawn, args=(w,)) for w in calls]
    for t in threads:
        t.start()
    meshless, jax_tok = {}, {}
    for arch in (*ARCHS, *CUT):
        jc, tc, jp, np_params, ex = inputs[arch]
        # ONE_RUNS' names are among RUNS'
        for run in (CUT_RUNS if arch in CUT else RUNS):
            meshless[(arch, run["name"])] = _port_engine(tc, np_params, run,
                                                         ex)
            jax_tok[(arch, run["name"])] = _jax_tokens(jc, jp, run)
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return dict(ops=ops, op_results=[r[0] for r in got[4]],
                mesh={a: [r[i + 1] for r in got[4]]
                      for i, a in enumerate((*ARCHS, *CUT))},
                one={a: got[1][0][i] for i, a in enumerate(ARCHS)},
                meshless=meshless, jax=jax_tok, inputs=inputs)


def _cut(x, spec, coord):
    """The (data, model) rank's block of a global leaf under `spec`."""
    index = {"data": coord[0], "model": coord[1]}
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else entry
        n = int(np.prod([STUB.shape[a] for a in names]))
        i = 0
        for a in names:
            i = i * STUB.shape[a] + index[a]
        size = x.shape[dim] // n
        x = np.take(x, range(i * size, (i + 1) * size), axis=dim)
    return x


# ----------------------------------------------------------------- ops
def test_ssm_block_and_decode_equal_meshless(runs):
    case = runs["ops"]["ssm"]
    cfg = case["cfg"]
    assert cfg.ssm_heads == 8 and cfg.ssm_state % TP == 0
    p0 = layer_slice(load_numpy_params(case["params"],
                                       device="cpu")["blocks"]["pos0"], 0)
    x, x1 = torch.as_tensor(case["x"]), torch.as_tensor(case["x1"])
    y, (state, tails) = tssm.ssm_block(p0["ssm"], x, cfg, return_state=True)
    y1, (state1, tails1) = tssm.ssm_decode_step(p0["ssm"], x1, cfg, state,
                                                tails)
    want = dict(prefill=y, decode=y1, state=state1,
                **dict(zip(("tail_x", "tail_B", "tail_C"), tails1)))
    specs = tshd.cache_pspec(
        {"pos0": {k: v[None] for k, v in want.items()
                  if k not in ("prefill", "decode")}},
        ("data",), "model", STUB)["pos0"]
    for rank in runs["op_results"]:
        got = rank[list(runs["ops"]).index("ssm")]
        coord = tuple(got["coord"])
        np.testing.assert_allclose(got["prefill"], y.numpy(), **TOL)
        np.testing.assert_allclose(got["decode"], y1.numpy(), **TOL)
        for k, spec in specs.items():
            mine = _cut(want[k].numpy()[None], spec, coord)[0]
            assert got[k].shape == mine.shape, k
            assert got[k].shape != want[k].shape, k
            np.testing.assert_allclose(got[k], mine, **TOL)


def test_cross_attention_equal_meshless(runs):
    case = runs["ops"]["cross"]
    cfg = case["cfg"]
    p0 = layer_slice(load_numpy_params(case["params"],
                                       device="cpu")["blocks"]["pos0"], 0)
    x, x1, enc = (torch.as_tensor(case[n]) for n in ("x", "x1", "enc"))
    kv = tattn.encode_cross_kv(p0["cross"], enc, cfg)
    want = dict(prefill=tattn.cross_attention(p0["cross"], x, kv, cfg),
                decode=tattn.decode_cross_attention(p0["cross"], x1, kv,
                                                    cfg))
    for rank in runs["op_results"]:
        got = rank[list(runs["ops"]).index("cross")]
        np.testing.assert_allclose(got["prefill"], want["prefill"].numpy(),
                                   **TOL)
        for layout in ("paged", "contiguous"):
            np.testing.assert_allclose(got[layout], want["decode"].numpy(),
                                       **TOL)


@pytest.mark.parametrize("name", list(CUT))
def test_ssm_head_cut_equals_meshless(runs, name):
    """A head cut across the two tp ranks (mamba2: 3 heads of 32, 1.5 a
    rank, virtual heads of 16; jamba: 1 head of 128, half a rank, one
    virtual head of 64): `ssm_block` and `ssm_decode_step` within 1e-5 of
    meshless; the state, gathered over tp, whole (every head) on every
    rank, within 1e-5 of the meshless state at the rank's rows and
    bit-equal across the tp ranks of a row; the tails the rank's channels
    of the meshless ones (`cache_pspec`)."""
    case = runs["ops"][f"ssm {name}"]
    cfg = case["cfg"]
    assert cfg.d_inner % TP == 0 and cfg.ssm_heads % TP
    p0 = layer_slice(load_numpy_params(case["params"],
                                       device="cpu")["blocks"]["pos0"], 0)
    x, x1 = torch.as_tensor(case["x"]), torch.as_tensor(case["x1"])
    y, (state, tails) = tssm.ssm_block(p0["ssm"], x, cfg, return_state=True)
    y1, (state1, tails1) = tssm.ssm_decode_step(p0["ssm"], x1, cfg, state,
                                                tails)
    want = dict(state=state1, **dict(zip(("tail_x", "tail_B", "tail_C"),
                                         tails1)))
    specs = tshd.cache_pspec({"pos0": {k: v[None] for k, v in want.items()}},
                             ("data",), "model", STUB)["pos0"]
    assert specs["state"] == tshd.P(None, "data", None, None, None)
    got = [rank[list(runs["ops"]).index(f"ssm {name}")]
           for rank in runs["op_results"]]
    for g in got:
        np.testing.assert_allclose(g["prefill"], y.numpy(), **TOL)
        np.testing.assert_allclose(g["decode"], y1.numpy(), **TOL)
        for k, spec in specs.items():
            mine = _cut(want[k].numpy()[None], spec, g["coord"])[0]
            assert g[k].shape == mine.shape, k
            np.testing.assert_allclose(g[k], mine, **TOL)
        assert g["state"].shape[1:] == (cfg.ssm_heads, cfg.ssm_head_dim,
                                        cfg.ssm_state)
    for a in got:
        for b in got:
            if a["coord"][0] == b["coord"][0]:
                np.testing.assert_array_equal(a["state"], b["state"])


@pytest.mark.parametrize("coord", [(0, 0), (1, 1)])
def test_make_ssm_state_is_the_specs_shard(coord):
    """`make_ssm_state(ctx=)` holds the local shapes of `cache_pspec`'s
    specs of the meshless state: rows over `data`, heads and channels
    over `model`."""
    cfg = tconfigs.reduced("mamba2_780m")

    class Mesh(SimpleNamespace):
        def get_local_rank(self, name):
            return coord[("data", "model").index(name)]

    ctx = ParallelCtx(mesh=Mesh(shape=dict(STUB.shape)), dp_axes=("data",),
                      tp_axis="model")
    whole = dict(zip(("state", "tail_x", "tail_B", "tail_C"),
                     (lambda s, t: (s, *t))(*tssm.make_ssm_state(cfg, 4, 2))))
    local = dict(zip(whole, (lambda s, t: (s, *t))(
        *tssm.make_ssm_state(cfg, 4, 2, ctx=ctx))))
    specs = tshd.cache_pspec({"pos0": whole}, ("data",), "model",
                             STUB)["pos0"]
    for k, x in whole.items():
        assert tuple(local[k].shape) == tshd.local_shape(x.shape, specs[k],
                                                         STUB), k
        assert local[k].numel() * DP * TP == x.numel(), k


# -------------------------------------------------------------- engine
def _per(runs, arch, name):
    arch_runs = CUT_RUNS if arch in CUT else RUNS
    i = [r["name"] for r in arch_runs].index(name)
    return [r[i] for r in runs["mesh"][arch]], arch_runs[i]


def _engine_cases(resident: bool = False):
    """(arch, run name) of every engine run over dp2tp2: each arch of
    ARCHS with RUNS, each head-cut variant of CUT with CUT_RUNS (only the
    runs that return their resident leaves, with `resident`)."""
    return [(a, r["name"]) for a in (*ARCHS, *CUT)
            for r in (CUT_RUNS if a in CUT else RUNS)
            if r.get("resident") or not resident]


@pytest.mark.parametrize("arch,name", _engine_cases())
def test_mesh_engine_against_jax(runs, arch, name):
    per, run = _per(runs, arch, name)
    want = runs["jax"][(arch, name)]
    for r in per:
        np.testing.assert_array_equal(r["tokens"], per[0]["tokens"])
    if run["pool_dtype"] == "fp":
        np.testing.assert_array_equal(per[0]["tokens"], want)
    else:
        assert dst.compare(per[0]["tokens"], want)["min"] >= \
            INT8_TOKEN_AGREEMENT


@pytest.mark.parametrize("arch,name", _engine_cases())
def test_mesh_engine_gates(runs, arch, name):
    """Against the port's meshless engine: the lane's gates
    (`dev_serve_torch.mesh_gates`: ranks equal, fp tokens equal, int8
    agreement, data replicas of the pool bit-equal, pool bytes, each
    rank its specs' share of the resident bytes, placement gap 0), the
    plain versions on every rank and no kernel launched. The specs'
    share is a quarter of them for ARCHS; with a head cut the state is
    whole on every rank (its slots over `data` only)."""
    _, tc, _, _, _ = runs["inputs"][arch]
    per, run = _per(runs, arch, name)
    ref = runs["meshless"][(arch, name)]
    assert ref["resident_bytes"] > 0
    failed = dst.mesh_gates([[r] for r in per], {0: ref["tokens"]},
                            {0: ref["pool_bytes"]}, TP, [run],
                            tc.num_kv_heads % TP == 0,
                            {0: ref["resident_bytes"]})
    assert not failed
    share = {r["shares"]["resident"][0] for r in per}
    if arch in CUT:
        assert share.pop() * DP * TP > ref["resident_bytes"]
    else:
        assert share == {ref["resident_bytes"] // (DP * TP)}
    assert all(r["plain"] and not r["launches"] for r in per)
    assert sorted(r["coord"] for r in per) == [
        (d, m) for d in range(DP) for m in range(TP)]


@pytest.mark.parametrize("arch,name", _engine_cases(resident=True))
def test_mesh_engine_resident_shards(runs, arch, name):
    """Each rank's slot-resident leaves after the run equal the meshless
    engine's cut by the layout's specs (1e-5); on seamless's paged
    layout the cross-KV holds the rank's heads, on the contiguous one
    its block of encoder positions; a head-cut variant's state is whole
    (every head at the rank's slots)."""
    per, _ = _per(runs, arch, name)
    ref = runs["meshless"][(arch, name)]
    assert ref["resident"]
    for r in per:
        assert r["resident"].keys() == ref["resident"].keys()
        for key, x in ref["resident"].items():
            pos, leaf = key.split("/")
            spec = ref["cache_pspecs"][pos][leaf]
            mine = _cut(x, spec, r["coord"])
            assert r["resident"][key].shape == mine.shape, key
            np.testing.assert_allclose(r["resident"][key], mine, **TOL,
                                       err_msg=key)
    if arch in CUT:
        assert all(spec["state"] == tshd.P(None, "data", None, None, None)
                   for spec in ref["cache_pspecs"].values()
                   if "state" in spec)
    if arch == "seamless_m4t_large_v2":
        spec = ref["cache_pspecs"]["pos0"]["cross_k"]
        assert spec == (tshd.P(None, "data", None, "model", None)
                        if name.startswith("pool") else
                        tshd.P(None, "data", "model", None, None))


@pytest.mark.parametrize("arch", ARCHS)
def test_one_by_one_mesh_is_bit_equal(runs, arch):
    """(1, 1) over one gloo rank: tokens, every pool leaf and every
    resident leaf bit-equal to the meshless engine's (no collective runs
    over a size-1 axis)."""
    for i, run in enumerate(ONE_RUNS):
        got = runs["one"][arch][i]
        ref = runs["meshless"][(arch, run["name"])]
        np.testing.assert_array_equal(got["tokens"], ref["tokens"])
        assert got["digests"] == ref["digests"]
        assert got["resident_digests"] == ref["resident_digests"]
        assert got["resident_digests"]

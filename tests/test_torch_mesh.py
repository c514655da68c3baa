"""Serving on a mesh (`runtime.serve.make_engine_cells(mesh=...)`), on the
CPU: 4 gloo ranks spawned once for the module (`launch.mesh.run_ranks`)
as a dp2tp2 mesh, every case of the module in that one set of ranks,
float32, reduced configs, against the meshless ops and the JAX meshless
engine on the same weights (the reference's `init_model(PRNGKey(0))`
carried over as numpy) and prompts.

* `attention.sharded_mha` equal to `flash_ops.mha` for the three head
  layouts: the rank's query heads on whole GQA groups (H 4 / KV 2), one
  group of replicated KV (H 4 / KV 1), and neither (H 12 / KV 3: every
  query head gathered, attention whole), with the batch over `data`
  (B 4) and not (B 3);
* the column/row-parallel `mlp`, the vocab-parallel `embed` / `unembed`
  (reduced granite: tied, vocab 128 split; reduced qwen: an untied head),
  `self_attention` (wq / wk / wv column-, wo row-parallel) and the serve
  bundle's prefill step over the mesh (`make_bundle(mesh=)`: its specs
  cut the weights; batch 4 over `data`) equal to the meshless ones to
  1e-5;
* the paged engine of reduced granite_3_2b (its 4 / 2 heads split over
  `model`) and reduced smollm (3 / 1 heads: whole on every rank), fp and
  int8 pools: fp tokens equal to the JAX meshless engine's, int8 at
  least `INT8_TOKEN_AGREEMENT` of them, every rank's tokens equal, the
  `data` replicas of each pool bit-equal, each rank's pool 1/tp of the
  meshless pool when its KV heads split, placement gap 0 on every rank;
  granite's chunked-prefill engine (fp, int8: the paged-prefill kernels'
  plain versions under the mesh) against the port's meshless chunked
  engine; reduced granite-moe with a capacity at which nothing drops
  against the port's meshless engine (`moe_ep` in place of `moe_dense`);
* every mesh engine built by `ServingEngine.build(mesh=...)`, the user's
  entry point, with its defaults: the context `ctx_for_mesh(mesh)`, each
  rank's weights the shard of the serving rules' specs; the prompt pass
  of granite's float32 weights on the mesh equal to the meshless one
  (1e-5) in float32, and in bfloat16 no further from the meshless
  bfloat16 pass than that is from float32;
* (1, 1) over one gloo rank: tokens and every pool leaf bit-equal to the
  meshless engine."""

import dataclasses
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.common.parallel import ParallelCtx  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.module import layer_slice  # noqa: E402
from repro_torch.models.module import load_numpy_params  # noqa: E402
from repro_torch.serving.engine import INT8_TOKEN_AGREEMENT  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import dev_serve_torch as dst  # noqa: E402

CTX = ParallelCtx(remat="none")
DP, TP = 2, 2
N_REQ, S, GEN = 4, 8, 6
ENGINE_ARCHS = ("granite_3_2b", "smollm_360m")
POOLS = ("fp", "int8")
TOL = dict(atol=1e-5, rtol=1e-5)
MHA_CASES = {"local": (4, 2), "group": (4, 1), "whole": (12, 3)}


def _cfgs(arch, **over):
    return (dataclasses.replace(jconfigs.reduced(arch), dtype="float32",
                                **over),
            dataclasses.replace(tconfigs.reduced(arch), dtype="float32",
                                **over))


def _weights(jc):
    jp, _ = JM.init_model(jc, jax.random.PRNGKey(0))
    return jp, jax.tree.map(np.asarray, jp)


def _prompts(vocab):
    return np.random.default_rng(1).integers(0, vocab, (N_REQ, S))


def _mha_inputs():
    rng = np.random.default_rng(2)
    out = {}
    for name, (H, KV) in MHA_CASES.items():
        for B in (4, 3):
            q, k, v = (rng.normal(0, 1, (B, S, h, 16)).astype(np.float32)
                       for h in (H, KV, KV))
            out[(name, B)] = dict(kind="mha", q=q, k=k, v=v, causal=True)
    return out


def _layer_case(arch):
    jc, tc = _cfgs(arch)
    _, np_params = _weights(jc)
    rng = np.random.default_rng(3)
    return dict(kind="layers", cfg=tc, params=np_params,
                tokens=rng.integers(0, tc.vocab_size, (4, S)),
                x=rng.normal(0, 1, (4, S, tc.d_model)).astype(np.float32))


ENGINE_RUNS = [dict(pool_dtype=p, name=f"pool {p}") for p in POOLS]
CHUNK_RUNS = [dict(pool_dtype=p, prefill_chunk=S, name=f"chunked {p}")
              for p in POOLS]


@pytest.fixture(scope="module")
def mesh_runs():
    mha = _mha_inputs()
    layer_cases = {a: _layer_case(a) for a in ("granite_3_2b",
                                               "qwen2_5_32b")}
    calls = [(dst.mesh_ops_rank, (DP, TP, list(mha.values())
                                  + list(layer_cases.values()), "cpu"))]
    engines = {}
    for arch in ENGINE_ARCHS:
        jc, tc = _cfgs(arch)
        _, np_params = _weights(jc)
        runs = ENGINE_RUNS
        if arch == "granite_3_2b":
            runs = [dict(ENGINE_RUNS[0], logits=True), *ENGINE_RUNS[1:],
                    *CHUNK_RUNS]
        engines[arch] = (tc, np_params, runs)
        calls.append((dst.mesh_rank, (tc, DP, TP, np_params,
                                      _prompts(tc.vocab_size), GEN, runs,
                                      "cpu")))
    mjc, mtc = _cfgs("granite_moe_1b_a400m", capacity_factor=8.0)
    _, moe_params = _weights(mjc)
    engines["granite_moe_1b_a400m"] = (mtc, moe_params, ENGINE_RUNS[:1])
    calls.append((dst.mesh_rank, (mtc, DP, TP, moe_params,
                                  _prompts(mtc.vocab_size), GEN,
                                  ENGINE_RUNS[:1], "cpu")))
    got = tmesh.run_ranks(dst.mesh_calls, DP * TP, (calls,), device="cpu",
                          threads=1, timeout_s=120, wall_s=600)
    ops = [r[0] for r in got]
    res = {arch: [r[i + 1] for r in got] for i, arch in enumerate(engines)}
    return dict(mha=mha, layer_cases=layer_cases, ops=ops, engines=engines,
                results=res)


@pytest.fixture(scope="module")
def jax_tokens():
    """The JAX meshless engine's tokens for each engine arch and pool."""
    out = {}
    for arch in ENGINE_ARCHS:
        jc, _ = _cfgs(arch)
        jp, _ = _weights(jc)
        prompts = _prompts(jc.vocab_size)
        for pool in POOLS:
            kw = dataclasses.asdict(dst.mesh_ecfg(N_REQ, S, GEN,
                                                  pool_dtype=pool))
            ecfg = JEngineConfig(**{k: v for k, v in kw.items()
                                    if k in JEngineConfig.__dataclass_fields__})
            eng = JServingEngine.build(jc, CTX, ecfg, params=jp)
            reqs = [JRequest(request_id=i, tokens=prompts[i],
                             max_new_tokens=GEN, arrival=0.0)
                    for i in range(N_REQ)]
            eng.run(reqs)
            out[(arch, pool)] = np.stack([np.asarray(r.output)
                                          for r in reqs])
    return out


def _port_engine(cfg, np_params, run):
    from repro_torch.serving import Request, ServingEngine

    run = {k: v for k, v in run.items()
           if k not in ("name", "gate", "logits")}
    ecfg = dst.mesh_ecfg(N_REQ, S, GEN, **run)
    eng = ServingEngine.build(cfg, ecfg, device="cpu",
                              params=load_numpy_params(np_params,
                                                       device="cpu"))
    prompts = _prompts(cfg.vocab_size)
    reqs = [Request(request_id=i, tokens=prompts[i], max_new_tokens=GEN,
                    arrival=0.0) for i in range(N_REQ)]
    eng.run(reqs)
    return np.stack([np.asarray(r.output) for r in reqs]), eng


# ----------------------------------------------------------------- ops
@pytest.mark.parametrize("B", [4, 3])
@pytest.mark.parametrize("layout", list(MHA_CASES))
def test_sharded_mha_equals_mha(mesh_runs, layout, B):
    keys = list(mesh_runs["mha"])
    i = keys.index((layout, B))
    case = mesh_runs["mha"][(layout, B)]
    want = flash_ops.mha(*(torch.from_numpy(case[n]) for n in "qkv"),
                         causal=True).numpy()
    for rank in mesh_runs["ops"]:
        np.testing.assert_allclose(rank[i], want, **TOL)


def test_mha_layouts_are_the_references_branches():
    """The three cases take the reference's three branches at tp 2."""
    from types import SimpleNamespace

    from repro_torch.common.parallel import ParallelCtx as TCtx

    class Mesh(SimpleNamespace):
        def get_local_rank(self, name):
            return 1

    ctx = TCtx(mesh=Mesh(shape={"data": 2, "model": 2}), tp_axis="model")
    got = {name: tattn._groups(H, KV, H // 2, ctx)[0]
           for name, (H, KV) in MHA_CASES.items()}
    assert got == {n: n for n in MHA_CASES}


@pytest.mark.parametrize("op", ["embed", "unembed", "mlp", "attn",
                                "prefill"])
@pytest.mark.parametrize("arch", ["granite_3_2b", "qwen2_5_32b"])
def test_tensor_parallel_layers_equal_meshless(mesh_runs, arch, op):
    case = mesh_runs["layer_cases"][arch]
    cfg = case["cfg"]
    p = load_numpy_params(case["params"], device="cpu")
    p0 = layer_slice(p["blocks"]["pos0"], 0)
    tokens = torch.as_tensor(case["tokens"])
    x = torch.as_tensor(case["x"])
    want = {"embed": lambda: tlayers.embed(p["embed"], tokens, cfg),
            "unembed": lambda: tlayers.unembed(p["embed"], x, cfg,
                                               p.get("head")),
            "mlp": lambda: tlayers.mlp(p0["mlp"], x, cfg),
            "attn": lambda: tattn.self_attention(p0["attn"], x, cfg),
            "prefill": lambda: TM.prefill(p, {"tokens": tokens}, cfg,
                                          max_seq=S)[1]}[op]()
    i = len(mesh_runs["mha"]) + list(mesh_runs["layer_cases"]).index(arch)
    for rank in mesh_runs["ops"]:
        np.testing.assert_allclose(rank[i][op], want.numpy(), **TOL)


# -------------------------------------------------------------- engine
def _results(mesh_runs, arch, name):
    tc, _, runs = mesh_runs["engines"][arch]
    i = [r["name"] for r in runs].index(name)
    return [r[i] for r in mesh_runs["results"][arch]], runs[i]


@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_mesh_engine_against_jax(mesh_runs, jax_tokens, arch, pool):
    per, run = _results(mesh_runs, arch, f"pool {pool}")
    want = jax_tokens[(arch, pool)]
    for r in per:
        np.testing.assert_array_equal(r["tokens"], per[0]["tokens"])
    if pool == "fp":
        np.testing.assert_array_equal(per[0]["tokens"], want)
    else:
        assert dst.compare(per[0]["tokens"], want)["min"] >= \
            INT8_TOKEN_AGREEMENT


GATED = ([(a, r["name"]) for a in ENGINE_ARCHS for r in ENGINE_RUNS]
         + [("granite_3_2b", r["name"]) for r in CHUNK_RUNS]
         + [("granite_moe_1b_a400m", ENGINE_RUNS[0]["name"])])


@pytest.mark.parametrize("arch,name", GATED)
def test_mesh_engine_gates(mesh_runs, arch, name):
    """Against the port's meshless engine on the same config: the lane's
    gates (`dev_serve_torch.mesh_gates`: ranks equal, fp tokens equal,
    int8 agreement, data replicas bit-equal, pool bytes, placement gap
    0), and the rank's pool launched no kernel (the CPU's plain
    versions)."""
    tc, np_params, _ = mesh_runs["engines"][arch]
    per, run = _results(mesh_runs, arch, name)
    tokens, eng = _port_engine(tc, np_params, run)
    failed = dst.mesh_gates([[r] for r in per], {0: tokens},
                            {0: dst.pool_nbytes(eng.caches)}, TP, [run],
                            tc.num_kv_heads % TP == 0)
    assert not failed
    assert all(r["substrate"] == "emulated" for r in per)
    assert all(r["plain"] and not r["launches"] for r in per)


def test_engine_build_over_the_mesh(mesh_runs):
    """The mesh engines come from `ServingEngine.build(..., mesh=mesh)`
    with its defaults: the context `ctx_for_mesh(mesh)` (fsdp over
    `data`, which has 2 ranks), the ranks' coordinates covering the
    mesh, and each rank's weights the shard that the serving rules'
    specs give it (their bytes)."""
    from types import SimpleNamespace

    from repro_torch.common.pytree import tree_leaves
    from repro_torch.runtime import sharding as tshd

    tc, _, _ = mesh_runs["engines"]["granite_3_2b"]
    per, _ = _results(mesh_runs, "granite_3_2b", "pool fp")
    assert all(r["fsdp_axis"] == "data" for r in per)
    assert sorted(r["coord"] for r in per) == [
        (d, m) for d in range(DP) for m in range(TP)]
    stub = SimpleNamespace(shape={"data": DP, "model": TP})
    meta, axes = TM.init_model(tc, device="meta", with_axes=True)
    specs = tshd.pspecs_for_tree(meta, axes, tshd.ShardingRules.for_serving(
        "data", "model"), stub)
    want = sum(int(np.prod(tshd.local_shape(x.shape, sp, stub))) * 4
               for x, sp in zip(tree_leaves(meta), tree_leaves(specs)))
    assert want < sum(x.numel() * 4 for x in tree_leaves(meta))
    assert all(r["param_bytes"] == want for r in per)


def test_mesh_prompt_logits(mesh_runs):
    """The prompt pass on every rank's shard of granite's float32
    weights (`dev_serve_torch.prompt_logits`, the mesh phase's bf16
    gate on the card): float32 equal to the meshless pass to 1e-5;
    bfloat16 no further from the meshless bfloat16 pass than that is
    from the meshless float32 one."""
    tc, np_params, _ = mesh_runs["engines"]["granite_3_2b"]
    per, _ = _results(mesh_runs, "granite_3_2b", "pool fp")
    params = load_numpy_params(np_params, device="cpu")
    prompts = _prompts(tc.vocab_size)
    want = {dt: dst.prompt_logits(tc, params, prompts, dt, "cpu")
            for dt in ("float32", "bfloat16")}
    d_dtype = np.abs(want["bfloat16"] - want["float32"]).max()
    assert d_dtype > 0
    for r in per:
        np.testing.assert_allclose(r["logits"]["float32"], want["float32"],
                                   **TOL)
        assert np.abs(r["logits"]["bfloat16"]
                      - want["bfloat16"]).max() <= d_dtype


def test_one_by_one_mesh_is_bit_equal():
    """(1, 1) over one gloo rank: tokens and every pool leaf bit-equal to
    the meshless engine (no collective runs over a size-1 axis)."""
    jc, tc = _cfgs("granite_3_2b")
    _, np_params = _weights(jc)
    runs = [dict(pool_dtype="int8", name="int8")]
    got = tmesh.run_ranks(dst.mesh_rank, 1,
                          (tc, 1, 1, np_params, _prompts(tc.vocab_size),
                           GEN, runs, "cpu"), device="cpu", threads=1,
                          timeout_s=60, wall_s=300)[0][0]
    tokens, eng = _port_engine(tc, np_params, runs[0])
    np.testing.assert_array_equal(got["tokens"], tokens)
    assert got["digests"] == dst.pool_digests(eng.caches)

"""Speculative decoding on a mesh, on the CPU: 4 gloo ranks spawned once
for the module (`launch.mesh.run_ranks`) as a dp2tp2 mesh (a one-rank
(1, 1) set beside it), float32, reduced smollm (3 / 1 heads: attention
whole on every rank) and granite-3-2b (4 / 2: heads over `model`), 4
requests of 8 prompt tokens and 12 new ones, the paged engine built by
`ServingEngine.build(mesh=)` with its defaults, against the mesh greedy
engine on the same ranks, the port's meshless speculative engine and the
JAX meshless speculative engine on the same weights (the reference's
`init_model(PRNGKey(0))` carried over as numpy; for the draft proposer
the reference engine's draft tree, loaded into every rank's cells).

* ngram (fp) and draft (fp, k 4): every rank's tokens equal; equal to the
  mesh greedy engine's and the JAX speculative engine's; the verify-step
  counts equal the port's meshless and the JAX engine's; the data
  replicas of each pool bit-equal (`dev_serve_torch.mesh_gates`).
* ngram on an int8 pool (speculation switches it to per-token
  sub-scales): agreement at least `INT8_TOKEN_AGREEMENT` with the JAX
  speculative engine's tokens and with the port's meshless one's.
* (1, 1) over one gloo rank: tokens, verify steps and every pool leaf of
  the ngram int8 engine bit-equal to the meshless engine's."""

import dataclasses
import pathlib
import sys
import threading

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
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models.module import cast_params  # noqa: E402
from repro_torch.models.module import load_numpy_params  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from repro_torch.serving.engine import INT8_TOKEN_AGREEMENT  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import dev_serve_torch as dst  # noqa: E402

ARCHS = ("smollm_360m", "granite_3_2b")
DP, TP = 2, 2
N_REQ, S, GEN = 4, 8, 12
SPEC_RUNS = (dict(speculative="ngram", name="ngram fp"),
             dict(speculative="draft", name="draft fp"),
             dict(speculative="ngram", pool_dtype="int8", name="ngram int8"))
GREEDY = dict(name="greedy fp")
ONE_RUN = SPEC_RUNS[2]


def _cfgs(arch):
    return (dataclasses.replace(jconfigs.reduced(arch), dtype="float32"),
            dataclasses.replace(tconfigs.reduced(arch), dtype="float32"))


def _prompts(vocab):
    return np.random.default_rng(5).integers(0, vocab, (N_REQ, S))


def _fields(run):
    return {k: v for k, v in run.items()
            if k not in ("name", "draft_params")}


def _jax_engine(jc, jp, run):
    kw = dataclasses.asdict(dst.mesh_ecfg(N_REQ, S, GEN, **_fields(run)))
    ecfg = JEngineConfig(**{k: v for k, v in kw.items()
                            if k in JEngineConfig.__dataclass_fields__})
    eng = JServingEngine.build(jc, JCtx(remat="none"), ecfg, params=jp)
    prompts = _prompts(jc.vocab_size)
    reqs = [JRequest(request_id=i, tokens=prompts[i], max_new_tokens=GEN,
                     arrival=0.0) for i in range(N_REQ)]
    stats = eng.run(reqs)
    return eng, dict(tokens=np.stack([np.asarray(r.output) for r in reqs]),
                     steps=int(stats.spec.get("verify_steps", 0)))


def _port_engine(tc, np_params, run):
    eng = ServingEngine.build(tc, dst.mesh_ecfg(N_REQ, S, GEN,
                                                **_fields(run)),
                              device="cpu",
                              params=load_numpy_params(np_params,
                                                       device="cpu"))
    if run.get("draft_params") is not None:
        eng.cells.draft_params = cast_params(
            load_numpy_params(run["draft_params"], device="cpu"),
            eng.cells.draft_cfg.dtype)
    prompts = _prompts(tc.vocab_size)
    reqs = [Request(request_id=i, tokens=prompts[i], max_new_tokens=GEN,
                    arrival=0.0) for i in range(N_REQ)]
    eng.run(reqs)
    return dict(tokens=np.stack([np.asarray(r.output) for r in reqs]),
                steps=eng.spec_verify_steps,
                digests=dst.pool_digests(eng.caches),
                pool_bytes=dst.pool_nbytes(eng.caches))


@pytest.fixture(scope="module")
def runs():
    inputs, jax_out = {}, {}
    for arch in ARCHS:
        jc, tc = _cfgs(arch)
        jp, _ = JM.init_model(jc, jax.random.PRNGKey(0))
        np_params = jax.tree.map(np.asarray, jp)
        arch_runs = [GREEDY]
        for run in SPEC_RUNS:
            jeng, jax_out[(arch, run["name"])] = _jax_engine(jc, jp, run)
            if run["speculative"] == "draft":
                run = dict(run, draft_params=jax.tree.map(
                    np.asarray, jeng.cells.draft_params))
            arch_runs.append(run)
        inputs[arch] = (tc, np_params, arch_runs)
    calls = {4: [(dst.mesh_rank, (inputs[a][0], DP, TP, inputs[a][1],
                                  _prompts(inputs[a][0].vocab_size), GEN,
                                  inputs[a][2], "cpu")) for a in ARCHS],
             1: [(dst.mesh_rank, (inputs[a][0], 1, 1, inputs[a][1],
                                  _prompts(inputs[a][0].vocab_size), GEN,
                                  [ONE_RUN], "cpu")) for a in ARCHS]}
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
    meshless = {(a, run["name"]): _port_engine(inputs[a][0], inputs[a][1],
                                               run)
                for a in ARCHS for run in inputs[a][2]}
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    names = [r["name"] for r in inputs[ARCHS[0]][2]]
    return dict(
        inputs=inputs, jax=jax_out, meshless=meshless,
        mesh={(a, n): [r[i][j] for r in got[4]]
              for i, a in enumerate(ARCHS) for j, n in enumerate(names)},
        one={a: got[1][0][i][0] for i, a in enumerate(ARCHS)})


@pytest.mark.parametrize("name", [r["name"] for r in SPEC_RUNS])
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_speculative_tokens(runs, arch, name):
    per = runs["mesh"][(arch, name)]
    want = runs["jax"][(arch, name)]["tokens"]
    for r in per:
        np.testing.assert_array_equal(r["tokens"], per[0]["tokens"])
    if name.endswith("fp"):
        greedy = runs["mesh"][(arch, GREEDY["name"])][0]["tokens"]
        np.testing.assert_array_equal(per[0]["tokens"], greedy)
        np.testing.assert_array_equal(per[0]["tokens"], want)
    else:
        for ref in (want, runs["meshless"][(arch, name)]["tokens"]):
            assert dst.compare(per[0]["tokens"], ref)["min"] >= \
                INT8_TOKEN_AGREEMENT


@pytest.mark.parametrize("name", [r["name"] for r in SPEC_RUNS
                                  if r["name"].endswith("fp")])
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_speculative_verify_steps(runs, arch, name):
    """The verify-step counts of every rank equal the port's meshless
    speculative engine's and the JAX engine's (the draft proposer on the
    reference's draft tree), and speculation took fewer steps than
    tokens."""
    per = runs["mesh"][(arch, name)]
    steps = {r["spec_steps"] for r in per}
    assert steps == {runs["meshless"][(arch, name)]["steps"]}
    assert steps == {runs["jax"][(arch, name)]["steps"]}
    assert 0 < steps.pop() < GEN


@pytest.mark.parametrize("name", [r["name"] for r in (GREEDY, *SPEC_RUNS)])
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_speculative_gates(runs, arch, name):
    """The lane's gates against the port's meshless engine of the same
    run (`dev_serve_torch.mesh_gates`: ranks equal, fp tokens equal, int8
    agreement, the data replicas of each pool bit-equal, pool bytes,
    placement gap 0); the plain versions on every rank."""
    tc, _, arch_runs = runs["inputs"][arch]
    run = next(r for r in arch_runs if r["name"] == name)
    per = runs["mesh"][(arch, name)]
    ref = runs["meshless"][(arch, name)]
    failed = dst.mesh_gates([[r] for r in per], {0: ref["tokens"]},
                            {0: ref["pool_bytes"]}, TP, [run],
                            tc.num_kv_heads % TP == 0)
    assert not failed
    assert all(r["plain"] and not r["launches"] for r in per)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_by_one_speculative_is_bit_equal(runs, arch):
    got = runs["one"][arch]
    ref = runs["meshless"][(arch, ONE_RUN["name"])]
    np.testing.assert_array_equal(got["tokens"], ref["tokens"])
    assert got["spec_steps"] == ref["steps"] > 0
    assert got["digests"] == ref["digests"]

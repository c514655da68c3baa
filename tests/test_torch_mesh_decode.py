"""The contiguous decode over a mesh (sequence-sharded KV caches, the
ranks' blocks merged by their log-sum-exp) against the reference's serve
bundle on a JAX mesh, on the CPU.

* `flash_decode`'s plain version with `return_lse`: the same output as
  without, the log-sum-exp of the scaled logits (float64 witness, 1e-6),
  -1e30 for a row of length 0; `merge_blocks` over r key blocks, some
  empty, equal to the decode over all keys (hypothesis, 1e-6).
* The serve bundle (`runtime.serve.make_bundle(mesh=)`): reduced
  granite-3-2b (4 / 2 heads: the heads split over `model`) and smollm
  (3 / 1: replicated) in float32, 4 prompts of 6 tokens in caches of 16
  positions, then 3 decode steps (positions 6-8: the second `model`
  block is empty at first and takes the third step's write), on meshes
  (2, 2), (1, 2) and (2, 1). The reference's `make_bundle` runs in a
  subprocess with 4 forced JAX host devices (`tests/test_torch_mesh_moe.
  py`'s pattern); the port's ranks run through `launch.mesh.run_ranks`
  over gloo (`dev_serve_torch.mesh_bundle_rank`). Logits within 1e-5 of
  the reference's (relative to their largest), every rank's cache shard
  within 1e-5 of the reference's caches cut by `cache_pspec` (two
  frameworks: not bit for bit). A (1, 1) mesh's bundle is bit-equal to
  the meshless bundle (no collective runs over an axis of size 1).
* The contiguous engine over a mesh (`ServingEngine.build(..., mesh=)`,
  `paged=False`): on dp2tp2 every rank's tokens equal the meshless
  contiguous engine's, each rank holding a quarter of the caches; on a
  (1, 1) mesh tokens and every cache leaf bit-equal to the meshless
  engine's."""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")

import jax  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as dref  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models.module import load_numpy_params  # noqa: E402
from repro_torch.runtime import serve as tserve  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import dev_serve_torch as dst  # noqa: E402

ARCHS = ("granite_3_2b", "smollm_360m")
MESHES = ((2, 2), (1, 2), (2, 1))
B, S0, MAXS, STEPS = 4, 6, 16, 3
N_REQ, S, GEN = 4, 8, 6
ENGINE_RUN = dict(paged=False, pool_dtype="fp", name="contiguous fp")
TOL = 1e-5

REF_CODE = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro import configs
from repro.launch.mesh import ctx_for_mesh
from repro.runtime import serve as serve_rt
from repro.runtime import sharding as shd

d = dict(np.load(sys.argv[1]))
spec = json.loads(sys.argv[2])


def unflat(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = jnp.asarray(v)
    return tree


out = {}
for arch in spec["archs"]:
    cfg = dataclasses.replace(configs.reduced(arch), dtype="float32")
    params = unflat({k.split("|", 1)[1]: v for k, v in d.items()
                     if k.startswith(arch + "|")})
    prompts = jnp.asarray(d[arch + ":prompts"])
    steps = d[arch + ":steps"]
    S0 = prompts.shape[1]
    for dp, tp in spec["meshes"]:
        mesh = jax.make_mesh((dp, tp), ("data", "model"),
                             (jax.sharding.AxisType.Auto,) * 2,
                             devices=jax.devices()[:dp * tp])
        ctx = ctx_for_mesh(mesh, remat="none")
        rules = shd.ShardingRules.for_serving(data_axis=ctx.fsdp_axis,
                                              tp_axis=ctx.tp_axis)
        sb = serve_rt.make_bundle(cfg, ctx, rules, mesh,
                                  batch=prompts.shape[0],
                                  max_seq=spec["max_seq"])
        for k, v in sb.param_shardings.items():   # empty subtrees
            params.setdefault(k, v if v == {} else params.get(k))
        p = jax.device_put(params, sb.param_shardings)
        caches, logits = sb.prefill_fn(p, {"tokens": prompts})
        caches = jax.device_put(caches, sb.cache_shardings)
        key = f"{arch}:{dp}x{tp}"
        out[key + ":logits0"] = np.asarray(logits)
        for i, tok in enumerate(steps):
            logits, caches = sb.decode_fn(p, jnp.asarray(tok), caches,
                                          jnp.int32(S0 + i))
            out[key + f":logits{i + 1}"] = np.asarray(logits)
        for pos, c in caches.items():
            for name, x in c.items():
                out[key + f":{pos}/{name}"] = np.asarray(x)
np.savez(sys.argv[3], **out)
print("REF_OK")
"""


def _cfgs(arch):
    return (dataclasses.replace(jconfigs.reduced(arch), dtype="float32"),
            dataclasses.replace(tconfigs.reduced(arch), dtype="float32"))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _shard(x, dp: int, tp: int, coord) -> np.ndarray:
    """The (data, model) rank's block of a global (nb, B, S, KV, hd)
    cache leaf under `cache_pspec`: rows over data, positions over
    model (both divide here)."""
    d, m = coord
    nB, nS = x.shape[1] // dp, x.shape[2] // tp
    return x[:, d * nB:(d + 1) * nB, m * nS:(m + 1) * nS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_decode")
    rng = np.random.default_rng(0)
    inputs, flat = {}, {}
    for arch in ARCHS:
        jc, tc = _cfgs(arch)
        jp, _ = JM.init_model(jc, jax.random.PRNGKey(0))
        params = jax.tree.map(np.asarray, jp)
        prompts = rng.integers(0, tc.vocab_size, (B, S0))
        steps = rng.integers(0, tc.vocab_size, (STEPS, B))
        inputs[arch] = (tc, params, prompts, steps)
        flat.update({f"{arch}|{k}": v for k, v in _flat(params).items()})
        flat[f"{arch}:prompts"], flat[f"{arch}:steps"] = prompts, steps
    np.savez(tmp / "in.npz", **flat)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                          " --xla_force_host_platform_device_count=4"))
    spec = dict(archs=ARCHS, meshes=MESHES, max_seq=MAXS)
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_CODE, str(tmp / "in.npz"),
         json.dumps(spec), str(tmp / "ref.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def bundle(arch, dp, tp):
        tc, params, prompts, steps = inputs[arch]
        return (dst.mesh_bundle_rank,
                (tc, dp, tp, params, prompts, steps, MAXS, "cpu"))

    # the engines serve granite; its weights go to the ranks as numpy
    tc, params, _, _ = inputs["granite_3_2b"]
    prompts = np.random.default_rng(1).integers(0, tc.vocab_size, (N_REQ, S))

    def engine(dp, tp):
        return (dst.mesh_rank, (tc, dp, tp, params, prompts, GEN,
                                [ENGINE_RUN], "cpu"))

    # (key, (fn, args)) per world: the (1, 2) and (2, 1) meshes share the
    # two ranks, each mesh built over their process group in turn
    calls = {4: [((a, 2, 2), bundle(a, 2, 2)) for a in ARCHS]
             + [(("engine", 2, 2), engine(2, 2))],
             2: [((a, *m), bundle(a, *m)) for m in ((1, 2), (2, 1))
                 for a in ARCHS],
             1: [((a, 1, 1), bundle(a, 1, 1)) for a in ARCHS]
             + [(("engine", 1, 1), engine(1, 1))]}
    got, errors = {}, []

    def spawn(world):
        try:
            got[world] = tmesh.run_ranks(
                dst.mesh_calls, world, ([c for _, c in calls[world]],),
                device="cpu",
                threads=1, timeout_s=120, wall_s=400)
        except BaseException as e:      # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=spawn, args=(w,)) for w in calls]
    for t in threads:
        t.start()
    # the meshless port: the bundle of each arch and the contiguous engine
    meshless = {}
    for arch in ARCHS:
        tc_a, params_a, prompts_a, steps_a = inputs[arch]
        sb = tserve.make_bundle(tc_a, batch=B, max_seq=MAXS)
        p = load_numpy_params(params_a, device="cpu")
        caches, logits = sb.prefill_fn(p, {"tokens": torch.as_tensor(
            prompts_a)})
        out = [logits]
        for i, tok in enumerate(steps_a):
            logits, caches = sb.decode_fn(p, torch.as_tensor(tok), caches,
                                          S0 + i)
            out.append(logits)
        meshless[arch] = dict(
            logits=[x.numpy() for x in out],
            caches={f"{pos}/{k}": x.numpy() for pos, c in caches.items()
                    for k, x in c.items()})
    eng = ServingEngine.build(tc, dst.mesh_ecfg(N_REQ, S, GEN, paged=False),
                              params=load_numpy_params(params,
                                                       device="cpu"),
                              device="cpu")
    reqs = [Request(request_id=i, tokens=prompts[i], max_new_tokens=GEN,
                    arrival=0.0) for i in range(N_REQ)]
    eng.run(reqs)
    meshless["engine"] = dict(
        tokens=np.stack([np.asarray(r.output) for r in reqs]),
        digests=dst.pool_digests(eng.caches),
        pool_bytes=dst.pool_nbytes(eng.caches))
    for t in threads:
        t.join()
    out, err = ref.communicate(timeout=400)
    if errors:
        raise errors[0]
    assert ref.returncode == 0 and "REF_OK" in out, err[-3000:]
    jref = dict(np.load(tmp / "ref.npz"))
    port = {}
    for world, cs in calls.items():
        for i, (key, _) in enumerate(cs):
            # mesh_rank returns one result per run: the engine's is [0]
            port[key] = [r[i][0] if key[0] == "engine" else r[i]
                         for r in got[world]]
    return jref, port, meshless


def _bundle_cases():
    return [(a, m) for a in ARCHS for m in MESHES]


@pytest.mark.parametrize("arch,mesh", _bundle_cases(),
                         ids=[f"{a}-{m[0]}x{m[1]}" for a, m in
                              _bundle_cases()])
def test_bundle_logits_match_reference(runs, arch, mesh):
    jref, port, _ = runs
    ranks = port[(arch, *mesh)]
    key = f"{arch}:{mesh[0]}x{mesh[1]}"
    for step in range(STEPS + 1):
        want = jref[f"{key}:logits{step}"]
        for r in ranks:
            np.testing.assert_array_equal(r["logits"][step],
                                          ranks[0]["logits"][step])
        assert _rel(ranks[0]["logits"][step], want) <= TOL, (step, _rel(
            ranks[0]["logits"][step], want))


@pytest.mark.parametrize("arch,mesh", _bundle_cases(),
                         ids=[f"{a}-{m[0]}x{m[1]}" for a, m in
                              _bundle_cases()])
def test_bundle_cache_shards_match_reference(runs, arch, mesh):
    jref, port, _ = runs
    dp, tp = mesh
    key = f"{arch}:{dp}x{tp}"
    for r in port[(arch, dp, tp)]:
        assert r["plain"].get("decode_mha", 0) > 0      # the decode ran
        for leaf, x in r["caches"].items():
            want = _shard(jref[f"{key}:{leaf}"], dp, tp, r["coord"])
            assert x.shape == want.shape, (leaf, x.shape, want.shape)
            np.testing.assert_allclose(x, want, atol=TOL, rtol=TOL,
                                       err_msg=f"{leaf} {r['coord']}")


@pytest.mark.parametrize("arch", ARCHS)
def test_bundle_one_by_one_bit_equal_to_meshless(runs, arch):
    _, port, meshless = runs
    (r,) = port[(arch, 1, 1)]
    for got, want in zip(r["logits"], meshless[arch]["logits"]):
        np.testing.assert_array_equal(got, want)
    assert r["caches"].keys() == meshless[arch]["caches"].keys()
    for leaf, x in r["caches"].items():
        np.testing.assert_array_equal(x, meshless[arch]["caches"][leaf])


def test_contiguous_engine_dp2tp2_equals_meshless(runs):
    _, port, meshless = runs
    per = port[("engine", 2, 2)]
    ref = meshless["engine"]
    assert dst.mesh_gates([[p] for p in per], {0: ref["tokens"]},
                          {0: ref["pool_bytes"]}, 2, [ENGINE_RUN],
                          True) == []
    # slots over data, positions over model: the four shards differ
    assert len({tuple(sorted(p["digests"].values())) for p in per}) == 4
    assert {p["coord"] for p in per} == {(0, 0), (0, 1), (1, 0), (1, 1)}


def test_contiguous_engine_one_by_one_bit_equal(runs):
    _, port, meshless = runs
    (one,) = port[("engine", 1, 1)]
    np.testing.assert_array_equal(one["tokens"], meshless["engine"]["tokens"])
    assert one["digests"] == meshless["engine"]["digests"]
    assert one["pool_bytes"] == meshless["engine"]["pool_bytes"]


# ------------------------------------------------- the lse and the merge
def _decode_inputs(seed, Bq, H, KV, Sk, D, lengths):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(Bq, H, D, generator=g)
    k = torch.randn(Bq, Sk, KV, D, generator=g)
    v = torch.randn(Bq, Sk, KV, D, generator=g)
    return q, k, v, torch.tensor(lengths, dtype=torch.int32)


def test_plain_decode_lse():
    q, k, v, lengths = _decode_inputs(0, 4, 6, 2, 20, 8, [1, 7, 0, 25])
    out, lse = dops.decode_mha(q, k, v, lengths, return_lse=True)
    torch.testing.assert_close(out, dops.decode_mha(q, k, v, lengths),
                               rtol=0, atol=0)
    qg = q.double().reshape(4, 2, 3, 8)
    logits = torch.einsum("bgrd,bsgd->bgrs", qg, k.double()) * 8 ** -0.5
    for b, n in enumerate(lengths.tolist()):
        n = min(n, 20)
        if n == 0:
            assert torch.all(lse[b] == dref.NEG_INF)
            continue
        want = torch.logsumexp(logits[b, ..., :n], -1).reshape(6)
        torch.testing.assert_close(lse[b].double(), want, rtol=1e-6,
                                   atol=1e-6)


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 2 ** 16), st.integers(1, 4), st.integers(1, 3),
       st.integers(1, 12), st.lists(st.integers(0, 40), min_size=2,
                                    max_size=2))
def test_merge_of_key_blocks_equals_whole_decode(seed, r, rep, S_loc, lens):
    """Keys split into r blocks of S_loc positions (rank j holds
    [j S_loc, (j + 1) S_loc)), each decoded with its clamped length and
    its lse: the merge equals the decode over every key (1e-6), blocks
    past a row's length (empty) included."""
    KV, D = 2, 8
    S = r * S_loc
    lens = [max(1, n % (S + 2)) for n in lens]        # row >= 1 key
    q, k, v, lengths = _decode_inputs(seed, 2, KV * rep, KV, S, D, lens)
    whole = dops.decode_mha(q, k, v, lengths)
    outs, lses = [], []
    for j in range(r):
        blk = slice(j * S_loc, (j + 1) * S_loc)
        n = (lengths - j * S_loc).clamp(0, S_loc)
        o, lse = dops.decode_mha(q, k[:, blk].contiguous(),
                                 v[:, blk].contiguous(), n, return_lse=True)
        outs.append(o)
        lses.append(lse)
    merged = dops.merge_blocks(torch.stack(outs), torch.stack(lses))
    torch.testing.assert_close(merged, whole, rtol=1e-6, atol=1e-6)

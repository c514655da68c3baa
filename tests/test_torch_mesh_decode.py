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
  (2, 2), (1, 2) and (2, 1). On (2, 2) and (1, 2), extents that do not
  divide over `model` (kept whole, every rank decoding its own heads
  with no merge): granite in caches of 15; reduced seamless with an
  encoder extent of 9 beside caches of 16 and of 8 beside caches of 15
  (per leaf: a whole cross-KV beside a split self-KV, and the reverse);
  and an SSM head cut across the two `model` ranks (mamba2 with
  d_model 48 and heads of 32, 1.5 a rank; jamba with heads of 128, half
  a rank, on (1, 2) only: on (2, 2) the reference's MoE sums other data
  ranks' tokens, ROADMAP §C), whose state comes back whole. The reference's `make_bundle` runs in a
  subprocess with 4 forced JAX host devices (`tests/test_torch_mesh_moe.
  py`'s pattern); the port's ranks run through `launch.mesh.run_ranks`
  over gloo (`dev_serve_torch.mesh_bundle_rank`). Logits within 1e-5 of
  the reference's (relative to their largest), every rank's cache shard
  within 1e-5 of the reference's caches cut by `cache_pspec` (two
  frameworks: not bit for bit). A (1, 1) mesh's bundle is bit-equal to
  the meshless bundle (no collective runs over an axis of size 1).
* The contiguous engine over a mesh (`ServingEngine.build(..., mesh=)`,
  `paged=False`): on dp2tp2 every rank's tokens equal the meshless
  contiguous engine's, each rank holding a quarter of the caches (half
  of them in caches of 15 positions, whole over `model`); on a (1, 1)
  mesh tokens and every cache leaf bit-equal to the meshless engine's."""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import threading
from types import SimpleNamespace

import numpy as np
import torch
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
from repro_torch.runtime import sharding as tshd  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import dev_serve_torch as dst  # noqa: E402

MESHES = ((2, 2), (1, 2), (2, 1))
B, S0, MAXS, STEPS = 4, 6, 16, 3
# name: (arch, config overrides, cache extent, encoder extent, meshes)
CASES = {
    "granite_3_2b": ("granite_3_2b", {}, MAXS, 0, MESHES),
    "smollm_360m": ("smollm_360m", {}, MAXS, 0, MESHES),
    "granite_odd": ("granite_3_2b", {}, 15, 0, MESHES[:2]),
    "seamless_cross_whole": ("seamless_m4t_large_v2", {}, MAXS, 9,
                             MESHES[:2]),
    "seamless_self_whole": ("seamless_m4t_large_v2", {}, 15, 8, MESHES[:2]),
    "mamba2_cut": ("mamba2_780m", dict(d_model=48, ssm_head_dim=32), MAXS,
                   0, MESHES[:2]),
    # (1, 2) only: on (2, 2) the reference's default "rowcol" MoE
    # schedule sums other data ranks' tokens (ROADMAP §C)
    "jamba_cut": ("jamba_1_5_large_398b",
                  dict(ssm_head_dim=128, capacity_factor=8.0), MAXS, 0,
                  MESHES[1:2]),
}
N_REQ, S, GEN = 4, 8, 6
ENGINE_RUN = dict(paged=False, pool_dtype="fp", name="contiguous fp")
# caches of 15 positions: whole over model
ODD_RUN = dict(ENGINE_RUN, max_seq=15, name="contiguous fp 15",
               whole=("k", "v"))
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
for name, (arch, over, max_seq, enc, meshes) in spec["cases"].items():
    cfg = dataclasses.replace(configs.reduced(arch), dtype="float32", **over)
    params = unflat({k.split("|", 1)[1]: v for k, v in d.items()
                     if k.startswith(name + "|")})
    prompts = jnp.asarray(d[name + ":prompts"])
    batch = {"tokens": prompts}
    if enc:
        batch["frames"] = jnp.asarray(d[name + ":frames"])
    steps = d[name + ":steps"]
    S0 = prompts.shape[1]
    for dp, tp in meshes:
        mesh = jax.make_mesh((dp, tp), ("data", "model"),
                             (jax.sharding.AxisType.Auto,) * 2,
                             devices=jax.devices()[:dp * tp])
        ctx = ctx_for_mesh(mesh, remat="none")
        rules = shd.ShardingRules.for_serving(data_axis=ctx.fsdp_axis,
                                              tp_axis=ctx.tp_axis)
        sb = serve_rt.make_bundle(cfg, ctx, rules, mesh,
                                  batch=prompts.shape[0], max_seq=max_seq,
                                  enc_len=enc)
        for k, v in sb.param_shardings.items():   # empty subtrees
            params.setdefault(k, v if v == {} else params.get(k))
        p = jax.device_put(params, sb.param_shardings)
        caches, logits = sb.prefill_fn(p, batch)
        caches = jax.device_put(caches, sb.cache_shardings)
        key = f"{name}:{dp}x{tp}"
        out[key + ":logits0"] = np.asarray(logits)
        for i, tok in enumerate(steps):
            logits, caches = sb.decode_fn(p, jnp.asarray(tok), caches,
                                          jnp.int32(S0 + i))
            out[key + f":logits{i + 1}"] = np.asarray(logits)
        for pos, c in caches.items():
            for leaf, x in c.items():
                out[key + f":{pos}/{leaf}"] = np.asarray(x)
np.savez(sys.argv[3], **out)
print("REF_OK")
"""


def _cfgs(name):
    arch, over = CASES[name][:2]
    return (dataclasses.replace(jconfigs.reduced(arch), dtype="float32",
                                **over),
            dataclasses.replace(tconfigs.reduced(arch), dtype="float32",
                                **over))


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


def _shard(x, leaf: str, dp: int, tp: int, coord) -> np.ndarray:
    """The (data, model) rank's block of a global cache leaf ("pos0/k")
    under `cache_pspec` (rows over data; positions, SSM heads or tail
    channels over model where they divide)."""
    pos, name = leaf.split("/")
    mesh = SimpleNamespace(shape={"data": dp, "model": tp})
    spec = tshd.cache_pspec({pos: {name: x}}, ("data",), "model",
                            mesh)[pos][name]
    index = {"data": coord[0], "model": coord[1]}
    for dim, entry in enumerate(spec):
        if entry is not None:
            n = x.shape[dim] // mesh.shape[entry]
            x = np.take(x, range(index[entry] * n, (index[entry] + 1) * n),
                        axis=dim)
    return x


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_decode")
    rng = np.random.default_rng(0)
    inputs, flat = {}, {}
    for name, (_, _, _, enc, _) in CASES.items():
        jc, tc = _cfgs(name)
        jp, _ = JM.init_model(jc, jax.random.PRNGKey(0))
        params = jax.tree.map(np.asarray, jp)
        prompts = rng.integers(0, tc.vocab_size, (B, S0))
        steps = rng.integers(0, tc.vocab_size, (STEPS, B))
        frames = (rng.normal(0, 1, (B, enc, tc.d_model)).astype(np.float32)
                  if enc else None)
        inputs[name] = (tc, params, prompts, steps, frames)
        flat.update({f"{name}|{k}": v for k, v in _flat(params).items()})
        flat[f"{name}:prompts"], flat[f"{name}:steps"] = prompts, steps
        if enc:
            flat[f"{name}:frames"] = frames
    np.savez(tmp / "in.npz", **flat)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                          " --xla_force_host_platform_device_count=4"))
    spec = dict(cases=CASES)
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_CODE, str(tmp / "in.npz"),
         json.dumps(spec), str(tmp / "ref.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def bundle(name, dp, tp):
        tc, params, prompts, steps, frames = inputs[name]
        return (dst.mesh_bundle_rank,
                (tc, dp, tp, params, prompts, steps, CASES[name][2], "cpu",
                 frames))

    # the engines serve granite; its weights go to the ranks as numpy
    tc, params, _, _, _ = inputs["granite_3_2b"]
    prompts = np.random.default_rng(1).integers(0, tc.vocab_size, (N_REQ, S))

    def engine(dp, tp, runs):
        return (dst.mesh_rank, (tc, dp, tp, params, prompts, GEN, runs,
                                "cpu"))

    def cases(mesh):
        return [n for n, c in CASES.items() if mesh in c[4]]

    # (key, (fn, args)) per world: the (1, 2) and (2, 1) meshes share the
    # two ranks, each mesh built over their process group in turn
    calls = {4: [((n, 2, 2), bundle(n, 2, 2)) for n in cases((2, 2))]
             + [(("engine", 2, 2), engine(2, 2, [ENGINE_RUN, ODD_RUN]))],
             2: [((n, *m), bundle(n, *m)) for m in ((1, 2), (2, 1))
                 for n in cases(m)],
             1: [((a, 1, 1), bundle(a, 1, 1))
                 for a in ("granite_3_2b", "smollm_360m")]
             + [(("engine", 1, 1), engine(1, 1, [ENGINE_RUN]))]}
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
    for arch in ("granite_3_2b", "smollm_360m"):
        tc_a, params_a, prompts_a, steps_a, _ = inputs[arch]
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
    for run in (ENGINE_RUN, ODD_RUN):
        eng = ServingEngine.build(
            tc, dst.mesh_ecfg(N_REQ, S, GEN, paged=False,
                              max_seq=run.get("max_seq", S + GEN)),
            params=load_numpy_params(params, device="cpu"), device="cpu")
        reqs = [Request(request_id=i, tokens=prompts[i], max_new_tokens=GEN,
                        arrival=0.0) for i in range(N_REQ)]
        eng.run(reqs)
        meshless[run["name"]] = dict(
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
            port[key] = [r[i] for r in got[world]]
    return jref, port, meshless


def _bundle_cases():
    return [(n, m) for n, c in CASES.items() for m in c[4]]


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
        if CASES[arch][0] != "mamba2_780m":
            assert r["plain"].get("decode_mha", 0) > 0  # the decode ran
        for leaf, x in r["caches"].items():
            want = _shard(jref[f"{key}:{leaf}"], leaf, dp, tp, r["coord"])
            assert x.shape == want.shape, (leaf, x.shape, want.shape)
            np.testing.assert_allclose(x, want, atol=TOL, rtol=TOL,
                                       err_msg=f"{leaf} {r['coord']}")


@pytest.mark.parametrize("arch", ["granite_3_2b", "smollm_360m"])
def test_bundle_one_by_one_bit_equal_to_meshless(runs, arch):
    _, port, meshless = runs
    (r,) = port[(arch, 1, 1)]
    for got, want in zip(r["logits"], meshless[arch]["logits"]):
        np.testing.assert_array_equal(got, want)
    assert r["caches"].keys() == meshless[arch]["caches"].keys()
    for leaf, x in r["caches"].items():
        np.testing.assert_array_equal(x, meshless[arch]["caches"][leaf])


@pytest.mark.parametrize("i,run", enumerate((ENGINE_RUN, ODD_RUN)),
                         ids=[ENGINE_RUN["name"], ODD_RUN["name"]])
def test_contiguous_engine_dp2tp2_equals_meshless(runs, i, run):
    """dp2tp2 tokens equal the meshless contiguous engine's, each rank
    its specs' share of the caches: a quarter in caches of 14 positions
    (slots over data, positions over model: the four shards differ),
    half in caches of 15 (whole over model: the two model ranks of a
    data row hold the same caches, and no rank merges an lse)."""
    _, port, meshless = runs
    per = [p[i] for p in port[("engine", 2, 2)]]
    ref = meshless[run["name"]]
    assert dst.mesh_gates([[p] for p in per], {0: ref["tokens"]},
                          {0: ref["pool_bytes"]}, 2, [run], True) == []
    assert {p["coord"] for p in per} == {(0, 0), (0, 1), (1, 0), (1, 1)}
    digests = {p["coord"]: tuple(sorted(p["digests"].values()))
               for p in per}
    if run is ENGINE_RUN:
        assert len(set(digests.values())) == 4
        assert all(4 * p["pool_bytes"] == ref["pool_bytes"] for p in per)
    else:
        assert all(digests[(d, 0)] == digests[(d, 1)] for d in range(2))
        assert all(2 * p["pool_bytes"] == ref["pool_bytes"] for p in per)
        assert not any(p["launches"] or "decode_mha" not in p["plain"]
                       for p in per)


def test_contiguous_engine_one_by_one_bit_equal(runs):
    _, port, meshless = runs
    (one,) = port[("engine", 1, 1)][0]
    ref = meshless[ENGINE_RUN["name"]]
    np.testing.assert_array_equal(one["tokens"], ref["tokens"])
    assert one["digests"] == ref["digests"]
    assert one["pool_bytes"] == ref["pool_bytes"]


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


def test_contiguous_mesh_decode_needs_seq_split():
    """Over a tp axis of 2 the contiguous decode and insert raise without
    `seq_split` (a sequence-split cache read as whole would decode
    wrong), and take it given; `prefill_cache_shards` takes the
    decision from it, not from the extent."""
    from repro_torch.models import blocks as tblocks

    ctx = tmesh.ctx_for_mesh(tmesh.AbstractMesh((1, 2), ("data", "model")),
                             remat="none")
    cfg = tconfigs.reduced("granite_3_2b")
    with pytest.raises(ValueError, match="seq_split"):
        tserve.build_cache_insert(ctx, 4)
    with pytest.raises(ValueError, match="seq_split"):
        tblocks.stack_decode(None, None, None, 0, cfg, None, 0, ctx=ctx)
    assert tserve.build_cache_insert(ctx, 4, {"k": False, "v": False})
    leaf = torch.arange(2 * 4 * 16 * cfg.num_kv_heads * 2,
                        dtype=torch.float32).reshape(
        2, 4, 16, cfg.num_kv_heads, 2)
    for split, extent in ((True, 8), (False, 16)):
        got = tserve.prefill_cache_shards(
            {"pos0": {"k": leaf}}, ctx, cfg.num_kv_heads,
            {"k": split})["pos0"]["k"]
        assert got.shape[2] == extent

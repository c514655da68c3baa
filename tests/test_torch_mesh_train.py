"""Training on a mesh (`runtime.train.make_bundle(mesh=)`: FSDP over
`data`, TP over `model`, the reference's training rules), on the CPU: 4
gloo ranks spawned once for the module as a dp2tp2 mesh
(`dev_train_torch.mesh_train_rank` through `dev_serve_torch.mesh_calls`),
float32, on the reference's `init_model(PRNGKey(0))` weights and
`make_batch_for` batches carried over as numpy (B 4, S 16).

Archs (reduced): granite_3_2b (4 / 2 heads: whole GQA groups over
`model`, tied vocab 128 split), smollm_360m (3 / 1 heads and d 60:
attention replicated over `model`, FSDP on an odd head count's
projections), qwen2_5_32b (an untied head, qkv biases),
granite_moe_1b_a400m (`moe_ep`, capacity 8.0 so nothing drops), and
granite with its heads changed to 4 / 1 (the `group` layout: KV
replicated, one group a rank) and 12 / 3 (`whole`: every query head
gathered); and the other stacks: mamba2_780m (the SSM block on the
rank's 4 of 8 heads), jamba_1_5_large_398b (SSM, attention and
`moe_ep` layers, capacity 8.0), paligemma_3b (the vision prefix: the
rank's rows of `patches`; 4 / 1 heads, the `group` layout) and
seamless_m4t_large_v2 (the encoder over the rank's rows of `frames`,
cross-attention in every decoder layer); and an SSM head cut across the
two `model` ranks (the rank's block of `d_inner` run as virtual heads):
mamba2 with d_model 48 and heads of 32 (3 heads, 1.5 a rank) and jamba
with heads of 128 (1 head, half a rank).

* One step's gradients of every leaf (gathered whole with
  `unshard_tree`) within 1e-5 of the leaf's largest magnitude of JAX's
  meshless `value_and_grad` (with two microbatches: the mean of the two
  halves' grads, as the reference's step accumulates them), the loss,
  nll, z_loss, moe_aux and accuracy within 1e-5 relative and the grad
  norm within 1e-5 relative, for microbatches 1 and 2 and remat none
  and block.
* After that step (microbatches 1, remat none) the AdamW moments against
  the reference's meshless step (1e-5 of their largest magnitude) and
  each parameter's update within 1e-2 lr of the reference's on 99.9% of
  its elements and 2.2 lr everywhere (Adam's first step is about lr *
  sign(g), so an element whose gradient is within rounding of 0 can
  flip; the count of such elements is printed).
* Three steps against the reference's own sharded step on a JAX (2, 2)
  mesh in a subprocess with 4 forced host devices: the losses and grad
  norms within 1e-5 relative, the moments within 1e-4 of their largest
  magnitude, the params as above with the three steps' lr summed. For
  the MoE archs the reference runs `moe_fsdp_mode="gather"`: its default
  "rowcol" sums other data ranks' tokens (ROADMAP §C). Its state is laid
  out again by its shardings after every step (an SSM stack's step
  returns its per-head leaves split otherwise than its in_shardings,
  which jit then refuses).
* `ssm_block` alone on the same ranks (`dev_train_torch.ssm_grad_rank`,
  one layer of reduced mamba2 with perturbed per-head leaves): y and
  the gradients of every weight and of x within 1e-5 of their largest
  magnitude of `jax.vjp` of the reference's meshless block, over dp1tp2
  (`data`'s two ranks replicas of one tp2 group) and over dp2tp2 with
  FSDP, and over dp2tp2 with FSDP on the mamba2 head cut.
* `moe_ep` with grad whose sequence does not split over the EP axis (x
  (2, 3, d), S 3 on `model`'s 2 ranks: every rank routes every token) on
  the same ranks (`dev_train_torch.moe_grad_rank`, reduced granite-moe
  at capacity 8.0): y, aux and the gradients of x and of every weight
  within 1e-5 of their largest magnitude of `moe_dense`'s and of
  `jax.grad` of the reference's `moe_ep` on its (2, 2) mesh.
* After every run the replicas of every leaf bit-equal across the ranks
  and each rank's state bytes equal to its share under `state_pspecs`.
* granite's three steps also run the tiered step (`runtime.tiering`,
  hotness, pool_fraction 0.5) from each state: bit-equal to the untiered
  step on every rank.
* granite and qwen in bf16: each rank's forward (the global batch's
  per-token NLL) bit-equal to the meshless bf16 forward with the
  row-parallel products split as dp2tp2 splits them.

In this process: the training rules' specs (granite-moe's expert
weights: w_gate / w_up split on their embed dim over `data`, w_down on
its ff dim, the first of its dims to ask) against the reference's; the
tiering's `shard_counts` and `per_device_profile` against the
reference's with a stand-in (2, 2) mesh; the train launcher through the
(1, 1) smoke mesh (granite and mamba2) bit-equal to the meshless bundle,
its process group gone afterwards."""

import concurrent.futures
import dataclasses
import functools
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.common.config import ShapeConfig as JShapeConfig  # noqa: E402
from repro.common.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.common.parallel import ParallelCtx  # noqa: E402
from repro.common.pytree import named_leaves as jnamed  # noqa: E402
from repro.data.synthetic import make_batch_for as jbatch  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.runtime import sharding as jshd  # noqa: E402
from repro.runtime import tiering as jtiering  # noqa: E402
from repro.runtime import train as jtrain  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.common.config import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.common.pytree import named_leaves as tnamed  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.runtime import sharding as tshd  # noqa: E402
from repro_torch.runtime import tiering as ttiering  # noqa: E402
from repro_torch.runtime import train as ttrain  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import dev_serve_torch as dst  # noqa: E402
import dev_train_torch as dtt  # noqa: E402

DP, TP = 2, 2
B, S, STEPS = 4, 16, 3
TCFG = dict(total_steps=10, warmup_steps=2)
ARCHS = {
    "granite_3_2b": dict(arch="granite_3_2b"),
    "smollm_360m": dict(arch="smollm_360m"),
    "qwen2_5_32b": dict(arch="qwen2_5_32b"),
    "granite_moe_1b_a400m": dict(arch="granite_moe_1b_a400m",
                                 capacity_factor=8.0),
    "granite_group": dict(arch="granite_3_2b", num_heads=4,
                          num_kv_heads=1),
    "granite_whole": dict(arch="granite_3_2b", num_heads=12,
                          num_kv_heads=3),
    "mamba2_780m": dict(arch="mamba2_780m"),
    "jamba_1_5_large_398b": dict(arch="jamba_1_5_large_398b",
                                 capacity_factor=8.0),
    "paligemma_3b": dict(arch="paligemma_3b"),
    "seamless_m4t_large_v2": dict(arch="seamless_m4t_large_v2"),
    # an SSM head cut across the two model ranks
    "mamba2_cut": dict(arch="mamba2_780m", d_model=48, ssm_head_dim=32),
    "jamba_cut": dict(arch="jamba_1_5_large_398b", capacity_factor=8.0,
                      ssm_head_dim=128),
}
CUT = ("mamba2_cut", "jamba_cut")
STEPPED = ("granite_3_2b", "smollm_360m", "qwen2_5_32b",
           "granite_moe_1b_a400m", "mamba2_780m", "jamba_1_5_large_398b",
           "paligemma_3b", "seamless_m4t_large_v2", *CUT)
# ssm_block alone: (arch, fsdp) of each case
SSM_CASES = {"dp1tp2": ("mamba2_780m", False),
             "dp2tp2 fsdp": ("mamba2_780m", True),
             "dp2tp2 fsdp head cut": ("mamba2_cut", True)}
# moe_ep with grad, S % ep != 0: x and its cotangent (B, S, d)
MOE_SHAPE = (2, 3)
GRAD_RUNS = [(mb, remat) for mb in (1, 2) for remat in ("none", "block")]
HEAD_RUNS = [(1, "none")]
TIERED = "granite_3_2b"
BF16 = ("granite_3_2b", "qwen2_5_32b")


def _cfgs(name):
    over = dict(ARCHS[name])
    arch = over.pop("arch")
    return (dataclasses.replace(jconfigs.reduced(arch), dtype="float32",
                                **over),
            dataclasses.replace(tconfigs.reduced(arch), dtype="float32",
                                **over))


def _grad_runs(name):
    return GRAD_RUNS if name in STEPPED and name not in CUT else HEAD_RUNS


def _runs(name):
    runs = [dict(name=f"grads mb{mb} {remat}", steps=1, grads=True,
                 state=(mb, remat) == (1, "none"),
                 tcfg=dict(TCFG, microbatches=mb, remat=remat))
            for mb, remat in _grad_runs(name)]
    if name in STEPPED:
        run = dict(name="three steps", steps=STEPS, state=True,
                   tcfg=dict(TCFG, remat="block"))
        if name == TIERED:
            run["tier"] = dict(policy="hotness", pool_fraction=0.5)
        runs.append(run)
    if name in BF16:
        runs.append(dict(name="bf16", dtype="bfloat16", steps=1,
                         token_nll=True, tcfg=dict(TCFG)))
    return runs


@functools.lru_cache(maxsize=None)
def _inputs(name):
    jc, _ = _cfgs(name)
    jp = jax.jit(lambda key: JM.init_model(jc, key)[0])(
        jax.random.PRNGKey(0))
    batches = [jax.tree.map(np.asarray, jbatch(jc, S, B, s))
               for s in range(STEPS)]
    return jax.tree.map(np.asarray, jp), batches


def _jax_grads(name, mb):
    """JAX's meshless metrics, grads (named) and grad norm on the first
    batch, as the reference's step computes them with `mb`
    microbatches (the mean over the microbatches)."""
    jc, _ = _cfgs(name)
    params, batches = _inputs(name)
    ctx = ParallelCtx(remat="none")
    vg = jax.jit(jax.value_and_grad(lambda p, b: JM.loss_fn(p, b, jc, ctx),
                                    has_aux=True))
    n = B // mb
    outs = [vg(params, {k: v[i * n:(i + 1) * n]
                        for k, v in batches[0].items()})
            for i in range(mb)]
    grads = jax.tree.map(lambda *g: sum(g) / mb, *[o[1] for o in outs])
    metrics = {k: sum(float(o[0][1][k]) for o in outs) / mb
               for k in outs[0][0][1]}
    return (metrics, {n_: np.asarray(v) for n_, v in jnamed(grads)},
            float(jadamw.global_norm(grads)))


def _jax_step(name):
    jc, _ = _cfgs(name)
    params, batches = _inputs(name)
    jp = jax.tree.map(jnp.asarray, params)
    state = {"step": jnp.zeros((), jnp.int32), "params": jp,
             "opt": jadamw.adamw_init(jp)}
    step = jax.jit(jtrain.build_train_step(
        jc, ParallelCtx(remat="none"), JTrainConfig(**TCFG)))
    new_state, metrics = step(state, jax.tree.map(jnp.asarray, batches[0]))
    return (jax.tree.map(np.asarray, new_state),
            jax.tree.map(np.asarray, metrics))


def _ssm_inputs(name="mamba2_780m"):
    """One SSM layer of reduced mamba2, or of its variant `name` (the
    reference's init, layer 0, its per-head leaves and norm scale
    perturbed so that none is at its init's constant), x and a
    cotangent (B, S, d), float32 numpy."""
    params, _ = _inputs(name)
    rng = np.random.default_rng(3)
    layer = {k: np.array(v[0]) for k, v in
             params["blocks"]["pos0"]["ssm"].items()}
    for k in ("A_log", "D", "dt_bias", "norm_scale"):
        layer[k] = (layer[k] + 0.3 * rng.standard_normal(layer[k].shape)
                    ).astype(np.float32)
    d = layer["w_in_x"].shape[0]
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    cot = rng.standard_normal((B, S, d)).astype(np.float32)
    return layer, x, cot


def _moe_inputs():
    """Reduced granite-moe at capacity 8.0 (no pair drops, as
    `moe_dense`): its cfgs, the MoE layer's params, x and a cotangent of
    MOE_SHAPE, float32 numpy."""
    jc, tc = (dataclasses.replace(c, capacity_factor=8.0)
              for c in _cfgs("granite_moe_1b_a400m"))
    rng = np.random.default_rng(7)
    d, E, ff = tc.d_model, tc.num_experts, tc.moe_d_ff
    params = {k: rng.normal(0, d ** -0.5, shape).astype(np.float32)
              for k, shape in (("router", (d, E)), ("w_gate", (E, d, ff)),
                               ("w_up", (E, d, ff)), ("w_down", (E, ff, d)))}
    x, cot = (rng.normal(0, 1, (*MOE_SHAPE, d)).astype(np.float32)
              for _ in range(2))
    return jc, tc, params, x, cot


SHARDED_CODE = r"""
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from repro import configs
from repro.common.config import TrainConfig
from repro.common.pytree import named_leaves
from repro.data.synthetic import make_batch_for
from repro.launch.mesh import ctx_for_mesh
from repro.runtime import sharding as shd, train as train_rt

ARCHS = {archs!r}
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {{}}
for name, over in ARCHS.items():
    over = dict(over)
    cfg = dataclasses.replace(configs.reduced(over.pop("arch")),
                              dtype="float32", **over)
    ctx = ctx_for_mesh(mesh, fsdp=True)
    if cfg.num_experts:
        ctx = dataclasses.replace(ctx, moe_fsdp_mode="gather")
    rules = shd.ShardingRules.for_training(ctx.fsdp_axis, ctx.tp_axis)
    tcfg = TrainConfig(total_steps=10, warmup_steps=2)
    batch = make_batch_for(cfg, {S}, {B}, 0)
    bundle = train_rt.make_bundle(cfg, ctx, tcfg, rules, mesh, batch,
                                  donate=False)
    state, _ = train_rt.init_train_state(cfg, jax.random.PRNGKey(0))
    for step in range({STEPS}):
        state, m = bundle.step_fn(state, make_batch_for(cfg, {S}, {B}, step))
        # the step's outputs may come back laid out otherwise than its
        # in_shardings (an SSM stack's per-head leaves): lay them out again
        state = jax.device_put(state, bundle.state_shardings)
        out[f"{{name}}|loss|{{step}}"] = np.asarray(m["loss"])
        out[f"{{name}}|grad_norm|{{step}}"] = np.asarray(m["grad_norm"])
        out[f"{{name}}|lr|{{step}}"] = np.asarray(m["lr"])
    for leaf, v in named_leaves(state):
        out[f"{{name}}|state|{{leaf}}"] = np.asarray(v)
# moe_ep with grad, S % ep != 0: every rank routes every token
from repro.models import moe
d = dict(np.load(sys.argv[2]))
mcfg = dataclasses.replace(configs.reduced("granite_moe_1b_a400m"),
                           dtype="float32", capacity_factor=8.0)
ctx = dataclasses.replace(ctx_for_mesh(mesh, fsdp=True),
                          moe_fsdp_mode="gather")
w = {{k: jnp.asarray(d[k]) for k in ("router", "w_gate", "w_up", "w_down")}}


def objective(w, x):
    y, aux = moe.moe_ep(w, x, mcfg, ctx)
    return (jnp.sum(y.astype(jnp.float32) * d["cot"]) + {DP} * 0.01 * aux,
            (y, aux))


(_, (y, aux)), (gw, gx) = jax.jit(jax.value_and_grad(
    objective, argnums=(0, 1), has_aux=True))(w, jnp.asarray(d["x"]))
out["moe|y"], out["moe|aux"], out["moe|x"] = map(np.asarray, (y, aux, gx))
for k, g in gw.items():
    out[f"moe|{{k}}"] = np.asarray(g)
np.savez(sys.argv[1], **out)
print("SHARDED_OK")
"""


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train")
    code = SHARDED_CODE.format(
        archs={n: ARCHS[n] for n in STEPPED}, S=S, B=B, STEPS=STEPS, DP=DP)
    _, mcfg, mparams, mx, mcot = _moe_inputs()
    np.savez(tmp / "moe.npz", x=mx, cot=mcot, **mparams)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                          " --xla_force_host_platform_device_count=4")
               .strip())
    proc = subprocess.Popen([sys.executable, "-c", code,
                             str(tmp / "sharded.npz"), str(tmp / "moe.npz")],
                            env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        calls = []
        for name in ARCHS:
            params, batches = _inputs(name)
            calls.append((dtt.mesh_train_rank,
                          (_cfgs(name)[1], DP, TP, params, batches,
                           _runs(name), "cpu")))
        calls += [(dtt.ssm_grad_rank, (DP, TP, *_ssm_inputs(arch),
                                       _cfgs(arch)[1], fsdp, "cpu"))
                  for arch, fsdp in SSM_CASES.values()]
        calls.append((dtt.moe_grad_rank, (DP, TP, mparams, mx, mcot, mcfg,
                                          "cpu")))
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            fut = pool.submit(tmesh.run_ranks, dst.mesh_calls, DP * TP,
                              (calls,), device="cpu", threads=1,
                              timeout_s=120, wall_s=900)
            ref = {(n, mb): _jax_grads(n, mb) for n in ARCHS
                   for mb in sorted({mb for mb, _ in _grad_runs(n)})}
            steps = {n: _jax_step(n) for n in ARCHS}
            got = fut.result()
    finally:
        out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0 and "SHARDED_OK" in out, err[-3000:]
    sharded = dict(np.load(tmp / "sharded.npz"))
    results = {n: [got[r][i] for r in range(DP * TP)]
               for i, n in enumerate(ARCHS)}
    ssm = {c: [got[r][len(ARCHS) + i] for r in range(DP * TP)]
           for i, c in enumerate(SSM_CASES)}
    moe_ranks = [got[r][-1] for r in range(DP * TP)]
    return dict(results=results, ref=ref, steps=steps, sharded=sharded,
                ssm=ssm, moe=moe_ranks)


def _run(mesh_runs, name, label):
    per = mesh_runs["results"][name]
    i = [r["name"] for r in per[0]].index(label)
    return [p[i] for p in per]


def _grad_cases():
    return [(n, mb, remat) for n in ARCHS for mb, remat in _grad_runs(n)]


@pytest.mark.parametrize("name,mb,remat", _grad_cases())
def test_grads_match_jax_meshless(mesh_runs, name, mb, remat):
    per = _run(mesh_runs, name, f"grads mb{mb} {remat}")
    metrics, want, gnorm = mesh_runs["ref"][(name, mb)]
    got = dict(tnamed(per[0]["grads"]))
    assert set(got) == set(want)
    for leaf, w in want.items():
        np.testing.assert_allclose(
            got[leaf], w, rtol=0,
            atol=1e-5 * max(float(np.abs(w).max()), 1e-30), err_msg=leaf)
    for p in per:                       # every rank reports the same
        for k, v in metrics.items():
            np.testing.assert_allclose(p["grad_metrics"][k], v, rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        np.testing.assert_allclose(p["grad_norms"][0], gnorm, rtol=1e-5)
        assert p["grad_metrics"] == per[0]["grad_metrics"]


def _np_named(tree):
    return {n: np.asarray(v) for n, v in tnamed(tree)}


def _update_close(name, new, old, want_new, lr, grad=None):
    err = np.abs((new - old) - (want_new - old))
    share = float((err <= 1e-2 * lr).mean())
    if grad is not None:
        near = int((np.abs(grad) <= 1e-6 * np.abs(grad).max()).sum())
        if near:
            print(f"{name}: {near} elements with |g| within rounding of 0")
    assert share >= 0.999, (name, share, float(err.max()))
    assert float(err.max()) <= 2.2 * lr, (name, float(err.max()))


@pytest.mark.parametrize("name", list(ARCHS))
def test_first_step_matches_the_reference_step(mesh_runs, name):
    per = _run(mesh_runs, name, "grads mb1 none")
    state = per[0]["state"]
    want_state, want_metrics = mesh_runs["steps"][name]
    lr = float(want_metrics["lr"])
    assert int(state["step"]) == int(state["opt"]["count"]) == 1
    np.testing.assert_allclose(per[0]["losses"][0],
                               float(want_metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(per[0]["grad_norms"][0],
                               float(want_metrics["grad_norm"]), rtol=1e-5)
    for moment in ("m", "v"):
        want = _np_named(want_state["opt"][moment])
        for leaf, t in _np_named(state["opt"][moment]).items():
            np.testing.assert_allclose(
                t, want[leaf], rtol=0,
                atol=1e-5 * max(float(np.abs(want[leaf]).max()), 1e-30),
                err_msg=f"{moment}/{leaf}")
    params, _ = _inputs(name)
    old, grads = _np_named(params), dict(tnamed(per[0]["grads"]))
    want_new = _np_named(want_state["params"])
    for leaf, p in _np_named(state["params"]).items():
        _update_close(leaf, p, old[leaf], want_new[leaf], lr, grads[leaf])


@pytest.mark.parametrize("name", STEPPED)
def test_three_steps_match_the_reference_sharded_step(mesh_runs, name):
    per = _run(mesh_runs, name, "three steps")
    ref = mesh_runs["sharded"]
    for p in per:
        for s in range(STEPS):
            np.testing.assert_allclose(p["losses"][s],
                                       float(ref[f"{name}|loss|{s}"]),
                                       rtol=1e-5, err_msg=f"loss {s}")
            np.testing.assert_allclose(p["grad_norms"][s],
                                       float(ref[f"{name}|grad_norm|{s}"]),
                                       rtol=1e-5, err_msg=f"grad norm {s}")
    lr = sum(float(ref[f"{name}|lr|{s}"]) for s in range(STEPS))
    params, _ = _inputs(name)
    old = _np_named(params)
    state = _np_named(per[0]["state"])
    for leaf, v in state.items():
        want = ref[f"{name}|state|{leaf}"]
        if leaf.startswith("params/"):
            _update_close(leaf, v, old[leaf[len("params/"):]], want, lr)
        elif leaf.startswith("opt/"):
            np.testing.assert_allclose(
                v, want, rtol=0,
                atol=1e-4 * max(float(np.abs(want).max()), 1e-30),
                err_msg=leaf)
        else:
            np.testing.assert_array_equal(v, want, err_msg=leaf)


@pytest.mark.parametrize("name", list(ARCHS))
def test_replicas_bit_equal_and_state_bytes_its_share(mesh_runs, name):
    per_rank = mesh_runs["results"][name]
    for i, run in enumerate(per_rank[0]):
        runs = [r[i] for r in per_rank]
        assert dtt.replicas_equal([r["digests"] for r in runs]) == [], \
            run["name"]
        assert all(r["state_bytes"] == r["share_bytes"] for r in runs), \
            [(r["state_bytes"], r["share_bytes"]) for r in runs]
        assert sorted(r["coord"] for r in runs) == [(0, 0), (0, 1), (1, 0),
                                                    (1, 1)]
        assert not any(r["launches"] for r in runs)   # plain versions here


@pytest.mark.parametrize("name", BF16)
def test_bf16_forward_is_the_split_products(mesh_runs, name):
    """In bf16 a dp2tp2 rank's forward differs from the meshless one only
    by the rounding of its row-parallel products' halves: the per-token
    NLL of the global batch, gathered from the ranks, bit-equal to the
    meshless bf16 forward with those products split in two and summed in
    bf16 (`dev_train_torch.tp_split_products`, the witness the card's
    bf16 gate reads)."""
    from repro_torch.models.module import load_numpy_params

    per = _run(mesh_runs, name, "bf16")
    _, tc = _cfgs(name)
    tc = dataclasses.replace(tc, dtype="bfloat16")
    params, batches = _inputs(name)
    with dtt.tp_split_products(TP):
        want = dtt.token_nll(load_numpy_params(params, device="cpu"),
                             {k: np.array(v) for k, v in batches[0].items()},
                             tc).numpy()
    for p in per:
        np.testing.assert_array_equal(p["token_nll"][0], want)


@pytest.mark.parametrize("case", list(SSM_CASES))
def test_ssm_block_grads_match_jax(mesh_runs, case):
    """`ssm_block` with `d_inner` split over `model` (mamba2: 4 of 8
    heads a rank; the head cut: 1.5 of 3, as virtual heads): the whole
    leaves a rank's heads read (`w_in_B`, `w_in_C`, `conv_B`, `conv_C`,
    `w_in_dt`, `A_log`, `D`, `dt_bias`) and x enter the TP region, and
    the gated norm's summed squares take their cotangent summed over it;
    with FSDP every `w_in_*` and `w_out` is gathered over `data`. Every
    gradient, x's and y within 1e-5 of their largest magnitude of the
    reference's meshless block."""
    from repro.models import ssm as jssm

    arch, fsdp = SSM_CASES[case]
    jc, _ = _cfgs(arch)
    layer, x, cot = _ssm_inputs(arch)
    y, vjp = jax.vjp(lambda p, x_: jssm.ssm_block(p, x_, jc),
                     jax.tree.map(jnp.asarray, layer), jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(cot))
    per = mesh_runs["ssm"][case]
    specs = per[0]["specs"]
    assert specs["w_in_x"] == (("data", "model") if fsdp
                               else (None, "model"))
    assert specs["A_log"] == (None,)
    want = dict(jax.tree.map(np.asarray, gp), x=np.asarray(gx),
                y=np.asarray(y))
    got = dict(per[0]["grads"], x=per[0]["x_grad"], y=per[0]["y"])
    assert set(got) == set(want)
    for leaf, w in want.items():
        np.testing.assert_allclose(
            got[leaf], w, rtol=0,
            atol=1e-5 * max(float(np.abs(w).max()), 1e-30), err_msg=leaf)
    for p in per[1:]:
        np.testing.assert_array_equal(p["x_grad"], per[0]["x_grad"])


@pytest.mark.parametrize("against", ["moe_dense", "reference moe_ep"])
def test_moe_ep_grads_with_an_unsplit_sequence(mesh_runs, against):
    """`moe_ep` with grad at S 3 on an EP axis of 2 (the sequence does not
    split over it: every rank routes every token, and y's cotangent is
    counted once over the axis) over dp2tp2 under the training rules:
    y, aux and the gradients of x and of every weight within 1e-5 of
    their largest magnitude of the port's `moe_dense` on the whole
    weights, or of `jax.grad` of the reference's `moe_ep` on its (2, 2)
    mesh (its "gather" schedule, ROADMAP §C)."""
    _, tc, params, x, cot = _moe_inputs()
    per = mesh_runs["moe"]
    got = per[0]
    assert MOE_SHAPE[1] % TP and got["specs"]["w_up"] == ("model", "data",
                                                          None)
    if against == "moe_dense":
        from repro_torch.models import moe as tmoe

        w = {k: torch.tensor(v, requires_grad=True) for k, v in
             params.items()}
        xt = torch.tensor(x, requires_grad=True)
        y, aux = tmoe.moe_dense(w, xt, tc)
        dtt.moe_objective(y, aux, torch.tensor(cot), n_aux=DP).backward()
        want = dict(y=y.detach().numpy(), aux=float(aux.detach()),
                    x=xt.grad.numpy(),
                    **{k: w[k].grad.numpy() for k in params})
    else:
        ref = mesh_runs["sharded"]
        want = {k: ref[f"moe|{k}"] for k in ("y", "x", *params)}
        want["aux"] = float(ref["moe|aux"])
    have = dict(got["grads"], y=got["y"], x=got["x_grad"])
    for leaf in ("y", "x", *params):
        np.testing.assert_allclose(
            have[leaf], want[leaf], rtol=0,
            atol=1e-5 * float(np.abs(want[leaf]).max()), err_msg=leaf)
    for p in per:
        assert abs(p["aux"] - want["aux"]) <= 1e-5 * abs(want["aux"])
        np.testing.assert_array_equal(p["y"], got["y"])


def test_tiered_step_bit_equal_on_every_rank(mesh_runs):
    per = _run(mesh_runs, TIERED, "three steps")
    for p in per:
        assert p["tier"]["equal"] == [True] * STEPS
        assert p["tier"]["n_host"] > 0 and p["tier"]["pool_bytes"] > 0
        assert p["tier"]["host_annotation"] == "logical-only"


# ------------------------------------------------------ in this process
STANDIN = SimpleNamespace(shape={"data": 2, "model": 2})


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "granite_3_2b",
                                  "qwen2_5_32b"])
def test_training_specs_match_the_reference(arch):
    jc = jconfigs.reduced(arch)
    tc = tconfigs.reduced(arch)
    jstate, jaxes = jtrain.abstract_train_state(jc)
    want = dict(jnamed(jtrain.state_pspecs(
        jstate, jaxes, jshd.ShardingRules.for_training(), STANDIN)))
    bundle = ttrain.make_bundle(tc, TrainConfig())
    got = dict(tnamed(ttrain.state_pspecs(
        bundle.abstract_state, bundle.axes,
        tshd.ShardingRules.for_training(), STANDIN)))
    assert set(got) == set(want)
    for leaf, spec in got.items():
        assert tuple(spec) == tuple(want[leaf]) or (
            not any(spec) and not any(want[leaf])), leaf
    if tc.num_experts:
        base = "params/blocks/pos0/moe/"
        # (layers, experts, embed, moe_ff) and (layers, experts, moe_ff,
        # embed): the first of the two dims to ask takes `data`
        assert got[base + "w_up"] == (None, "model", "data", None)
        assert got[base + "w_gate"] == (None, "model", "data", None)
        assert got[base + "w_down"] == (None, "model", "data", None)
        assert got[base + "router"] == (None, "data", "model")


@pytest.mark.parametrize("arch", ["granite_3_2b", "granite_moe_1b_a400m"])
def test_tiering_shard_counts_and_profile_match_the_reference(arch):
    jc, tc = jconfigs.reduced(arch), tconfigs.reduced(arch)
    rules = jshd.ShardingRules.for_training()
    jstate, jaxes = jtrain.abstract_train_state(jc)
    jspecs = jtrain.state_pspecs(jstate, jaxes, rules, STANDIN)
    bundle = ttrain.make_bundle(tc, TrainConfig())
    tspecs = ttrain.state_pspecs(bundle.abstract_state, bundle.axes,
                                 tshd.ShardingRules.for_training(), STANDIN)
    assert ttiering.shard_counts(tspecs, STANDIN) == \
        jtiering.shard_counts(jspecs, STANDIN)
    shape = ShapeConfig("t", 64, 8, "train")
    jshape = JShapeConfig("t", 64, 8, "train")
    got = ttiering.per_device_profile(bundle.abstract_state, tspecs,
                                      STANDIN, tc, shape, "block")
    want = jtiering.per_device_profile(jstate, jspecs, STANDIN, jc, jshape,
                                       "block")
    assert [(a.name, a.bytes) for a in got] == \
        [(a.name, a.bytes) for a in want]
    assert sum(a.bytes for a in got) < sum(
        a.bytes for a in ttiering.per_device_profile(
            bundle.abstract_state, tc, shape, "block"))


def _launcher_against_the_bundle(arch, tmp_path):
    """`launch.train.main` of the reduced `arch` (3 steps, batch 2 x 16)
    through the (1, 1) smoke mesh (gloo here): its losses, and no
    process group left; with the meshless bundle's losses on the same
    seed and batches."""
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.launch import train as tlaunch

    assert not torch.distributed.is_initialized()
    losses = tlaunch.main(["--arch", arch, "--reduced",
                           "--steps", "3", "--batch", "2", "--seq", "16",
                           "--device", "cpu", "--log-every", "100",
                           "--ckpt-dir", str(tmp_path / "ck"),
                           "--ckpt-every", "100"])
    assert not torch.distributed.is_initialized()
    cfg = tconfigs.reduced(arch)
    tcfg = TrainConfig(learning_rate=3e-4, total_steps=3, warmup_steps=1,
                       remat="block")
    bundle = ttrain.make_bundle(cfg, tcfg)
    state = ttrain.init_train_state(cfg, device="cpu", seed=0)
    want = []
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for s in range(3):
            state, m = bundle.step_fn(state, make_batch_for(cfg, 16, 2, s, 0))
            want.append(float(m["loss"]))
    finally:
        torch.use_deterministic_algorithms(deterministic)
    return losses, want


def test_launcher_trains_through_the_smoke_mesh(tmp_path):
    """`launch.train.main` through the (1, 1) smoke mesh (gloo here):
    its losses bit-equal to the meshless bundle's steps on the same
    seed and batches, and no process group left."""
    losses, want = _launcher_against_the_bundle("granite_3_2b", tmp_path)
    assert losses == want


def test_launcher_trains_an_ssm_stack_through_the_smoke_mesh(tmp_path):
    """The same for reduced mamba2: the SSM block under the training
    rules over the (1, 1) mesh, bit-equal to the meshless bundle."""
    losses, want = _launcher_against_the_bundle("mamba2_780m", tmp_path)
    assert losses == want

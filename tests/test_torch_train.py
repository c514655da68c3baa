"""The port's training path against the reference's, on the CPU.

Per arch family (reduced configs of smollm = dense, mamba2 = ssm,
granite-moe = moe, paligemma = vlm, seamless = audio enc-dec, jamba =
hybrid) in float32, on the reference's `init_model(cfg, PRNGKey(0))`
weights carried across by `load_numpy_params` and the reference's
`make_batch_for` batch as numpy:

* `loss_fn`'s loss and metrics within 1e-5 relative;
* every grad leaf within rtol 1e-4 and atol 1e-5 of the leaf's largest
  magnitude: float32 through two to four layers, sums in another order.
  Each package's float32 grads differ from a float64 evaluation of the
  same model by up to 5e-6 of a leaf's largest magnitude (jamba,
  measured against the port in float64), so 1e-6 of it would hold the
  port to a tighter bound than the reference meets;
* one `build_train_step` step: the update (new - old params) within
  1e-2 * lr of the JAX step's on at least 99.9% of each leaf's elements
  and within 2.2 * lr everywhere (Adam's first step is about sign(g): a
  near-zero gradient may flip its sign), `step`, `count`, `lr` and
  `grad_norm` within 1e-6, the AdamW moments as the grads; the same with
  two microbatches against the reference's two.

The JAX grads and step are built once per arch (module cache). Then the
port alone: `remat="block"` gives the grads of `"none"`, two microbatches
the update, moments, loss and grad norm of one (MoE skipped, as the
reference's test does), the optimizer and schedule against the
reference on random trees, the synthetic data stream's determinism and
structure, the pipeline, the fault layer, the launcher (runs, resumes)
and the example (learns).
"""

import dataclasses
import functools
import importlib.util
import os
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.common.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.common.parallel import ParallelCtx  # noqa: E402
from repro.common.pytree import named_leaves as jnamed  # noqa: E402
from repro.data.synthetic import make_batch_for as jbatch  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedule as jschedule  # noqa: E402
from repro.runtime import fault as jfault  # noqa: E402
from repro.runtime import train as jtrain  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.common.config import TrainConfig  # noqa: E402
from repro_torch.common.pytree import named_leaves as tnamed  # noqa: E402
from repro_torch.data import PrefetchPipeline  # noqa: E402
from repro_torch.data.synthetic import SyntheticLM, make_batch_for  # noqa
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.module import load_numpy_params  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import schedule as tschedule  # noqa: E402
from repro_torch.runtime import fault as tfault  # noqa: E402
from repro_torch.runtime import train as ttrain  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAMILIES = ["smollm_360m", "mamba2_780m", "granite_moe_1b_a400m",
            "paligemma_3b", "seamless_m4t_large_v2", "jamba_1_5_large_398b"]
B, S = 2, 16
TCFG = dict(total_steps=10, warmup_steps=2)


def _cfgs(arch):
    jc = dataclasses.replace(jconfigs.reduced(arch), dtype="float32")
    tc = dataclasses.replace(tconfigs.reduced(arch), dtype="float32")
    return jc, tc


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's weights, batch, grads and one train step (numpy)."""
    jc, _ = _cfgs(arch)
    ctx = ParallelCtx(remat="none")
    jp = jax.jit(lambda key: JM.init_model(jc, key)[0])(
        jax.random.PRNGKey(0))
    batch = jbatch(jc, S, B, 0)
    (_, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, b, jc, ctx), has_aux=True))(jp, batch)
    state = {"step": jnp.zeros((), jnp.int32), "params": jp,
             "opt": jadamw.adamw_init(jp)}
    step = jax.jit(jtrain.build_train_step(jc, ctx, JTrainConfig(**TCFG)))
    new_state, step_metrics = step(state, batch)
    to_np = functools.partial(jax.tree.map, np.asarray)
    return dict(params=to_np(jp), batch=to_np(batch),
                metrics=to_np(metrics), grads=dict(jnamed(to_np(grads))),
                new_state=to_np(new_state), step_metrics=to_np(step_metrics))


def _port(arch):
    _, tc = _cfgs(arch)
    ref = _reference(arch)
    params = load_numpy_params(ref["params"], device="cpu")
    batch = {k: torch.tensor(v) for k, v in ref["batch"].items()}
    return tc, ref, params, batch


def _grads(tc, params, batch, remat="none"):
    leaves = tadamw.tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = TM.loss_fn(leaves, batch, tc, remat=remat)
    loss.backward()
    return metrics, {n: (p.grad if p.grad is not None
                         else torch.zeros_like(p))
                     for n, p in tnamed(leaves)}


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_metrics_match_reference(arch):
    tc, ref, params, batch = _port(arch)
    _, metrics = TM.loss_fn(params, batch, tc)
    assert set(metrics) == set(ref["metrics"])
    for k, want in ref["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), float(want),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("arch", FAMILIES)
def test_grads_match_reference(arch):
    tc, ref, params, batch = _port(arch)
    _, grads = _grads(tc, params, batch)
    assert set(grads) == set(ref["grads"])
    for name, want in ref["grads"].items():
        got = grads[name].numpy()
        np.testing.assert_allclose(
            got, want, rtol=1e-4,
            atol=1e-5 * max(float(np.abs(want).max()), 1e-30),
            err_msg=name)


def _update_close(name, new, old, want_new, lr):
    upd = new - old
    want = want_new - old
    err = np.abs(upd - want)
    share = float((err <= 1e-2 * lr).mean())
    assert share >= 0.999, (name, share, float(err.max()))
    assert float(err.max()) <= 2.2 * lr, (name, float(err.max()))


def _np_named(tree):
    return {n: np.asarray(v) for n, v in tnamed(tree)}


def _step_close(new_state, metrics, params, want_state, want_metrics,
                norm_rtol=1e-6):
    """One port step against a wanted step from the same params: `step`
    and `count`, `lr`, `grad_norm` and `loss`, the update of every param
    leaf (`_update_close`) and the AdamW moments m = (1 - b1) g and v =
    (1 - b2) g^2 leaf by leaf, which see the gradient's scale that Adam's
    normalized update does not. `want_state` is the reference's state as
    numpy or the port's."""
    lr = float(want_metrics["lr"])
    assert int(new_state["step"]) == int(want_state["step"]) == 1
    assert int(new_state["opt"]["count"]) == \
        int(want_state["opt"]["count"]) == 1
    for k, rtol in (("lr", 1e-6), ("grad_norm", norm_rtol),
                    ("loss", norm_rtol)):
        np.testing.assert_allclose(float(metrics[k]),
                                   float(want_metrics[k]), rtol=rtol,
                                   atol=1e-7, err_msg=k)
    old = _np_named(params)
    want_new = _np_named(want_state["params"])
    for name, p in tnamed(new_state["params"]):
        assert p.dtype == torch.float32
        _update_close(name, p.numpy(), old[name], want_new[name], lr)
    for moment in ("m", "v"):
        want = _np_named(want_state["opt"][moment])
        for name, t in tnamed(new_state["opt"][moment]):
            np.testing.assert_allclose(
                t.numpy(), want[name], rtol=1e-4,
                atol=1e-5 * max(float(np.abs(want[name]).max()), 1e-30),
                err_msg=f"{moment}/{name}")


def _port_step(tc, params, batch, microbatches=1):
    state = {"step": torch.zeros((), dtype=torch.int32), "params": params,
             "opt": tadamw.adamw_init(params)}
    step = ttrain.build_train_step(tc, TrainConfig(
        remat="none", microbatches=microbatches, **TCFG))
    return step(state, batch)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_reference(arch):
    tc, ref, params, batch = _port(arch)
    new_state, metrics = _port_step(tc, params, batch)
    _step_close(new_state, metrics, params, ref["new_state"],
                ref["step_metrics"])


@functools.lru_cache(maxsize=None)
def _reference_microbatched(arch):
    """The reference's step with two microbatches (of one row each) on
    `_reference`'s weights and batch (numpy)."""
    jc, _ = _cfgs(arch)
    ref = _reference(arch)
    jp = jax.tree.map(jnp.asarray, ref["params"])
    state = {"step": jnp.zeros((), jnp.int32), "params": jp,
             "opt": jadamw.adamw_init(jp)}
    step = jax.jit(jtrain.build_train_step(
        jc, ParallelCtx(remat="none"), JTrainConfig(microbatches=2, **TCFG)))
    new_state, metrics = step(state, jax.tree.map(jnp.asarray, ref["batch"]))
    to_np = functools.partial(jax.tree.map, np.asarray)
    return to_np(new_state), to_np(metrics)


@pytest.mark.parametrize("arch", FAMILIES)
def test_microbatched_step_matches_reference(arch):
    """Two microbatches: the port's accumulation against the reference's
    `lax.scan` over the same two rows, MoE included (both split the
    batch the same way)."""
    tc, _, params, batch = _port(arch)
    new_state, metrics = _port_step(tc, params, batch, microbatches=2)
    _step_close(new_state, metrics, params, *_reference_microbatched(arch))


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_block_gives_the_same_grads(arch):
    tc, _, params, batch = _port(arch)
    m0, g0 = _grads(tc, params, batch, "none")
    m1, g1 = _grads(tc, params, batch, "block")
    assert float(m0["loss"].detach()) == float(m1["loss"].detach())
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", FAMILIES)
def test_microbatches_match_one_batch(arch):
    """Two microbatches update the params, and fill the moments, as one
    batch of both (the reference's `test_microbatched_grad_accum_matches`,
    on the port); the loss and grad norm within 1e-5 (the sums run in
    another order)."""
    tc, _, _, _ = _port(arch)
    if tc.num_experts:
        pytest.skip("MoE routing is batch-composition dependent")
    params = ttrain.init_train_state(
        tc, torch.Generator().manual_seed(1))["params"]
    batch = make_batch_for(tc, S, 4, 0)
    one, one_metrics = _port_step(tc, params, batch)
    two, two_metrics = _port_step(tc, params, batch, microbatches=2)
    _step_close(two, two_metrics, params, one, one_metrics, norm_rtol=1e-5)


def test_ssd_grad_gap_script_runs_on_the_cpu(capsys):
    """`scripts/ssd_grad_gap.py` at the reduced mamba2 on the CPU, where
    both of its runs take the plain versions: every gap it prints is 0."""
    spec = importlib.util.spec_from_file_location(
        "ssd_grad_gap", ROOT / "scripts" / "ssd_grad_gap.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--device", "cpu", "--reduced", "--batch", "2",
                     "--seq", "96"]) == 0
    out = capsys.readouterr().out
    assert "loss kernels" in out and "gap 0.000e+00" in out
    assert out.count("layer ") == tconfigs.reduced("mamba2_780m").num_layers
    assert "e-" not in out.split("param grads")[1].split("grad norm")[0]


def test_train_config_and_bundle_refuse_the_mesh():
    """The config and the bundle as the reference's: `compress_grads` is
    accepted and, as in the reference, changes no step; a (1, 1) mesh is
    accepted (one gloo rank in this process, destroyed after) and its
    step is bit-equal to the meshless one; an SSM stack's bundle over a
    mesh builds, its SSM leaves split as the training rules split them
    (a stand-in mesh: nothing runs); the abstract state is the
    reference's tree."""
    from types import SimpleNamespace

    from repro_torch.launch import mesh as tmesh

    assert dataclasses.asdict(TrainConfig()) == \
        dataclasses.asdict(JTrainConfig())
    with pytest.raises(ValueError, match="remat"):
        TrainConfig(remat="full")
    cfg = dataclasses.replace(tconfigs.reduced("smollm_360m"),
                              dtype="float32")
    params = ttrain.init_train_state(
        cfg, torch.Generator().manual_seed(1))["params"]
    batch = make_batch_for(cfg, S, 4, 0)
    plain = _port_step(cfg, params, batch)
    state = {"step": torch.zeros((), dtype=torch.int32), "params": params,
             "opt": tadamw.adamw_init(params)}
    squeezed = ttrain.build_train_step(cfg, TrainConfig(
        remat="none", compress_grads=True, **TCFG))(state, batch)
    assert torch.distributed.is_initialized() is False
    mesh = tmesh.make_smoke_mesh(device="cpu")
    try:
        meshed = ttrain.make_bundle(cfg, TrainConfig(remat="none", **TCFG),
                                    mesh=mesh).step_fn(state, batch)
    finally:
        tmesh.close_ranks()
    for got in (squeezed, meshed):
        for (n, a), (_, b) in zip(tnamed(got[0]), tnamed(plain[0])):
            assert torch.equal(a, b), n
        assert all(torch.equal(got[1][k], v) for k, v in plain[1].items())
    stub = SimpleNamespace(shape={"data": 2, "model": 2})
    ssm = ttrain.make_bundle(tconfigs.reduced("mamba2_780m"), TrainConfig(),
                             mesh=stub)
    specs = ssm.state_pspecs["params"]["blocks"]["pos0"]["ssm"]
    assert specs["w_in_x"] == (None, "data", "model")
    assert specs["w_in_B"] == (None, "data", None)
    assert specs["A_log"] == (None, None)
    assert ssm.ctx.mesh is stub and ssm.ctx.fsdp_axis == "data"
    bundle = ttrain.make_bundle(cfg, TrainConfig())
    cfg = tconfigs.reduced("smollm_360m")
    jstate, _ = jtrain.abstract_train_state(jconfigs.reduced("smollm_360m"))
    assert [(n, tuple(v.shape), str(v.dtype).split(".")[-1])
            for n, v in tnamed(bundle.abstract_state)] == \
        [(n, tuple(v.shape), str(v.dtype)) for n, v in jnamed(jstate)]
    assert all(v.device.type == "meta"
               for _, v in tnamed(bundle.abstract_state))


# ------------------------------------------------ optimizer and schedule
def _tree(rng, scale=1.0):
    return {"a": {"w": rng.standard_normal((5, 7)).astype(np.float32)
                  * scale,
                  "b": rng.standard_normal((7,)).astype(np.float32) * scale},
            "z": rng.standard_normal((3, 2, 4)).astype(np.float32) * scale}


def _jtree(t):
    return jax.tree.map(jnp.asarray, t)


def _ttree(t):
    return tadamw.tree_map(torch.tensor, t)


def _same(t, j, tol=1e-6):
    jd = dict(jnamed(j))
    for name, v in tnamed(t):
        np.testing.assert_allclose(np.asarray(v), np.asarray(jd[name]),
                                   rtol=tol, atol=tol, err_msg=name)


def test_warmup_cosine_matches_reference():
    kw = dict(peak_lr=3e-4, warmup_steps=10, total_steps=100)
    for step in [0, 1, 5, 9, 10, 11, 50, 99, 100, 150]:
        for extra in ({}, {"floor": 0.0}):
            np.testing.assert_allclose(
                float(tschedule.warmup_cosine(step, **kw, **extra)),
                float(jschedule.warmup_cosine(step, **kw, **extra)),
                rtol=1e-6, atol=1e-12)
    assert float(tschedule.warmup_cosine(0, peak_lr=1.0, warmup_steps=0,
                                         total_steps=0)) == \
        float(jschedule.warmup_cosine(0, peak_lr=1.0, warmup_steps=0,
                                      total_steps=0))


@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_update_matches_reference(steps):
    rng = np.random.default_rng(steps)
    params = _tree(rng)
    cfg_t, cfg_j = tadamw.AdamWConfig(), jadamw.AdamWConfig()
    tp, jp = _ttree(params), _jtree(params)
    to, jo = tadamw.adamw_init(tp), jadamw.adamw_init(jp)
    for i in range(steps):
        g = _tree(rng, 0.1)
        lr = 1e-3 * (i + 1)
        tp, to = tadamw.adamw_update(_ttree(g), to, tp, lr, cfg_t)
        jp, jo = jadamw.adamw_update(_jtree(g), jo, jp, lr, cfg_j)
    _same(tp, jp)
    _same(to["m"], jo["m"])
    _same(to["v"], jo["v"])
    assert int(to["count"]) == int(jo["count"]) == steps


@pytest.mark.parametrize("max_norm", [0.1, 1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(np.random.default_rng(7))
    tg, tn = tadamw.clip_by_global_norm(_ttree(g), max_norm)
    jg, jn = jadamw.clip_by_global_norm(_jtree(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(float(tadamw.global_norm(_ttree(g))),
                               float(jadamw.global_norm(_jtree(g))),
                               rtol=1e-6)
    _same(tg, jg)


# ---------------------------------------------- data, pipeline, faults
@pytest.mark.parametrize("V,seq", [(128, 32), (49152, 64)])
def test_synthetic_stream_is_deterministic_and_structured(V, seq):
    ds = SyntheticLM(V, seq, 4, seed=3)
    a, b = ds.batch_at(5)["tokens"], ds.batch_at(5)["tokens"]
    assert a.dtype == torch.int32 and tuple(a.shape) == (4, seq + 1)
    assert torch.equal(a, b)
    assert not torch.equal(a, ds.batch_at(6)["tokens"])
    assert not torch.equal(a, SyntheticLM(V, seq, 4, seed=4)
                           .batch_at(5)["tokens"])
    t = a.long()
    assert int(t.min()) >= 0 and int(t.max()) < V
    # the 8-gram repeats at offsets 4 and 16
    assert torch.equal(t[:, 4:12], t[:, 16:24])
    # the Markov step next = (31 prev + n + 1) mod V, n in [0, 7), at
    # every position whose predecessor and itself lie outside the grams
    spliced = set(range(4, 12)) | set(range(16, 24))
    for j in range(1, seq + 1):
        if j in spliced or j - 1 in spliced:
            continue
        n = (t[:, j] - 31 * t[:, j - 1] - 1) % V
        assert bool(((n >= 0) & (n < 7)).all()), j


def test_make_batch_for_adds_the_frontends():
    for arch, key in (("paligemma_3b", "patches"),
                      ("seamless_m4t_large_v2", "frames")):
        cfg = tconfigs.reduced(arch)
        b1 = make_batch_for(cfg, 16, 2, step=3, seed=1)
        b2 = make_batch_for(cfg, 16, 2, step=3, seed=1)
        jb = jbatch(jconfigs.reduced(arch), 16, 2, 3, 1)
        assert set(b1) == set(jb) == {"tokens", key}
        assert tuple(b1[key].shape) == jb[key].shape
        assert str(b1[key].dtype).split(".")[-1] == str(jb[key].dtype)
        assert torch.equal(b1[key], b2[key])
        assert 0.01 < float(b1[key].float().std()) < 0.03


def test_pipeline_order_and_skip_to():
    pipe = PrefetchPipeline(lambda s: {"step": s}, start_step=3, depth=2)
    try:
        got = [pipe.get() for _ in range(3)]
        assert [s for s, _ in got] == [3, 4, 5]
        assert all(b["step"] == s for s, b in got)
        pipe.skip_to(20)
        # at most `depth` + 1 old items were in flight
        seen = []
        for _ in range(8):
            s, b = pipe.get()
            assert b["step"] == s
            seen.append(s)
            if s >= 20:
                break
        assert seen[-1] == 20
        assert [pipe.get()[0] for _ in range(2)] == [21, 22]
    finally:
        pipe.close()


def test_pipeline_surfaces_producer_errors():
    def bad(step):
        raise ValueError(f"no batch {step}")

    pipe = PrefetchPipeline(bad)
    try:
        with pytest.raises(ValueError, match="no batch 0"):
            pipe.get()
    finally:
        pipe.close()


def test_straggler_watchdog_flags_as_the_reference():
    dogs = [tfault.StragglerWatchdog(threshold=2.0, warmup_steps=0),
            jfault.StragglerWatchdog(threshold=2.0, warmup_steps=0)]
    times = [0.1] * 8 + [0.5, 0.1, 0.3, 0.1]
    for dog in dogs:
        reps = [dog.observe(s, t) for s, t in enumerate(times)]
        assert reps[8] is not None and reps[8].ratio > 2
        assert reps[9] is None
    assert [dataclasses.astuple(r) for r in dogs[0].flagged] == \
        [dataclasses.astuple(r) for r in dogs[1].flagged]
    assert dogs[0].ewma == dogs[1].ewma
    assert abs(dogs[0].ewma - 0.1) < 0.02
    dog = tfault.StragglerWatchdog()
    dog.start_step()
    assert dog.end_step(0) is None
    with pytest.raises(RuntimeError, match="start_step"):
        dog.end_step(1)


def test_restart_policy_backoff():
    pol = tfault.RestartPolicy(max_restarts=2, backoff_s=0.0)
    assert pol.should_restart(RuntimeError("x"))
    assert pol.should_restart(RuntimeError("x"))
    assert not pol.should_restart(RuntimeError("x"))
    assert pol.restarts == 2


# --------------------------------------------------- launcher, example
def test_launcher_runs_and_resumes(tmp_path, capsys):
    from repro_torch.launch import train as launch

    args = ["--arch", "smollm_360m", "--reduced", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "3", "--log-every", "1"]
    losses = launch.main(args + ["--steps", "6"])
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["step_00000003", "step_00000006"]
    again = launch.main(args + ["--steps", "8", "--resume"])
    assert "resumed from step 6" in capsys.readouterr().out
    assert len(again) == 2 and all(np.isfinite(again))


def test_launcher_steps_are_deterministic(tmp_path, monkeypatch):
    """The launcher runs its steps under deterministic algorithms (and
    restores the caller's setting after) and sets cuBLAS's workspace
    config unless the caller did."""
    from repro_torch.launch import train as launch

    seen = []
    make = ttrain.make_bundle

    def spy(cfg, tcfg, **kw):
        bundle = make(cfg, tcfg, **kw)
        step = bundle.step_fn

        def step_fn(state, batch):
            seen.append(torch.are_deterministic_algorithms_enabled())
            return step(state, batch)

        bundle.step_fn = step_fn
        return bundle

    monkeypatch.setattr(ttrain, "make_bundle", spy)
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    args = ["--arch", "smollm_360m", "--reduced", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--steps", "2"]
    assert not torch.are_deterministic_algorithms_enabled()
    launch.main(args)
    assert seen == [True] * 2
    assert not torch.are_deterministic_algorithms_enabled()
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":16:8")
    launch.main(args + ["--ckpt-dir", str(tmp_path / "b")])
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":16:8"


def test_example_learns_on_the_cpu(tmp_path):
    path = ROOT / "examples" / "train_lm_torch.py"
    spec = importlib.util.spec_from_file_location("train_lm_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    losses = mod.main(["--smoke", "--device", "cpu", "--steps", "12",
                       "--batch", "8", "--seq", "32", "--ckpt-dir",
                       str(tmp_path)])
    assert losses[-1] < losses[0]

"""The port's tiered train step (`repro_torch.runtime.tiering`) against the
reference's `apply_tier_shardings` on a 1x1 smoke mesh, and against the
port's own untiered step.

Gates: the tier `info` dict equal to the reference's key by key (floats
to rel=1e-12) except `host_annotation` and `substrate_mode`, which
depend on the backend (the reference's XLA:CPU probes against the
port's CUDA probes; here "logical-only" and "emulated"), given the
reference's v5e topology as the emulation's base; the set of host
leaves equal to the leaves the reference re-shards to `pinned_host`;
the tiered step bit-equal to the untiered step from the same state and
batch at every step (loss, grad norm, every state leaf), with one
microbatch and with two; the copies per step equal to the step's own
plan (here the plain copy runs: CPU tensors); the host leaves rewritten
in place (donated) between steps."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.common.config import ShapeConfig as JShapeConfig  # noqa: E402
from repro.common.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.core import tiers as jtiers  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch.mesh import ctx_for_mesh, make_smoke_mesh  # noqa: E402
from repro.runtime import sharding as jshd  # noqa: E402
from repro.runtime import tiering as jtiering  # noqa: E402
from repro.runtime import train as jtrain  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.common.config import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.common.pytree import named_leaves  # noqa: E402
from repro_torch.core import access as tacc  # noqa: E402
from repro_torch.core import tiers as ttiers  # noqa: E402
from repro_torch.data.synthetic import make_batch_for  # noqa: E402
from repro_torch.runtime import tiering  # noqa: E402
from repro_torch.runtime import train as ttrain  # noqa: E402

BACKEND_KEYS = ("host_annotation", "substrate_mode")
POLICIES = ["hotness", "first_touch", "balanced_bw", "capacity"]


def _ref_topology():
    jt = jtiers.v5e_topology()
    return ttiers.TierTopology(
        tiers=tuple(ttiers.TierSpec(**dataclasses.asdict(t))
                    for t in jt.tiers),
        shared_link_bw=jt.shared_link_bw,
        chips_per_pool=jt.chips_per_pool)


def _close(a, b):
    if isinstance(b, dict):
        assert set(a) == set(b)
        for k in b:
            _close(a[k], b[k])
    elif isinstance(b, (bool, str, np.bool_)) or b is None:
        assert a == b
    else:
        assert a == pytest.approx(b, rel=1e-12, abs=1e-300)


def _reference(arch, shape, policy, frac):
    cfg = jconfigs.reduced(arch)
    mesh = make_smoke_mesh()
    ctx = ctx_for_mesh(mesh, fsdp=False, remat="block")
    rules = jshd.ShardingRules.for_training(fsdp_axis=ctx.fsdp_axis,
                                            tp_axis=ctx.tp_axis)
    tcfg = JTrainConfig(microbatches=1)
    batch = jspecs.train_batch_specs(cfg, shape)
    bundle = jtrain.make_bundle(cfg, ctx, tcfg, rules, mesh, batch)
    _, new, info = jtiering.apply_tier_shardings(
        cfg, ctx, tcfg, rules, mesh, batch, bundle, shape, policy=policy,
        pool_fraction=frac)
    host = {n for n, sh in jtiering.named_leaves(new.state_shardings)
            if getattr(sh, "memory_kind", None) == "pinned_host"}
    return info, host


@pytest.mark.parametrize("frac", [0.25, 0.5, 0.75])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ["smollm_360m", "granite_moe_1b_a400m"])
def test_tier_info_matches_reference(arch, policy, frac):
    jshape = JShapeConfig("t", 32, 2, "train")
    tshape = ShapeConfig("t", 32, 2, "train")
    jinfo, jhost = _reference(arch, jshape, policy, frac)
    cfg = tconfigs.reduced(arch)
    tcfg = TrainConfig()
    with pytest.MonkeyPatch.context() as mp:
        # the emulation's base topology the reference's v5e one
        mp.setattr(ttiers, "h100_topology", _ref_topology)
        _, bundle, info = tiering.apply_tier_shardings(
            cfg, tcfg, ttrain.make_bundle(cfg, tcfg), tshape,
            policy=policy, pool_fraction=frac, device="cpu")
    _close({k: v for k, v in info.items() if k in jinfo
            and k not in BACKEND_KEYS},
           {k: v for k, v in jinfo.items() if k not in BACKEND_KEYS})
    assert info["host_annotation"] == "logical-only"
    assert info["substrate_mode"] == "emulated"
    if jinfo["host_annotation"] != "logical-only":
        # the reference's backend placed host inputs (XLA:CPU does)
        assert set(bundle.step_fn.host_names) == jhost
    assert len(bundle.step_fn.host_names) == info["n_pool_tensors"]
    assert info["copy_launches_per_step"] == 2 * len(bundle.step_fn.plan)


def test_per_device_profile_is_the_train_profile():
    cfg = tconfigs.reduced("smollm_360m")
    st = ttrain.abstract_train_state(cfg)
    shape = ShapeConfig("t", 32, 2, "train")
    assert set(tiering.shard_counts(st).values()) == {1}
    assert tiering.per_device_profile(st, cfg, shape, "block") == \
        tacc.train_profile(st, cfg, shape, "block")


def _states_equal(a, b):
    la, lb = named_leaves(a), named_leaves(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    return [n for (n, x), (_, y) in zip(la, lb) if not torch.equal(x, y)]


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("arch", ["smollm_360m", "mamba2_780m",
                                  "granite_moe_1b_a400m"])
def test_tiered_step_bit_equal_to_untiered(arch, mb):
    cfg = tconfigs.reduced(arch)
    tcfg = TrainConfig(learning_rate=1e-3, total_steps=12, warmup_steps=2,
                       microbatches=mb)
    bundle = ttrain.make_bundle(cfg, tcfg)
    shape = ShapeConfig("t", 16, 4, "train")
    _, tb, info = tiering.apply_tier_shardings(
        cfg, tcfg, bundle, shape, policy="hotness", pool_fraction=0.5,
        device="cpu")
    host = tb.step_fn.host_names
    assert 0 < len(host) == info["n_pool_tensors"]
    plain = ttrain.init_train_state(cfg, device="cpu", seed=3)
    tiered = tiering.place_state(
        ttrain.init_train_state(cfg, device="cpu", seed=3), host, pin=False)
    held = {n: x for n, x in named_leaves(tiered) if n in host}
    for s in range(3):
        batch = make_batch_for(cfg, 16, 4, s)
        tk.reset_counters()
        plain, pm = bundle.step_fn(plain, batch)
        calls = dict(tk.REFERENCE_CALLS)
        tk.reset_counters()
        tiered, tm = tb.step_fn(tiered, batch)
        assert tk.REFERENCE_CALLS["state_in"] == len(tb.step_fn.plan)
        assert tk.REFERENCE_CALLS["state_out"] == len(tb.step_fn.plan)
        assert sum(tk.LAUNCHES.values()) == 0
        # the body is the untiered step: the same plain calls
        assert {k: v for k, v in tk.REFERENCE_CALLS.items()
                if not k.startswith("state_")} == \
            {k: v for k, v in calls.items() if not k.startswith("state_")}
        assert torch.equal(pm["loss"], tm["loss"])
        assert torch.equal(pm["grad_norm"], tm["grad_norm"])
        assert _states_equal(plain, tiered) == []
        # the host leaves are the same tensors, rewritten in place
        for n, x in named_leaves(tiered):
            if n in host:
                assert x is held[n] and x.device.type == "cpu"


def test_copy_plan_and_pages():
    names = [f"l{i:02d}" for i in range(70)]
    plan = tiering.copy_plan(names)
    assert [len(g) for g in plan] == [32, 32, 6]
    assert sum(plan, []) == names
    small = torch.empty(3, 5, device="meta")
    assert tuple(tiering._pages(small).shape) == (1, 1, 15)
    big = torch.empty(4, 2**28, device="meta")       # 4 GiB of float32
    pages = tiering._pages(big)
    assert tuple(pages.shape) == (1, 4, 2**28)
    assert pages.shape[2] * 4 < 2**31
    with pytest.raises(ValueError, match="2 GiB"):
        tiering._pages(torch.empty(2**31, device="meta", dtype=torch.int8)
                       .view(1, 2**31))
    scalar = torch.empty((), device="meta")
    assert tuple(tiering._pages(scalar).shape) == (1, 1, 1)


def test_tiered_dry_run_counts_the_copies():
    """On meta tensors the tiered step's copies are units of the page
    copy: one in and one out per launch of the plan."""
    from repro_torch.launch import dryrun

    cfg = tconfigs.reduced("smollm_360m")
    shape = ShapeConfig("t", 32, 2, "train")
    mb = TrainConfig().microbatches
    c, _, info, _ = dryrun.cell_cost(cfg, shape, microbatches=mb,
                                     tier_policy="hotness")
    n = info["copy_launches_per_step"] // 2
    assert c.units["state_in"] == c.units["state_out"] == n >= 1
    plain, _, _, _ = dryrun.cell_cost(cfg, shape, microbatches=mb)
    assert c.flops == plain.flops
    assert c.hbm_bytes - plain.hbm_bytes >= 4 * info["pool_leaf_bytes"]

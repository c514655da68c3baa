"""The port's mixture-of-experts layer (`models.moe`) and the MoE archs'
engine against the reference package, float32, on the CPU:

* the ops: `_route` (gates, expert ids, probs), `_expert_ffn` (swiglu and
  gelu), `_aux_loss` and `moe_dense` on reduced kimi-k2 and granite-moe
  with the reference's weights (carried across by `load_numpy_params`),
  and a zero router (every prob equal: the top k are the k lowest
  expert ids, `jax.lax.top_k`'s order);
* `moe_ep` without a mesh equal to `moe_dense`; over a mesh its
  refusals before any collective (the EP runs: test_torch_mesh_moe.py);
* the engine: reduced granite-moe, kimi-k2 and jamba (attention, SSM and
  MoE layers) on fp pools against the JAX engine on the same weights and
  trace: tokens equal, virtual metrics and pager deltas to rel=1e-9.

Tolerances: op outputs atol=rtol=1e-5 (float32, the same products in
another order); ids and the tie case exact."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.common import hw as jhw  # noqa: E402
from repro.common.parallel import ParallelCtx  # noqa: E402
from repro.core import tiers as jtiers  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro.serving import make_scenario as jmake_scenario  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.common import hw as thw  # noqa: E402
from repro_torch.core import tiers as ttiers  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.module import load_numpy_params  # noqa: E402
from repro_torch.serving import EngineConfig  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.serving import make_scenario  # noqa: E402

CTX = ParallelCtx(remat="none")
TOL = dict(atol=1e-5, rtol=1e-5)
MOE_ARCHS = ["kimi_k2_1t_a32b", "granite_moe_1b_a400m"]
ENGINE_ARCHS = ["granite_moe_1b_a400m", "kimi_k2_1t_a32b",
                "jamba_1_5_large_398b"]


def _cfgs(arch, **over):
    jc = dataclasses.replace(jconfigs.reduced(arch), dtype="float32",
                             **over)
    tc = dataclasses.replace(tconfigs.reduced(arch), dtype="float32",
                             **over)
    return jc, tc


def _moe_params(jc, seed=0):
    """The first MoE layer's parameters of the reference's tree, and the
    port's copy of them."""
    jp, _ = JM.init_model(jc, jax.random.PRNGKey(seed))
    pos = next(k for k in jp["blocks"] if "moe" in jp["blocks"][k])
    jw = jax.tree.map(lambda a: a[0], jp["blocks"][pos]["moe"])
    tw = load_numpy_params(jax.tree.map(np.asarray, jw), device="cpu")
    return jw, tw


def _x(jc, shape=(2, 7), seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape + (jc.d_model,)).astype(np.float32)


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else \
        np.asarray(x)


# ----------------------------------------------------------------- ops
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_matches_reference(arch):
    jc, tc = _cfgs(arch)
    jw, tw = _moe_params(jc)
    x = _x(jc, (13,))
    jg, ji, jpr = jmoe._route(jw, jnp.asarray(x), jc)
    tg, ti, tpr = tmoe._route(tw, torch.from_numpy(x), tc)
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    np.testing.assert_allclose(_np(tg), np.asarray(jg), **TOL)
    np.testing.assert_allclose(_np(tpr), np.asarray(jpr), **TOL)
    assert tg.dtype == torch.float32


@pytest.mark.parametrize("act", ["swiglu", "gelu", "geglu"])
def test_expert_ffn_matches_reference(act):
    """swiglu (kimi's), tanh gelu (jax.nn.gelu's default) and geglu."""
    jc, tc = _cfgs("kimi_k2_1t_a32b", act=act)
    jw, tw = _moe_params(jc)
    h = np.random.default_rng(2).standard_normal(
        (jc.num_experts, 5, jc.d_model)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tmoe._expert_ffn(tw, torch.from_numpy(h), tc)),
        np.asarray(jmoe._expert_ffn(jw, jnp.asarray(h), jc)), **TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_aux_loss_matches_reference(arch):
    jc, tc = _cfgs(arch)
    jw, tw = _moe_params(jc)
    x = _x(jc, (11,), seed=3)
    _, ji, jpr = jmoe._route(jw, jnp.asarray(x), jc)
    _, ti, tpr = tmoe._route(tw, torch.from_numpy(x), tc)
    np.testing.assert_allclose(float(tmoe._aux_loss(tpr, ti, tc)),
                               float(jmoe._aux_loss(jpr, ji, jc)), **TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_dense_matches_reference(arch):
    jc, tc = _cfgs(arch)
    jw, tw = _moe_params(jc)
    x = _x(jc)
    jy, jaux = jmoe.moe_dense(jw, jnp.asarray(x), jc)
    ty, taux = tmoe.moe_dense(tw, torch.from_numpy(x), tc)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    y2, aux2 = tmoe.moe_ep(tw, torch.from_numpy(x), tc)
    assert torch.equal(y2, ty) and torch.equal(aux2, taux)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_router_ties_pick_the_lower_expert_ids(arch):
    """A zero router gives every expert the same prob: the reference's
    top_k takes the k lowest ids, each gated 1/k, and so does the port."""
    jc, tc = _cfgs(arch)
    jw, tw = _moe_params(jc)
    jw = dict(jw, router=jnp.zeros_like(jw["router"]))
    tw = dict(tw, router=torch.zeros_like(tw["router"]))
    x = _x(jc, (9,), seed=4)
    jg, ji, _ = jmoe._route(jw, jnp.asarray(x), jc)
    tg, ti, _ = tmoe._route(tw, torch.from_numpy(x), tc)
    k = jc.experts_per_token
    want = np.broadcast_to(np.arange(k), (9, k))
    np.testing.assert_array_equal(np.asarray(ji), want)
    np.testing.assert_array_equal(_np(ti), want)
    np.testing.assert_allclose(_np(tg), np.asarray(jg), **TOL)
    jy, _ = jmoe.moe_dense(jw, jnp.asarray(x[None]), jc)
    ty, _ = tmoe.moe_dense(tw, torch.from_numpy(x[None]), tc)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)


def test_top_k_is_stable_on_ties():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    vals, idx = tmoe.top_k(probs, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_moe_ep_over_a_mesh_waits_for_sharding():
    """`moe_ep` over a mesh runs (`tests/test_torch_mesh_moe.py` holds it
    against the reference's). It still refuses, before any collective,
    an EP axis that does not divide the experts (a stand-in mesh with the
    axis sizes only). Expert weights split on their embed dim (the
    training rules' layout) run: 2 gloo ranks (data 2), the router and
    the experts gathered over `data`, y, aux and every weight's gradient
    of `dev_train_torch.moe_objective` against `moe_dense` on the whole
    weights (1e-5 of each's largest entry)."""
    import pathlib
    import sys
    from types import SimpleNamespace

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                           / "scripts"))
    import dev_train_torch as dtt
    from repro_torch.common.parallel import ParallelCtx as TParallelCtx
    from repro_torch.launch import mesh as tmesh

    _, tc = _cfgs("granite_moe_1b_a400m")
    x = torch.zeros(1, 2, tc.d_model)
    three = TParallelCtx(mesh=SimpleNamespace(shape={"data": 1, "model": 3}),
                         tp_axis="model")
    with pytest.raises(ValueError, match="EP axis"):
        tmoe.moe_ep({}, x, tc, three)

    tc = dataclasses.replace(tc, capacity_factor=8.0)
    rng = np.random.default_rng(5)
    d, E, ff = tc.d_model, tc.num_experts, tc.moe_d_ff
    params = {k: rng.normal(0, d ** -0.5, shape).astype(np.float32)
              for k, shape in (("router", (d, E)), ("w_gate", (E, d, ff)),
                               ("w_up", (E, d, ff)), ("w_down", (E, ff, d)))}
    xs = rng.normal(0, 1, (4, 8, d)).astype(np.float32)
    cot = rng.normal(0, 1, (4, 8, d)).astype(np.float32)
    got = tmesh.run_ranks(dtt.moe_grad_rank, 2,
                          (2, 1, params, xs, cot, tc, "cpu"), device="cpu",
                          threads=1, timeout_s=60, wall_s=300)[0]
    # w_up's embed dim and w_down's ff dim (the first of its dims to ask)
    # over `data`: both ride the gather schedule
    assert got["specs"]["w_up"] == ("model", "data", None)
    assert got["specs"]["w_down"] == ("model", "data", None)
    w = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    xt = torch.tensor(xs, requires_grad=True)
    y, aux = tmoe.moe_dense(w, xt, tc)
    dtt.moe_objective(y, aux, torch.tensor(cot), n_aux=2).backward()
    for name, want, have in [("y", y.detach().numpy(), got["y"]),
                             ("x", xt.grad.numpy(), got["x_grad"])] + [
            (k, w[k].grad.numpy(), got["grads"][k]) for k in params]:
        np.testing.assert_allclose(have, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
    assert abs(got["aux"] - float(aux)) < 1e-6


# -------------------------------------------------------------- engine
def _ref_topology():
    jt = jtiers.v5e_topology()
    return ttiers.TierTopology(
        tiers=tuple(ttiers.TierSpec(**dataclasses.asdict(t))
                    for t in jt.tiers),
        shared_link_bw=jt.shared_link_bw,
        chips_per_pool=jt.chips_per_pool,
    )


def _ref_chip():
    c = jhw.V5E
    return thw.ChipSpec(name=c.name, peak_flops_bf16=c.peak_flops_bf16,
                        hbm_bytes=c.hbm_bytes, hbm_bw=c.hbm_bw,
                        link_bw=c.ici_link_bw, num_sms=0, smem_per_block=0,
                        l2_bytes=0.0)


ENGINE_KW = dict(n_slots=4, max_seq=48, prefill_buckets=(16, 32),
                 page_tokens=8, hot_window=16, local_budget_frac=0.5,
                 pool_dtype="fp", admission="greedy", substrate="off")


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_engine_matches_reference(arch):
    """fp pools, one chat trace, the JAX engine on the same weights:
    tokens equal, virtual metrics and pager deltas to rel=1e-9."""
    jc, tc = _cfgs(arch)
    jp, _ = JM.init_model(jc, jax.random.PRNGKey(0))
    tp = load_numpy_params(jax.tree.map(np.asarray, jp), device="cpu")
    trace = dict(n=8, vocab=jc.vocab_size, seed=3, prompt_buckets=(16, 32),
                 gen_range=(4, 12), arrival_rate=2e5)
    jeng = JServingEngine.build(jc, CTX,
                                JEngineConfig(**ENGINE_KW),
                                params=jp)
    teng = ServingEngine.build(tc, EngineConfig(**ENGINE_KW), params=tp,
                               topo=_ref_topology(), chip=_ref_chip(),
                               device="cpu")
    assert teng.pager.resident_bytes == jeng.pager.resident_bytes
    jreqs = jmake_scenario("chat", **trace)
    treqs = make_scenario("chat", **trace)
    js, ts = jeng.run(jreqs), teng.run(treqs)
    for jr, tr_ in zip(jreqs, treqs):
        assert tr_.output == jr.output, jr.request_id
    jsum, tsum = js.summary(), ts.summary()
    jsum.pop("tok_per_s_wall"), tsum.pop("tok_per_s_wall")
    assert tsum == pytest.approx(jsum, rel=1e-9)
    assert ts.pager == pytest.approx(js.pager, rel=1e-9)
    assert js.max_concurrency > 1

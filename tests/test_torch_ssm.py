"""The port's SSM path (mamba2) against the reference package on the same
weights (carried across by `load_numpy_params`), float32, on the CPU:

* the layer: `ssm_block` (with and without a carried state and conv
  tails) and `ssm_decode_step`, softplus and the causal conv;
* the model: `prefill` logits and every cache leaf, contiguous and paged
  decode steps, for reduced mamba2 and for a hybrid attention + SSM stack
  without experts (reduced jamba with num_experts=0, which the reference
  runs); the state carry of the reference's `test_ssm_state_carry` with
  its `forward` logits as the teacher (the port has no `forward` yet);
  the meta trees of the full config;
* the engine: equal to the naive one-shot loop bit for bit in the paged
  and the contiguous layouts, the int8 pool equal to fp (an SSM-only
  pool holds nothing), and fp tokens, virtual metrics and pager deltas
  equal to the JAX engine's on one trace (rel=1e-9); chunked prefill,
  the prefix cache and speculation refused as in the reference.

Tolerances: layer outputs and logits atol=rtol=1e-4 (float32, products
and sums in another order, the chunked scan against the exact one);
state carry 2e-3 (the reference's own gate); int8 pool payloads equal,
their (scale, zero) rows 1e-4 like the K/V they range over."""

import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.common import hw as jhw  # noqa: E402
from repro.common.parallel import ParallelCtx  # noqa: E402
from repro.common.pytree import named_leaves as jnamed  # noqa: E402
from repro.core import tiers as jtiers  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.runtime import serve as jserve  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro.serving import make_scenario as jmake_scenario  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.common import hw as thw  # noqa: E402
from repro_torch.common.config import ModelConfig  # noqa: E402
from repro_torch.common.pytree import named_leaves as tnamed  # noqa: E402
from repro_torch.core import tiers as ttiers  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.module import load_numpy_params  # noqa: E402
from repro_torch.runtime import serve as tserve  # noqa: E402
from repro_torch.serving import EngineConfig  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.serving import make_scenario  # noqa: E402

CTX = ParallelCtx(remat="none")
TOL = dict(atol=1e-4, rtol=1e-4)
STACKS = ["mamba2", "hybrid"]
_SCRIPT = (pathlib.Path(__file__).resolve().parents[1] / "scripts"
           / "dev_serve_torch.py")


def _dev_serve():
    spec = importlib.util.spec_from_file_location("dev_serve_torch", _SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cfgs(stack="mamba2"):
    """(reference, port) float32 configs: reduced mamba2, or reduced jamba
    without experts (attention every second layer, SSM between)."""
    if stack == "mamba2":
        jc = jconfigs.reduced("mamba2_780m")
    else:
        jc = dataclasses.replace(jconfigs.reduced("jamba_1_5_large_398b"),
                                 num_experts=0)
    jc = dataclasses.replace(jc, dtype="float32")
    return jc, ModelConfig(**dataclasses.asdict(jc))


def _weights(jc):
    jp, _ = JM.init_model(jc, jax.random.PRNGKey(0))
    return jp, load_numpy_params(jax.tree.map(np.asarray, jp), device="cpu")


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else \
        np.asarray(x)


def _close_trees(t, j, **tol):
    """Every leaf of the reference's tree in the port's, within `tol`."""
    got = dict(tnamed(t))
    assert sorted(got) == sorted(n for n, _ in jnamed(j))
    for name, leaf in jnamed(j):
        np.testing.assert_allclose(_np(got[name]), np.asarray(leaf),
                                   err_msg=name, **tol)


def _ssm_params(jp, tp):
    """Layer 0's SSM parameters of both trees."""
    pos = next(k for k in jp["blocks"] if "ssm" in jp["blocks"][k])
    return (jax.tree.map(lambda a: a[0], jp["blocks"][pos]["ssm"]),
            {n: v[0] for n, v in tp["blocks"][pos]["ssm"].items()})


# ---------------------------------------------------------------- layer
def test_config_copies_match_reference():
    assert dataclasses.asdict(tconfigs.get("mamba2_780m")) == \
        dataclasses.asdict(jconfigs.get("mamba2_780m"))
    assert dataclasses.asdict(tconfigs.reduced("mamba2_780m")) == \
        dataclasses.asdict(jconfigs.reduced("mamba2_780m"))
    cfg = tconfigs.get("mamba2_780m")
    assert (cfg.d_inner, cfg.ssm_heads) == (3072, 48)
    assert tssm.NGROUPS == jssm.NGROUPS == 1


def test_softplus_matches_jax():
    """Equal to jax.nn.softplus to one float32 rounding, above torch's
    threshold of 20 too; XLA on the CPU flushes subnormal results to
    zero, hence the absolute slack of the least normal float32."""
    x = np.concatenate([np.linspace(-100, 100, 4001),
                        [-1e-3, 0.0, 1e-3, 19.9, 20.0, 20.1, 30.0]])
    x = x.astype(np.float32)
    got = tssm.softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2e-7,
                               atol=np.finfo(np.float32).tiny)


@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_matches_reference(with_tail):
    rng = np.random.default_rng(int(with_tail))
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    tail = (rng.standard_normal((2, 3, 24)).astype(np.float32)
            if with_tail else None)
    jy, jt = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                               None if tail is None else jnp.asarray(tail))
    ty, tt = tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                               None if tail is None else
                               torch.from_numpy(tail))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("S", [8, 64, 100])
@pytest.mark.parametrize("carried", [False, True])
def test_ssm_block_matches_reference(S, carried):
    """The full-sequence block with its final state and conv tails, from
    zero or from a carried state and tails; S = 100 > 64 takes the
    chunked scan on both sides."""
    jc, tc = _cfgs()
    jp, tp = _ssm_params(*_weights(jc))
    rng = np.random.default_rng(S + carried)
    x = rng.standard_normal((2, S, jc.d_model)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if carried:
        H, P, N = jc.ssm_heads, jc.ssm_head_dim, jc.ssm_state
        st = (rng.standard_normal((2, H, P, N)) * 0.1).astype(np.float32)
        tails = [rng.standard_normal((2, jc.conv_width - 1, c)).astype(
            np.float32) for c in (jc.d_inner, N, N)]
        kw_j = dict(init_state=jnp.asarray(st),
                    conv_tail=tuple(jnp.asarray(t) for t in tails))
        kw_t = dict(init_state=torch.from_numpy(st),
                    conv_tail=tuple(torch.from_numpy(t) for t in tails))
    jout, (jst, jtails) = jssm.ssm_block(jp, jnp.asarray(x), jc,
                                         return_state=True, **kw_j)
    tout, (tst, ttails) = tssm.ssm_block(tp, torch.from_numpy(x), tc,
                                         return_state=True, **kw_t)
    np.testing.assert_allclose(_np(tout), np.asarray(jout), **TOL)
    np.testing.assert_allclose(_np(tst), np.asarray(jst), **TOL)
    assert tst.dtype == torch.float32
    for a, b in zip(ttails, jtails):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)


def test_ssm_decode_step_matches_reference():
    jc, tc = _cfgs()
    jp, tp = _ssm_params(*_weights(jc))
    rng = np.random.default_rng(4)
    H, P, N = jc.ssm_heads, jc.ssm_head_dim, jc.ssm_state
    x = rng.standard_normal((3, 1, jc.d_model)).astype(np.float32)
    st = (rng.standard_normal((3, H, P, N)) * 0.1).astype(np.float32)
    tails = [rng.standard_normal((3, jc.conv_width - 1, c)).astype(
        np.float32) for c in (jc.d_inner, N, N)]
    jout, (jst, jtails) = jssm.ssm_decode_step(
        jp, jnp.asarray(x), jc, jnp.asarray(st),
        tuple(jnp.asarray(t) for t in tails))
    tout, (tst, ttails) = tssm.ssm_decode_step(
        tp, torch.from_numpy(x), tc, torch.from_numpy(st),
        tuple(torch.from_numpy(t) for t in tails))
    np.testing.assert_allclose(_np(tout), np.asarray(jout), **TOL)
    np.testing.assert_allclose(_np(tst), np.asarray(jst), **TOL)
    for a, b in zip(ttails, jtails):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)


# ---------------------------------------------------------------- model
def test_abstract_state_of_full_config_matches_reference():
    """mamba2-780m at published widths: the meta parameter trees (serve
    and master dtype) and decode caches carry the reference's leaf names,
    shapes and dtypes, and allocate nothing."""
    jc, tc = jconfigs.get("mamba2_780m"), tconfigs.get("mamba2_780m")

    def leaves(tree):
        return [(n, tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for n, v in tree]

    for serve_dtype in (True, False):
        jp, _ = jserve.abstract_params(jc, serve_dtype)
        tp = tserve.abstract_params(tc, serve_dtype)
        assert leaves(tnamed(tp)) == leaves(jnamed(jp))
        assert all(v.device.type == "meta" for _, v in tnamed(tp))
    jcache = jserve.abstract_caches(jc, 4, 96)
    tcache = tserve.abstract_caches(tc, 4, 96)
    assert leaves(tnamed(tcache)) == leaves(jnamed(jcache))


@pytest.mark.parametrize("S", [16, 70])
@pytest.mark.parametrize("stack", STACKS)
def test_prefill_matches_reference(stack, S):
    """Logits and every cache leaf (SSM state and tails; K/V of the
    hybrid's attention layers), S = 70 > 64 through the chunked scan."""
    jc, tc = _cfgs(stack)
    jp, tp = _weights(jc)
    toks = np.random.default_rng(S).integers(0, jc.vocab_size,
                                             (2, S)).astype(np.int32)
    jcache, jlog = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jc, CTX,
                              max_seq=S + 4)
    tcache, tlog = TM.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc,
                              max_seq=S + 4)
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **TOL)
    _close_trees(tcache, jcache, **TOL)


@pytest.mark.parametrize("stack", STACKS)
def test_contiguous_decode_steps_match_reference(stack):
    """Prefill, then three scalar-t decode steps on the contiguous
    caches (written in place): logits and every cache leaf."""
    jc, tc = _cfgs(stack)
    jp, tp = _weights(jc)
    rng = np.random.default_rng(5)
    S = 8
    toks = rng.integers(0, jc.vocab_size, (2, S + 3)).astype(np.int32)
    jcache, _ = JM.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])}, jc,
                           CTX, max_seq=16)
    tcache, _ = TM.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S])},
                           tc, max_seq=16)
    for i in range(3):
        jlog, jcache = JM.decode_step(jp, jnp.asarray(toks[:, S + i]),
                                      jcache, S + i, jc, CTX)
        tlog, tcache = TM.decode_step(tp, torch.from_numpy(toks[:, S + i]),
                                      tcache, S + i, tc)
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **TOL)
    _close_trees(tcache, jcache, **TOL)


@pytest.mark.parametrize("pool_dtype", ["fp", "int8"])
@pytest.mark.parametrize("stack", STACKS)
def test_paged_insert_and_decode_match_reference(stack, pool_dtype):
    """Two prefilled prompts land through the paged insert cell (the
    SSM state and tails densely at their slots, K/V through the block
    table), then one decode step with a third slot parked: logits of the
    live slots and every cache leaf against the reference."""
    jc, tc = _cfgs(stack)
    jp, tp = _weights(jc)
    n_slots, max_seq, page, S = 3, 32, 8, 12
    n_pages = max_seq // page
    rng = np.random.default_rng(2)
    perm = rng.permutation(n_slots * n_pages).astype(np.int32)
    bt = np.zeros((n_slots, n_pages), np.int32)
    bt[0, :2] = perm[:2]
    bt[1, :2] = perm[2:4]
    jcaches = JM.make_paged_decode_caches(jc, n_slots, max_seq, page,
                                          pool_dtype=pool_dtype)
    tcaches = TM.make_paged_decode_caches(tc, n_slots, max_seq, page,
                                          pool_dtype=pool_dtype,
                                          device="cpu")
    jins = jserve.build_paged_cache_insert(S, page, pool_dtype)
    tins = tserve.build_paged_cache_insert(S, page, pool_dtype)
    toks = rng.integers(0, jc.vocab_size, (2, S)).astype(np.int32)
    for s in range(2):
        jsc, _ = JM.prefill(jp, {"tokens": jnp.asarray(toks[s:s + 1])}, jc,
                            CTX, max_seq=S)
        tsc, _ = TM.prefill(tp, {"tokens": torch.from_numpy(toks[s:s + 1])},
                            tc, max_seq=S)
        jcaches = jins(jcaches, jsc, np.int32(s), jnp.asarray(bt))
        tins(tcaches, tsc, s, torch.from_numpy(bt))
    _close_trees(tcaches, jcaches, **TOL)
    token = np.array([5, 17, 3], np.int32)
    t = np.array([S, S, n_pages * page], np.int32)      # slot 2 parked
    jlog, jcaches = JM.decode_step(jp, jnp.asarray(token), jcaches,
                                   jnp.asarray(t), jc, CTX,
                                   block_table=jnp.asarray(bt),
                                   page_tokens=page)
    tlog, tcaches = TM.decode_step(tp, torch.from_numpy(token), tcaches,
                                   torch.from_numpy(t), tc,
                                   block_table=torch.from_numpy(bt),
                                   page_tokens=page)
    tol = TOL if pool_dtype == "fp" else dict(atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(_np(tlog)[:2], np.asarray(jlog)[:2], **tol)
    tleaves = dict(tnamed(tcaches))
    for name, leaf in jnamed(jcaches):
        got = _np(tleaves[name])
        if pool_dtype == "int8" and name.split("/")[-1] in ("k", "v"):
            np.testing.assert_array_equal(got, np.asarray(leaf))
        else:
            # (scale, zero) rows are the range of K/V that two frameworks
            # computed, here behind an SSM layer: within the K/V's 1e-4
            np.testing.assert_allclose(got, np.asarray(leaf), **TOL)


@pytest.mark.parametrize("stack", STACKS)
def test_ssm_state_carry(stack):
    """SSM decode state must carry exactly (no attention to fall back
    on): prefill 4 tokens, then decode token by token against the
    reference's teacher-forced `forward` logits, within its 2e-3."""
    jc, tc = _cfgs(stack)
    jp, tp = _weights(jc)
    B, S = 1, 12
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (B, S), 0,
                                         jc.vocab_size)).astype(np.int32)
    full, _ = JM.forward(jp, {"tokens": jnp.asarray(toks)}, jc, CTX)
    caches, _ = TM.prefill(tp, {"tokens": torch.from_numpy(toks[:, :4])},
                           tc, max_seq=S)
    for t in range(4, S - 1):
        logits, caches = TM.decode_step(tp, torch.from_numpy(toks[:, t]),
                                        caches, t, tc)
        err = float(np.abs(_np(logits) - np.asarray(full[:, t])).max())
        assert err < 2e-3, (t, err)


# --------------------------------------------------------------- engine
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


@pytest.mark.parametrize("stack", STACKS)
def test_engine_matches_naive_loop(stack):
    """The port of the reference's `test_engine_matches_naive_loop
    [mamba2_780m]`: batched prefill + scalar-t decode against the engine
    on an all-at-once trace, bit for bit, paged (fp and int8 pools) and
    contiguous; on the SSM-only stack the int8 pool holds nothing, so it
    changes no token. The prompt pass went through the SSD op."""
    dst = _dev_serve()
    jc, tc = _cfgs(stack)
    _, tp = _weights(jc)
    B, S, GEN = 2, 8, 6
    prompts = np.array(jax.random.randint(jax.random.PRNGKey(1), (B, S),
                                          0, tc.vocab_size))
    naive = dst.naive_greedy(tc, tp, prompts, GEN, max_seq=S + GEN,
                             device="cpu")
    runs = [("paged fp", dict(paged=True)),
            ("contiguous", dict(paged=False))]
    if stack == "mamba2":
        runs.append(("paged int8", dict(paged=True, pool_dtype="int8")))
    for label, kw in runs:
        kernels.reset_counters()
        got, _, eng = dst.engine_greedy(tc, tp, prompts, GEN, device="cpu",
                                        **kw)
        np.testing.assert_array_equal(got, naive, err_msg=label)
        assert kernels.REFERENCE_CALLS["ssd"] == B * tc.num_layers // (
            1 if stack == "mamba2" else 2), label
    assert eng.pager.resident_bytes > 0


@pytest.mark.parametrize("pool_dtype", ["fp", "int8"])
def test_engine_matches_reference(pool_dtype):
    """fp and int8 engines over one chat trace against the JAX engine on
    the same weights: tokens equal (the int8 pool of an SSM-only stack
    holds nothing), virtual metrics and pager deltas to rel=1e-9, and the
    resident state priced alike."""
    jc, tc = _cfgs()
    jp, tp = _weights(jc)
    kw = dict(n_slots=4, max_seq=48, prefill_buckets=(16, 32),
              page_tokens=8, hot_window=16, local_budget_frac=0.5,
              pool_dtype=pool_dtype, admission="greedy")
    trace = dict(n=8, vocab=jc.vocab_size, seed=3, prompt_buckets=(16, 32),
                 gen_range=(4, 12), arrival_rate=2e5)
    jeng = JServingEngine.build(jc, CTX, JEngineConfig(substrate="off", **kw),
                                params=jp)
    teng = ServingEngine.build(tc, EngineConfig(**kw), params=tp,
                               topo=_ref_topology(), chip=_ref_chip(),
                               device="cpu")
    assert teng.pager.resident_bytes == jeng.pager.resident_bytes > 0
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


def test_engine_refuses_what_the_reference_refuses():
    """Chunked prefill, the prefix cache and speculation need an
    attention-only stack, as in the reference."""
    _, tc = _cfgs()
    assert not tserve.chunked_prefill_supported(tc)
    for over, match in ((dict(prefill_chunk=16), "chunked prefill"),
                        (dict(speculative="ngram"), "speculative"),
                        (dict(prefix_cache=True), "prefix_cache")):
        ecfg = EngineConfig(prefill_buckets=(16,), **over)
        with pytest.raises(ValueError, match=match):
            ServingEngine.build(tc, ecfg, device="cpu")

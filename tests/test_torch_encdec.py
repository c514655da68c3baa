"""The port's frontend archs against the reference package, float32, on
the CPU, on the same weights (the JAX tree through `load_numpy_params`):
paligemma (256 patch embeddings prepended to the prompt; 8 at reduced
size) and seamless (an encoder over frame embeddings, decoder layers with
cross-attention against the slot-resident encoder K/V).

* `models.frontends`: the embedding shapes, and the port's draw (the
  reference's `fold_in(PRNGKey(17), id)` numbers cannot be reproduced in
  torch: a generator seeded from (17, request_id) instead);
* the cross-attention ops and the encoder stack, and `stack_apply`'s
  MoE aux;
* the paged insert of `bucket + n_prefix` rows (the cross-KV copied per
  slot) and one paged decode step, fp and int8 pools;
* the engine: fp pools against the JAX engine (its embeddings carried
  across by replacing `_frontend_extras` on the port's engine): tokens
  equal, virtual metrics and pager deltas to rel=1e-9; paged and
  contiguous engines against the naive loop bit for bit;
* the reference's refusals: the prefix cache ("token-only"), chunked
  prefill and speculation on frontend archs, several buckets on the
  enc-dec arch, with the reference's messages.

Tolerances: atol=rtol=1e-4 (float32, another summation order); int8
decode logits 1e-3 and int8 payloads exact, as in
`test_torch_model.py`."""

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
from repro.core import tiers as jtiers  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import frontends as jfront  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.runtime import serve as jserve  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro.serving import make_scenario as jmake_scenario  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.common import hw as thw  # noqa: E402
from repro_torch.core import tiers as ttiers  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import frontends as tfront  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.module import load_numpy_params  # noqa: E402
from repro_torch.runtime import serve as tserve  # noqa: E402
from repro_torch.serving import EngineConfig  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.serving import make_scenario  # noqa: E402
from repro_torch.serving.engine import frontend_extras  # noqa: E402

CTX = ParallelCtx(remat="none")
TOL = dict(atol=1e-4, rtol=1e-4)
FRONTEND_ARCHS = ["paligemma_3b", "seamless_m4t_large_v2"]
_SCRIPT = (pathlib.Path(__file__).resolve().parents[1] / "scripts"
           / "dev_serve_torch.py")


def _cfgs(arch):
    jc = dataclasses.replace(jconfigs.reduced(arch), dtype="float32")
    tc = dataclasses.replace(tconfigs.reduced(arch), dtype="float32")
    return jc, tc


_WEIGHTS = {}


def _weights(arch):
    """The reference's PRNGKey(0) tree and the port's copy, built once per
    arch and module."""
    if arch not in _WEIGHTS:
        jc, _ = _cfgs(arch)
        jp, _ = JM.init_model(jc, jax.random.PRNGKey(0))
        _WEIGHTS[arch] = (jp, load_numpy_params(
            jax.tree.map(np.asarray, jp), device="cpu"))
    return _WEIGHTS[arch]


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else \
        np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------------------------------------ frontends
@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_frontend_embed_shape_matches_reference(arch):
    for cfg_of in (lambda m: m.get(arch), lambda m: m.reduced(arch)):
        assert tfront.frontend_embed_shape(cfg_of(tconfigs), 3, 40) == \
            jfront.frontend_embed_shape(cfg_of(jconfigs), 3, 40)


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_synthetic_embeds_are_seeded(arch):
    """Shape and dtype of the reference's draw, scale 0.02, the same
    numbers for the same seed and other numbers for another request."""
    tc = tconfigs.reduced(arch)
    gen = torch.Generator("cpu").manual_seed(5)
    emb = tfront.synthetic_frontend_embeds(tc, 2, 24, gen)
    ref = jfront.synthetic_frontend_embeds(jconfigs.reduced(arch), 2, 24)
    assert tuple(emb.shape) == ref.shape
    assert str(emb.dtype).removeprefix("torch.") == str(ref.dtype)
    assert 0.01 < float(emb.float().std()) < 0.03
    again = tfront.synthetic_frontend_embeds(
        tc, 2, 24, torch.Generator("cpu").manual_seed(5))
    assert torch.equal(emb, again)
    a = frontend_extras(tc, 3, 24, "cpu")
    b = frontend_extras(tc, 3, 24, "cpu")
    c = frontend_extras(tc, 4, 24, "cpu")
    (name, x), = a.items()
    assert name == ("patches" if tc.frontend == "vision_stub" else "frames")
    assert torch.equal(x, b[name]) and not torch.equal(x, c[name])
    assert frontend_extras(tconfigs.reduced("smollm_360m"), 3, 24,
                           "cpu") == {}
    assert tfront.synthetic_frontend_embeds(
        tconfigs.reduced("smollm_360m"), 2, 24) is None


# ------------------------------------------------------- cross / encoder
def _cross_params(jp):
    jw = jax.tree.map(lambda a: a[0], jp["blocks"]["pos0"]["cross"])
    return jw, load_numpy_params(jax.tree.map(np.asarray, jw), device="cpu")


def test_cross_attention_ops_match_reference():
    """`encode_cross_kv`, `cross_attention` (flash, non-causal, Sq != Senc)
    and `decode_cross_attention` (decode op, every row of length Senc)."""
    jc, tc = _cfgs("seamless_m4t_large_v2")
    jp, _ = _weights("seamless_m4t_large_v2")
    jw, tw = _cross_params(jp)
    enc = _rand((2, 11, jc.d_model), 1)
    x = _rand((2, 7, jc.d_model), 2)
    jkv = jattn.encode_cross_kv(jw, jnp.asarray(enc), jc)
    tkv = tattn.encode_cross_kv(tw, torch.from_numpy(enc), tc)
    for a, b in zip(tkv, jkv):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)
    np.testing.assert_allclose(
        _np(tattn.cross_attention(tw, torch.from_numpy(x), tkv, tc)),
        np.asarray(jattn.cross_attention(jw, jnp.asarray(x), jkv, jc)),
        **TOL)
    np.testing.assert_allclose(
        _np(tattn.decode_cross_attention(tw, torch.from_numpy(x[:, :1]),
                                         tkv, tc)),
        np.asarray(jattn.decode_cross_attention(jw, jnp.asarray(x[:, :1]),
                                                jkv, jc)), **TOL)
    jk, jv = jattn.make_kv_cache(jc, 2, 9, 3)
    tk, tv = tattn.make_kv_cache(tc, 2, 9, 3, device="cpu")
    assert tuple(tk.shape) == jk.shape and not tk.any() and not tv.any()


def test_encoder_matches_reference():
    """The non-causal encoder stack and its final norm over the frames."""
    jc, tc = _cfgs("seamless_m4t_large_v2")
    jp, tp = _weights("seamless_m4t_large_v2")
    frames = _rand((2, 10, jc.d_model), 3) * 0.02
    np.testing.assert_allclose(
        _np(TM._encode(tp, torch.from_numpy(frames), tc)),
        np.asarray(JM._encode(jp, jnp.asarray(frames), jc, CTX)), **TOL)


@pytest.mark.parametrize("arch", ["seamless_m4t_large_v2",
                                  "granite_moe_1b_a400m",
                                  "jamba_1_5_large_398b"])
def test_stack_apply_matches_reference(arch):
    """The full-sequence stack: outputs and the summed MoE aux (0 for a
    stack without experts); the enc-dec decoder with cross-attention."""
    jc, tc = _cfgs(arch)
    jp, tp = _weights(arch)
    # inputs at the scale of the token embeddings (0.02 * sqrt(d_model))
    x = _rand((2, 9, jc.d_model), 4) * 0.16
    enc = _rand((2, 6, jc.d_model), 5) * 0.16
    cross = bool(jc.num_encoder_layers)
    jx, jaux = jblocks.stack_apply(
        jp["blocks"], jnp.asarray(x), jc, CTX, cross=cross,
        enc_out=jnp.asarray(enc) if cross else None)
    tx, taux = tblocks.stack_apply(
        tp["blocks"], torch.from_numpy(x), tc, cross=cross,
        enc_out=torch.from_numpy(enc) if cross else None)
    np.testing.assert_allclose(_np(tx), np.asarray(jx), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    assert (float(jaux) > 0) == bool(jc.num_experts)


# ------------------------------------------------------ paged insert
@pytest.mark.parametrize("pool_dtype", ["fp", "int8"])
@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_paged_insert_and_decode_match_reference(arch, pool_dtype):
    """Two prefilled prompts land through the insert cells (`bucket +
    n_prefix` rows, cross-KV per slot), then one paged decode step with a
    third slot parked past the table: logits and every cache leaf."""
    jc, tc = _cfgs(arch)
    jp, tp = _weights(arch)
    S, page, n_slots = 12, 8, 3
    npfx = jc.num_prefix_tokens if jc.frontend == "vision_stub" else 0
    enc_len = S if jc.num_encoder_layers else 0
    max_seq = 32 + npfx
    n_pages = max_seq // page
    rng = np.random.default_rng(2)
    perm = rng.permutation(n_slots * n_pages).astype(np.int32)
    n_used = -(-(S + npfx + 1) // page)
    bt = np.zeros((n_slots, n_pages), np.int32)
    bt[0, :n_used] = perm[:n_used]
    bt[1, :n_used] = perm[n_used:2 * n_used]
    jcaches = JM.make_paged_decode_caches(jc, n_slots, max_seq, page,
                                          enc_len, pool_dtype=pool_dtype)
    tcaches = TM.make_paged_decode_caches(tc, n_slots, max_seq, page,
                                          enc_len, pool_dtype=pool_dtype,
                                          device="cpu")
    jins = jserve.build_paged_cache_insert(S + npfx, page, pool_dtype)
    tins = tserve.build_paged_cache_insert(S + npfx, page, pool_dtype)
    toks = rng.integers(0, jc.vocab_size, (2, S)).astype(np.int32)
    emb = jfront.synthetic_frontend_embeds(jc, 2, S)
    name = "patches" if jc.frontend == "vision_stub" else "frames"
    for s in range(2):
        jb = {"tokens": jnp.asarray(toks[s:s + 1]), name: emb[s:s + 1]}
        tb = {"tokens": torch.from_numpy(toks[s:s + 1]),
              name: _t(emb[s:s + 1])}
        jsc, _ = JM.prefill(jp, jb, jc, CTX, max_seq=S)
        tsc, _ = TM.prefill(tp, tb, tc, max_seq=S)
        jcaches = jins(jcaches, jsc, np.int32(s), jnp.asarray(bt))
        tins(tcaches, tsc, s, torch.from_numpy(bt))
    token = np.array([5, 17, 3], np.int32)
    t = np.array([S + npfx, S + npfx, n_pages * page], np.int32)
    jlog, jcaches = JM.decode_step(jp, jnp.asarray(token), jcaches,
                                   jnp.asarray(t), jc, CTX,
                                   block_table=jnp.asarray(bt),
                                   page_tokens=page)
    tlog, tcaches = TM.decode_step(tp, torch.from_numpy(token), tcaches,
                                   torch.from_numpy(t), tc,
                                   block_table=torch.from_numpy(bt),
                                   page_tokens=page)
    tol = 1e-4 if pool_dtype == "fp" else 1e-3
    np.testing.assert_allclose(_np(tlog)[:2], np.asarray(jlog)[:2],
                               atol=tol, rtol=tol)
    for key in jcaches["pos0"]:
        a, b = _np(tcaches["pos0"][key]), np.asarray(jcaches["pos0"][key])
        if key.startswith("cross"):
            a, b = a[:, :2], b[:, :2]          # slot 2 never admitted
        if pool_dtype == "int8" and key in ("k", "v"):
            np.testing.assert_array_equal(a, b)
        elif key.endswith("_sz"):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)
        else:
            np.testing.assert_allclose(a, b, err_msg=key, **TOL)


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


def _buckets(jc):
    return (32,) if jc.num_encoder_layers else (16, 32)


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_engine_matches_reference(arch):
    """fp pools, one chat trace, the JAX engine on the same weights and
    the same frontend embeddings: tokens equal, virtual metrics and pager
    deltas to rel=1e-9, the slot-resident cross-KV priced alike."""
    jc, tc = _cfgs(arch)
    jp, tp = _weights(arch)
    kw = dict(n_slots=4, max_seq=48, prefill_buckets=_buckets(jc),
              page_tokens=8, hot_window=16, local_budget_frac=0.5,
              pool_dtype="fp", admission="greedy", substrate="off")
    trace = dict(n=8, vocab=jc.vocab_size, seed=3,
                 prompt_buckets=_buckets(jc), gen_range=(4, 12),
                 arrival_rate=2e5)
    jeng = JServingEngine.build(jc, CTX, JEngineConfig(**kw), params=jp)
    teng = ServingEngine.build(tc, EngineConfig(**kw), params=tp,
                               topo=_ref_topology(), chip=_ref_chip(),
                               device="cpu")
    drawn = []

    def jax_embeds(req, bucket):
        drawn.append(req.request_id)
        return {k: _t(v) for k, v in
                jeng._frontend_extras(req, bucket).items()}

    teng._frontend_extras = jax_embeds
    assert teng.npfx == jeng.npfx
    assert teng.pager.resident_bytes == jeng.pager.resident_bytes
    assert (teng.pager.resident_bytes > 0) == bool(jc.num_encoder_layers)
    jreqs = jmake_scenario("chat", **trace)
    treqs = make_scenario("chat", **trace)
    js, ts = jeng.run(jreqs), teng.run(treqs)
    assert sorted(drawn) == list(range(len(treqs)))
    for jr, tr_ in zip(jreqs, treqs):
        assert tr_.output == jr.output, jr.request_id
    jsum, tsum = js.summary(), ts.summary()
    jsum.pop("tok_per_s_wall"), tsum.pop("tok_per_s_wall")
    assert tsum == pytest.approx(jsum, rel=1e-9)
    assert ts.pager == pytest.approx(js.pager, rel=1e-9)
    assert js.max_concurrency > 1


@pytest.mark.parametrize("each", [False, True])
@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_engine_matches_naive_loop(arch, each):
    """The engine's own embeddings (`frontend_extras`) fed to the naive
    loop, its prefill batched or of each prompt alone (as the card's
    archs phase gates it): paged fp, paged int8 (tokens of the int8 pool
    need not match; it must serve) and contiguous engines; fp layouts bit
    for bit."""
    spec = importlib.util.spec_from_file_location("dev_serve_torch", _SCRIPT)
    dst = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(dst)
    _, tc = _cfgs(arch)
    _, tp = _weights(arch)
    prompts = np.random.default_rng(4).integers(0, tc.vocab_size, (3, 8))
    naive = dst.naive_greedy(tc, tp, prompts, 6, max_seq=14, device="cpu",
                             each=each)
    for kw in (dict(paged=True), dict(paged=False)):
        got, _, _ = dst.engine_greedy(tc, tp, prompts, 6, device="cpu", **kw)
        np.testing.assert_array_equal(got, naive, err_msg=str(kw))
    got, stats, _ = dst.engine_greedy(tc, tp, prompts, 6, paged=True,
                                      pool_dtype="int8", device="cpu")
    assert got.shape == naive.shape and stats.n_requests == 3


# ------------------------------------------------------------- refusals
def _message(build):
    with pytest.raises(ValueError) as info:
        build()
    return str(info.value)


@pytest.mark.parametrize("arch,over", [
    ("paligemma_3b", dict(prefix_cache=True)),
    ("seamless_m4t_large_v2", dict(prefix_cache=True)),
    ("paligemma_3b", dict(prefill_chunk=16)),
    ("seamless_m4t_large_v2", dict(prefill_chunk=16)),
    ("paligemma_3b", dict(speculative="ngram")),
    ("seamless_m4t_large_v2", dict(speculative="draft")),
    ("seamless_m4t_large_v2", dict(prefill_buckets=(16, 32))),
])
def test_engine_refuses_what_the_reference_refuses(arch, over):
    jc, tc = _cfgs(arch)
    kw = dict(n_slots=2, max_seq=48, prefill_buckets=(16,), page_tokens=8)
    kw.update(over)
    want = _message(lambda: JServingEngine.build(jc, CTX,
                                                 JEngineConfig(**kw)))
    got = _message(lambda: ServingEngine.build(tc, EngineConfig(**kw),
                                               device="cpu"))
    assert got == want
    if "prefix_cache" in over:
        assert "token-only" in got

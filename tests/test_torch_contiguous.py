"""The port's contiguous cache layout against the reference package on
the CPU: the flash-decode op's plain version, the contiguous decode
attention and cache insert, the model's decode step on contiguous
caches, the `paged=False` engine, and the engine (paged and contiguous)
against the port's own naive one-shot loop
(`scripts/dev_serve_torch.py`). Reduced smollm, float32; the JAX side
runs its Pallas kernel in interpret mode where one is named.

Gates: decode outputs atol=rtol=1e-5 (float32, sums in another order),
logits 1e-4; `_cache_insert` exactly equal; in decode attention the
written rows within 1e-5 (projected by two frameworks) and every other
row, parked ones included, untouched exactly; fp
engine tokens identical to the JAX engine's with the virtual metrics and
pager deltas equal to rel=1e-9; engine == naive loop bit for bit."""

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
from repro.kernels.decode_attention import ref as jdref  # noqa: E402
from repro.kernels.decode_attention.decode_attention import (  # noqa: E402
    flash_decode as jflash_decode,
)
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro.serving import make_scenario as jmake_scenario  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.common import hw as thw  # noqa: E402
from repro_torch.core import tiers as ttiers  # noqa: E402
from repro_torch.kernels.decode_attention import ops as tdops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.module import load_numpy_params  # noqa: E402
from repro_torch.serving import EngineConfig  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.serving import make_scenario  # noqa: E402

CTX = ParallelCtx(remat="none")
TOL = dict(atol=1e-5, rtol=1e-5)
_SCRIPT = (pathlib.Path(__file__).resolve().parents[1] / "scripts"
           / "dev_serve_torch.py")


def _dev_serve():
    spec = importlib.util.spec_from_file_location("dev_serve_torch", _SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cfgs():
    jc = dataclasses.replace(jconfigs.reduced("smollm_360m"),
                             dtype="float32")
    tc = dataclasses.replace(tconfigs.reduced("smollm_360m"),
                             dtype="float32")
    return jc, tc


def _params(jc):
    jparams, _ = JM.init_model(jc, jax.random.PRNGKey(0))
    return jparams, load_numpy_params(jax.tree.map(np.asarray, jparams),
                                      device="cpu")


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


# ------------------------------------------------------- flash_decode
@pytest.mark.parametrize("D", [16, 20])
@pytest.mark.parametrize("rep", [1, 3])
@pytest.mark.parametrize("S", [40, 64])
def test_decode_mha_matches_flash_decode(D, rep, S):
    """The op's plain version (what CPU tensors take) against the Pallas
    flash_decode in interpret mode and the reference's oracle; S = 40 is
    not a multiple of the kernel's 32-key tile; lengths 1, S // 2, S and
    S + 1 (a parked row reads the whole cache)."""
    rng = np.random.default_rng(D * 100 + rep * 10 + S)
    B, KV = 4, 2
    q = rng.standard_normal((B, KV * rep, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    lengths = np.array([1, S // 2, S, S + 1], np.int32)
    pallas = jflash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(lengths), interpret=True)
    oracle = jdref.decode_mha(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), jnp.asarray(lengths))
    tk.reset_counters()
    got = tdops.decode_mha(*(torch.from_numpy(x) for x in (q, k, v)),
                           torch.from_numpy(lengths))
    assert tk.REFERENCE_CALLS["decode_mha"] == 1
    assert tk.LAUNCHES["flash_decode"] == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)


def test_decode_mha_scalar_length_and_cuda_request():
    """A scalar length broadcasts over the batch; asking for the kernel
    on CPU tensors raises (no fallback)."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((2, 3, 20)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 9, 1, 20)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 9, 1, 20)).astype(
        np.float32))
    a = tdops.decode_mha(q, k, v, 5)
    b = tdops.decode_mha(q, k, v, torch.tensor([5, 5], dtype=torch.int32))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        tdops.decode_mha(q, k, v, 5, impl="cuda")


# ------------------------------------------------- attention and insert
@pytest.mark.parametrize("t_kind", ["vector", "scalar", "parked"])
def test_decode_self_attention_matches_reference(t_kind):
    """Contiguous decode attention: the new K/V lands at position t (per
    slot), the output and the written rows match the reference, every
    other row stays as it was, and parked positions (t >= S) write
    nothing."""
    jc, tc = _cfgs()
    jparams, tparams = _params(jc)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["pos0"]["attn"])
    tp = {n: v[0] for n, v in tparams["blocks"]["pos0"]["attn"].items()}
    rng = np.random.default_rng(5)
    B, S = 3, 12
    KV, hd = jc.num_kv_heads, jc.head_dim
    x = rng.standard_normal((B, 1, jc.d_model)).astype(np.float32)
    kc = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    vc = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    t = {"vector": np.array([0, 5, 11], np.int32), "scalar": np.int32(7),
         "parked": np.array([4, S, S + 3], np.int32)}[t_kind]
    jout, (jk, jv) = jattn.decode_self_attention(
        jp, jnp.asarray(x), jc, jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(t))
    tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    tout, (tk_, tv_) = tattn.decode_self_attention(
        tp, torch.from_numpy(x), tc, tkc, tvc, torch.from_numpy(np.asarray(t)))
    assert tk_ is tkc and tv_ is tvc          # written in place
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    # the written rows hold projected K/V (computed by two frameworks,
    # so equal to rounding); every other row is untouched, exactly
    t_vec = np.broadcast_to(np.asarray(t), (B,))
    written = np.arange(S)[None, :] == t_vec[:, None]
    for got, want, before in ((tkc, jk, kc), (tvc, jv, vc)):
        got, want = got.numpy(), np.asarray(want)
        np.testing.assert_allclose(got[written], want[written], **TOL)
        np.testing.assert_array_equal(got[~written], before[~written])
        np.testing.assert_array_equal(want[~written], before[~written])
    if t_kind == "parked":
        assert written[1:].sum() == 0         # t >= S writes nothing


def test_cache_insert_matches_reference():
    rng = np.random.default_rng(2)
    cache = rng.standard_normal((4, 6, 2, 16)).astype(np.float32)
    new = rng.standard_normal((4, 1, 2, 16)).astype(np.float32)
    t = np.array([0, 5, 6, 9], np.int32)
    want = jattn._cache_insert(jnp.asarray(cache), jnp.asarray(new),
                               jnp.asarray(t))
    got = torch.from_numpy(cache.copy())
    tattn._cache_insert(got, torch.from_numpy(new), torch.from_numpy(t))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_step_on_contiguous_caches_matches_reference():
    """The model's prefill and three decode steps on contiguous caches
    (per-slot positions): logits and caches against the reference."""
    jc, tc = _cfgs()
    jparams, tparams = _params(jc)
    rng = np.random.default_rng(9)
    B, S, MAXS = 2, 8, 16
    toks = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    jcaches, jlog = JM.prefill(jparams, {"tokens": jnp.asarray(toks)}, jc,
                               CTX, max_seq=MAXS)
    tcaches, tlog = TM.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                               tc, max_seq=MAXS)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4,
                               rtol=1e-4)
    tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
    t = np.array([S, S], np.int32)
    for _ in range(3):
        jlog, jcaches = JM.decode_step(jparams, jnp.asarray(tok), jcaches,
                                       jnp.asarray(t), jc, CTX)
        tlog, tcaches = TM.decode_step(tparams, torch.from_numpy(tok),
                                       tcaches, torch.from_numpy(t), tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=1e-4, rtol=1e-4)
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
        t = t + 1
    for key in ("k", "v"):
        np.testing.assert_allclose(tcaches["pos0"][key].numpy(),
                                   np.asarray(jcaches["pos0"][key]),
                                   atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------- engine
@pytest.mark.parametrize("admission", ["greedy", "loi"])
def test_contiguous_engine_matches_reference(admission):
    """`paged=False` on a chat trace: identical fp tokens, and the
    virtual-clock summary and pager deltas equal the reference's."""
    jc, tc = _cfgs()
    jparams, tparams = _params(jc)
    kw = dict(n_slots=2, max_seq=48, prefill_buckets=(16, 32),
              page_tokens=8, hot_window=16, local_budget_frac=0.5,
              paged=False, pool_dtype="fp", admission=admission)
    trace = dict(n=5, vocab=jc.vocab_size, seed=3, prompt_buckets=(16, 32),
                 gen_range=(4, 12), arrival_rate=2e5)
    jeng = JServingEngine.build(jc, CTX, JEngineConfig(substrate="off", **kw),
                                params=jparams)
    teng = ServingEngine.build(tc, EngineConfig(**kw), params=tparams,
                               topo=_ref_topology(), chip=_ref_chip(),
                               device="cpu")
    assert not teng.cells.paged and teng.caches["pos0"]["k"].dim() == 5
    jreqs = jmake_scenario("chat", **trace)
    treqs = make_scenario("chat", **trace)
    js, ts = jeng.run(jreqs), teng.run(treqs)
    for jr, tr_ in zip(jreqs, treqs):
        assert len(tr_.output) == tr_.max_new_tokens
        assert tr_.output == jr.output, jr.request_id
    jsum, tsum = js.summary(), ts.summary()
    jsum.pop("tok_per_s_wall"), tsum.pop("tok_per_s_wall")
    assert tsum == pytest.approx(jsum, rel=1e-9)
    assert ts.pager == pytest.approx(js.pager, rel=1e-9)
    assert js.max_concurrency > 1


@pytest.mark.parametrize("paged", [True, False])
def test_engine_matches_naive_loop(paged):
    """The engine emits the naive loop's greedy stream (batched prefill,
    scalar-t decode on contiguous caches) bit for bit, in both cache
    layouts."""
    dst = _dev_serve()
    _, tc = _cfgs()
    params = TM.init_model(tc, device="cpu", seed=0)
    prompts = np.random.default_rng(4).integers(0, tc.vocab_size,
                                                (dst.B, dst.S))
    tk.reset_counters()
    naive = dst.naive_greedy(tc, params, prompts, dst.GEN,
                             max_seq=dst.S + dst.GEN, device="cpu")
    assert tk.REFERENCE_CALLS["decode_mha"] == (dst.GEN - 1) * tc.num_layers
    got, stats, eng = dst.engine_greedy(tc, params, prompts, dst.GEN,
                                        paged=paged, device="cpu")
    np.testing.assert_array_equal(got, naive)
    assert eng.cells.paged == paged and stats.n_requests == dst.B
    c = dst.compare(got, naive)
    assert c == dict(min=1.0, mean=1.0, exact=True, first_divergence=None)

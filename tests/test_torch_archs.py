"""Every arch of the port's catalog (`configs.list_archs()`, the
reference's ten) against the reference package, float32, on the CPU, at
reduced size and on the same weights (the JAX tree through
`load_numpy_params`, the `encoder` subtree and the `moe` / `cross` leaves
included):

* the config copies, full and reduced;
* the parameter tree of the port's own seeded init equal to the
  reference's, leaf for leaf, and the meta trees of the full configs
  (parameters and contiguous decode caches, cross-KV of the enc-dec arch
  at its encoder length included);
* `prefill` logits and two contiguous `decode_step` logits; paligemma
  and seamless take the reference's `synthetic_frontend_embeds` (patches,
  frames) as inputs;
* `init_model`, `ServingEngine.build` and `analyze` accept every arch
  without a mesh.

Tolerances: logits atol=rtol=1e-4 (float32, products and sums in another
order through the reduced stacks)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.common.parallel import ParallelCtx  # noqa: E402
from repro.common.pytree import named_leaves as jnamed  # noqa: E402
from repro.models import frontends as jfront  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.runtime import serve as jserve  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.common.pytree import named_leaves as tnamed  # noqa: E402
from repro_torch.core import quantify as tq  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.module import load_numpy_params  # noqa: E402
from repro_torch.runtime import serve as tserve  # noqa: E402
from repro_torch.serving import EngineConfig, ServingEngine  # noqa: E402

CTX = ParallelCtx(remat="none")
TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = tconfigs.list_archs()


def _cfgs(arch):
    jc = dataclasses.replace(jconfigs.reduced(arch), dtype="float32")
    tc = dataclasses.replace(tconfigs.reduced(arch), dtype="float32")
    return jc, tc


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else \
        np.asarray(x)


def _leaves(tree):
    return [(n, tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for n, v in tree]


def test_catalog_is_the_reference_catalog():
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert len(ARCHS) == 10
    assert tconfigs.canonical("kimi-k2-1t-a32b") == "kimi_k2_1t_a32b"


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_match_reference(arch):
    assert dataclasses.asdict(tconfigs.get(arch)) == \
        dataclasses.asdict(jconfigs.get(arch))
    assert dataclasses.asdict(tconfigs.reduced(arch)) == \
        dataclasses.asdict(jconfigs.reduced(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_own_init_has_the_reference_tree(arch):
    """The port's seeded init and the loaded JAX tree: same leaf names,
    shapes and dtypes (encoder, moe and cross leaves included)."""
    jc, tc = _cfgs(arch)
    jp, _ = JM.init_model(jc, jax.random.PRNGKey(0))
    loaded = load_numpy_params(jax.tree.map(np.asarray, jp), device="cpu")
    own = TM.init_model(tc, torch.Generator("cpu").manual_seed(0))
    assert _leaves(tnamed(own)) == _leaves(tnamed(loaded)) == \
        _leaves(jnamed(jp))


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_state_of_full_config_matches_reference(arch):
    """Published widths on the meta device: the parameter tree (serve and
    master dtypes) and the contiguous decode caches, the enc-dec arch's
    cross-KV at an encoder length of 64 included."""
    jc, tc = jconfigs.get(arch), tconfigs.get(arch)
    for serve_dtype in (True, False):
        jp, _ = jserve.abstract_params(jc, serve_dtype)
        tp = tserve.abstract_params(tc, serve_dtype)
        assert _leaves(tnamed(tp)) == _leaves(jnamed(jp))
        assert all(v.device.type == "meta" for _, v in tnamed(tp))
    enc_len = 64 if jc.num_encoder_layers else 0
    jcache = jserve.abstract_caches(jc, 4, 96, enc_len)
    tcache = tserve.abstract_caches(tc, 4, 96, enc_len)
    assert _leaves(tnamed(tcache)) == _leaves(jnamed(jcache))


def _batches(jc, B, S, seed):
    """The same prompt batch for both packages: tokens from numpy, the
    frontend embeddings from the reference's `synthetic_frontend_embeds`."""
    toks = np.random.default_rng(seed).integers(
        0, jc.vocab_size, (B, S)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks)}
    emb = jfront.synthetic_frontend_embeds(jc, B, S)
    if emb is not None:
        name = "patches" if jc.frontend == "vision_stub" else "frames"
        jb[name] = emb
        tb[name] = torch.from_numpy(np.array(emb))
    return jb, tb


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill of 12 tokens (+ the vision prefix / over 12 frames), then
    two decode steps with a scalar position on the contiguous caches."""
    jc, tc = _cfgs(arch)
    jp, _ = JM.init_model(jc, jax.random.PRNGKey(0))
    tp = load_numpy_params(jax.tree.map(np.asarray, jp), device="cpu")
    B, S, max_seq = 2, 12, 16
    jb, tb = _batches(jc, B, S, seed=1)
    jcache, jlog = JM.prefill(jp, jb, jc, CTX, max_seq=max_seq)
    tcache, tlog = TM.prefill(tp, tb, tc, max_seq=max_seq)
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **TOL)
    npfx = jc.num_prefix_tokens if jc.frontend == "vision_stub" else 0
    tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    for step in range(2):
        t = npfx + S + step
        jlog, jcache = JM.decode_step(jp, jnp.asarray(tok), jcache, t, jc,
                                      CTX)
        tlog, tcache = TM.decode_step(tp, torch.from_numpy(tok), tcache, t,
                                      tc)
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **TOL,
                                   err_msg=f"decode step {step}")
        tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_builds_serves_and_analyzes(arch):
    """No arch is refused without a mesh: the seeded init, the engine's
    build (the enc-dec arch with its single bucket) and `analyze` at
    published widths on its H100 defaults."""
    _, tc = _cfgs(arch)
    TM.init_model(tc, device="cpu")
    buckets = (16,) if tc.num_encoder_layers else (16, 32)
    eng = ServingEngine.build(tc, EngineConfig(prefill_buckets=buckets,
                                               max_seq=64),
                              device="cpu")
    assert eng.npfx == (tc.num_prefix_tokens
                        if tc.frontend == "vision_stub" else 0)
    an = tq.analyze(arch, "decode_32k")
    assert an.level1["footprint_bytes_per_chip"] > 0

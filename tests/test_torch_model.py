"""The port's model against the reference model on the same weights
(carried across by `load_numpy_params`): prefill logits and caches, and one
paged decode step on fp and int8 pools, for the four dense attention-only
archs at reduced size in float32; and the meta parameter and cache trees
of the full configs, leaf for leaf.

Tolerances: prefill and fp decode atol=rtol=1e-4 (float32, products and
sums in another order through 2 layers); int8 decode logits 1e-3 (the
dequantized pool carries the same int8 grid, but the requantized tail page
sees the float32 K/V of each framework); int8 pool payloads and (scale,
zero) rows equal to the int8 step / 1e-6."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.common.parallel import ParallelCtx  # noqa: E402
from repro.common.pytree import named_leaves as jnamed  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.runtime import serve as jserve  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.common.pytree import named_leaves as tnamed  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.module import load_numpy_params  # noqa: E402
from repro_torch.runtime import serve as tserve  # noqa: E402

CTX = ParallelCtx(remat="none")
ARCHS = ["smollm_360m", "qwen2_5_32b", "granite_3_2b",
         "mistral_nemo_12b"]


def _cfgs(arch):
    jc = dataclasses.replace(jconfigs.reduced(arch), dtype="float32")
    tc = dataclasses.replace(tconfigs.reduced(arch), dtype="float32")
    return jc, tc


def _weights(jc):
    jp, _ = JM.init_model(jc, jax.random.PRNGKey(0))
    tp = load_numpy_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else \
        np.asarray(x)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_match_reference(arch):
    assert dataclasses.asdict(tconfigs.get(arch)) == \
        dataclasses.asdict(jconfigs.get(arch))
    assert dataclasses.asdict(tconfigs.reduced(arch)) == \
        dataclasses.asdict(jconfigs.reduced(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_loader_keeps_tree_and_shapes(arch):
    jc, tc = _cfgs(arch)
    jp, tp = _weights(jc)
    own = TM.init_model(tc, torch.Generator("cpu").manual_seed(0))
    jflat = {jax.tree_util.keystr(p): v.shape for p, v in
             jax.tree_util.tree_flatten_with_path(jp)[0]}

    def flat(t, pre=""):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{pre}['{k}']"))
            else:
                out[f"{pre}['{k}']"] = tuple(v.shape)
        return out

    assert flat(tp) == {k: tuple(s) for k, s in jflat.items()}
    assert flat(own) == flat(tp)            # seeded init: same tree


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_state_of_full_config_matches_reference(arch):
    """At published widths (mistral-nemo's d_model 5120 against 32 heads
    x 128 = 4096 is a shape no reduced config has), the meta parameter
    tree (serve dtype and master dtype) and decode caches carry the
    reference's leaf names, shapes and dtypes, and allocate nothing."""
    jc, tc = jconfigs.get(arch), tconfigs.get(arch)

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


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    jc, tc = _cfgs(arch)
    jp, tp = _weights(jc)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jc.vocab_size, (2, 16)).astype(np.int32)
    jcache, jlog = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jc, CTX,
                              max_seq=20)
    tcache, tlog = TM.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc,
                              max_seq=20)
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), atol=1e-4,
                               rtol=1e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tcache["pos0"][key]),
                                   np.asarray(jcache["pos0"][key]),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("pool_dtype", ["fp", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_step_matches_reference(arch, pool_dtype):
    """Insert two prefilled prompts into the page pool through the insert
    cell, then one decode step with a third slot parked past the table."""
    jc, tc = _cfgs(arch)
    jp, tp = _weights(jc)
    n_slots, max_seq, page, S = 3, 32, 8, 12
    n_pages = max_seq // page
    rng = np.random.default_rng(2)
    perm = rng.permutation(n_slots * n_pages).astype(np.int32)
    bt = np.zeros((n_slots, n_pages), np.int32)
    bt[0, :2] = perm[:2]                     # pages of slot 0 (12 + 1 tok)
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
    tol = 1e-4 if pool_dtype == "fp" else 1e-3
    np.testing.assert_allclose(_np(tlog)[:2], np.asarray(jlog)[:2],
                               atol=tol, rtol=tol)
    for key in jcaches["pos0"]:
        a, b = _np(tcaches["pos0"][key]), np.asarray(jcaches["pos0"][key])
        if pool_dtype == "int8" and key in ("k", "v"):
            np.testing.assert_array_equal(a, b)
        elif key.endswith("_sz"):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)
        else:
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)

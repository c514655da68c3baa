"""The port's sharding specs against the reference's, without devices:
`runtime.sharding` resolves each leaf from the mesh's axis sizes alone,
and so does the reference's (`_resolve` reads only `mesh.shape`), so a
stand-in whose `shape` maps axis names to sizes serves both, at the
production meshes' 256 and 512 ranks.

* every arch of `list_archs()`: the port's logical-axis tree equals the
  reference's (`init_model` in shape mode), and `pspecs_for_tree` under
  `for_training` and `for_serving` equals the reference's, as tuples, on
  the (2, 4), (16, 16) and (2, 16, 16) meshes;
* `batch_pspec`, `cache_pspec` and `paged_cache_pspec` (per-page and
  per-token int8 scales) on each arch's reduced caches;
* `ctx_for_mesh` field for field on (1, 1), (2, 4) and (2, 2, 4), with
  and without fsdp; the spec type `P` against jax's `PartitionSpec`;
* the mesh builders' refusals without a process group, and a (1, 1)
  mesh a process builds for itself (a one-rank gloo group)."""

import dataclasses
import functools
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.module import ParamSpec, shape_mode  # noqa: E402
from repro.runtime import sharding as jshd  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.common.pytree import named_leaves  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.runtime import serve as tserve  # noqa: E402
from repro_torch.runtime import sharding as tshd  # noqa: E402

MESHES = {"2x4": {"data": 2, "model": 4},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
ARCHS = tconfigs.list_archs()


def _stub(shape: dict):
    """A mesh stand-in for both packages: the reference reads
    `axis_names` and `shape`, the port `shape` (a name -> size map)."""
    return SimpleNamespace(shape=dict(shape), axis_names=tuple(shape))


def _jtree(tree, prefix=""):
    """The reference's tree flattened to {name: leaf} (ParamSpec and
    PartitionSpec leaves kept whole)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_jtree(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    with shape_mode():
        return JM.init_model(jconfigs.get(arch), jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return tserve.abstract_params(tconfigs.get(arch), serve_dtype=False,
                                  with_axes=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_tree_matches_reference(arch):
    jparams, jaxes = _ref_params(arch)
    tparams, taxes = _port_params(arch)
    want = {n: s.axes for n, s in _jtree(jaxes).items()}
    got = dict(named_leaves(taxes))
    assert got == want
    shapes = {n: tuple(v.shape) for n, v in _jtree(jparams).items()}
    assert {n: tuple(v.shape) for n, v in named_leaves(tparams)} == shapes


@pytest.mark.parametrize("rules", ["training", "serving"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_reference(arch, mesh, rules):
    stub = _stub(MESHES[mesh])
    make = {"training": lambda m: m.for_training("data", "model"),
            "serving": lambda m: m.for_serving("data", "model")}[rules]
    jparams, jaxes = _ref_params(arch)
    tparams, taxes = _port_params(arch)
    want = {n: tuple(s) for n, s in _jtree(jshd.pspecs_for_tree(
        jparams, jaxes, make(jshd.ShardingRules), stub)).items()}
    got = {n: tuple(s) for n, s in named_leaves(tshd.pspecs_for_tree(
        tparams, taxes, make(tshd.ShardingRules), stub))}
    assert got == want
    # some leaf is sharded on every mesh under either rule set
    assert any(any(e is not None for e in s) for s in got.values())


def _caches(arch):
    """Each arch's reduced caches, both packages: contiguous (32 slots of
    64 tokens), paged fp, paged int8 per page and per token (8-token
    pages); enc-dec archs with 16 encoder rows."""
    jc, tc = jconfigs.reduced(arch), tconfigs.reduced(arch)
    enc = 16 if jc.num_encoder_layers else 0
    j = {"contig": jax.eval_shape(lambda: JM.make_decode_caches(
        jc, 32, 64, enc))}
    t = {"contig": TM.make_decode_caches(tc, 32, 64, enc, device="meta")}
    for name, pool, gran in (("paged", "fp", "page"),
                             ("page8", "int8", "page"),
                             ("tok8", "int8", "token")):
        j[name] = jax.eval_shape(lambda p=pool, g=gran:
                                 JM.make_paged_decode_caches(
                                     jc, 32, 64, 8, enc, pool_dtype=p,
                                     sz_granularity=g))
        t[name] = TM.make_paged_decode_caches(
            tc, 32, 64, 8, enc, pool_dtype=pool, sz_granularity=gran,
            device="meta")
    return j, t


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_pspecs_match_reference(arch, mesh):
    stub = _stub(MESHES[mesh])
    dp = tuple(a for a in ("pod", "data") if a in MESHES[mesh])
    j, t = _caches(arch)

    def both(fn_j, fn_t, jt, tt):
        want = {n: tuple(s) for n, s in _jtree(fn_j(jt, dp, "model",
                                                    stub)).items()}
        got = {n: tuple(s) for n, s in named_leaves(fn_t(tt, dp, "model",
                                                         stub))}
        assert got == want
        return got

    specs = list(both(jshd.cache_pspec, tshd.cache_pspec, j["contig"],
                      t["contig"]).values())
    for name in ("paged", "page8", "tok8"):
        specs += both(jshd.paged_cache_pspec, tshd.paged_cache_pspec,
                      j[name], t[name]).values()
    assert any(any(e is not None for e in s) for s in specs)
    for B in (32, 3):
        jb = {"tokens": jax.ShapeDtypeStruct((B, 8), "int32")}
        tb = {"tokens": torch.empty(B, 8, device="meta")}
        want = {k: tuple(v) for k, v in jshd.batch_pspec(jb, dp,
                                                         stub).items()}
        assert {k: tuple(v) for k, v in tshd.batch_pspec(
            tb, dp, stub).items()} == want


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("shape", [{"data": 1, "model": 1},
                                   {"data": 2, "model": 4},
                                   {"pod": 2, "data": 2, "model": 4}])
def test_ctx_for_mesh_matches_reference(shape, fsdp):
    stub = _stub(shape)
    j = jmesh.ctx_for_mesh(stub, fsdp=fsdp, remat="none")
    t = tmesh.ctx_for_mesh(stub, fsdp=fsdp, remat="none")
    for f in dataclasses.fields(t):
        if f.name != "mesh":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.all_axes == j.all_axes
    assert t.dp_size == j.dp_size
    assert tuple(t.batch_spec()) == tuple(j.batch_spec())
    for a in (*shape, None):
        assert t.axis_size(a) == j.axis_size(a)


def test_spec_type_spells_as_jax():
    for entries in [(), (None,), ("data", None), (("data",), "model"),
                    (("pod", "data"), None, "model"), ((),)]:
        assert tuple(tshd.P(*entries)) == tuple(JP(*entries)), entries
    assert isinstance(tshd.P("data"), tuple)


def test_mesh_builders_need_their_ranks():
    """Without a process group a production mesh or a mesh of more than
    one rank refuses to build; the backend is the device's (nccl on the
    card, gloo on the CPU) or the caller's, never a fallback."""
    assert not torch.distributed.is_initialized()
    for multi in (False, True):
        with pytest.raises(RuntimeError, match="ranks"):
            tmesh.make_production_mesh(multi_pod=multi, device="cpu")
    with pytest.raises(RuntimeError, match="ranks"):
        tmesh.make_smoke_mesh((2, 2), device="cpu")
    assert tmesh._backend(torch.device("cpu"), None) == "gloo"
    assert tmesh._backend(torch.device("cuda"), None) == "nccl"
    assert tmesh._backend(torch.device("cpu"), "nccl") == "nccl"


def test_smoke_mesh_builds_its_own_rank():
    """A (1, 1) mesh with no group initialises a one-rank gloo group
    with the mesh's timeout; shard_tree / unshard_tree over it are the
    identity, and `ctx_for_mesh` gives no fsdp axis."""
    mesh = tmesh.make_smoke_mesh(device="cpu", timeout_s=30)
    try:
        assert torch.distributed.get_backend() == "gloo"
        assert tuple(mesh.mesh_dim_names) == ("data", "model")
        ctx = tmesh.ctx_for_mesh(mesh)
        assert ctx.fsdp_axis is None and ctx.tp_axis == "model"
        assert ctx.index("model") == 0 and ctx.batch_rows(8) == (0, 8)
        tree = {"a": torch.arange(12.0).reshape(3, 4)}
        specs = {"a": tshd.P("data", "model")}
        local = tshd.shard_tree(tree, specs, mesh)
        assert torch.equal(local["a"], tree["a"])
        assert torch.equal(tshd.unshard_tree(local, specs, mesh)["a"],
                           tree["a"])
    finally:
        tmesh.close_ranks()
    assert not torch.distributed.is_initialized()


def test_paramspec_axes_are_the_references_tuples():
    """The port keeps plain tuples where the reference wraps them in
    `ParamSpec`; `_resolve` reads them alike."""
    stub = _stub(MESHES["2x4"])
    rules = tshd.ShardingRules.for_serving("data", "model")
    jrules = jshd.ShardingRules.for_serving("data", "model")
    for axes, shape in [(("vocab", "embed"), (49155, 2048)),
                        (("embed", "qheads", "head_dim"), (2048, 32, 64)),
                        (("experts", "embed", "moe_ff"), (32, 1024, 512))]:
        assert tuple(tshd._resolve(axes, shape, rules, stub)) == tuple(
            jshd._resolve(ParamSpec(axes), shape, jrules, stub))

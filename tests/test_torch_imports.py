"""The port stands alone: every `repro_torch` module (the fault layer,
the fleet, the MoE layer, the frontends and the training path included),
the port's dev serving script `scripts/dev_serve_torch.py`, its Fig 11
script `scripts/lbench_torch.py`, the training probes
`scripts/ssd_grad_gap.py` and `scripts/profiler_drops.py`,
`examples/quickstart_torch.py`, `examples/train_lm_torch.py`,
`examples/schedule_jobs_torch.py`, `examples/serve_batch_torch.py` and
`scripts/dryrun_microbatches.py` (the serve launcher, the dry-run, the
cost model, the tiered train step, the parallel context, the mesh and
the sharding rules among the modules) import without JAX
and without the reference package; entry points run on the card unless told otherwise
(and raise here, where there is none); the options the reference refuses
raise its `ValueError`; no library attention kernel, compiler or Triton
is called from the port."""

import dataclasses
import importlib.util
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.common.device import resolve_device  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.runtime import serve as serve_rt  # noqa: E402
from repro_torch.serving import EngineConfig, PagerConfig  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.serving.fleet import FleetConfig, FleetRouter  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
DEV_SERVE = ROOT / "scripts" / "dev_serve_torch.py"
LBENCH = ROOT / "scripts" / "lbench_torch.py"
QUICKSTART = ROOT / "examples" / "quickstart_torch.py"
TRAIN_LM = ROOT / "examples" / "train_lm_torch.py"
SCHEDULE = ROOT / "examples" / "schedule_jobs_torch.py"
SERVE_EX = ROOT / "examples" / "serve_batch_torch.py"
DRYRUN_MB = ROOT / "scripts" / "dryrun_microbatches.py"
PROBES = [ROOT / "scripts" / "ssd_grad_gap.py",
          ROOT / "scripts" / "profiler_drops.py"]

_PROBE = """
import importlib, importlib.util, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
for path in sys.argv[1:]:
    spec = importlib.util.spec_from_file_location("script", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
fleet = {"repro_torch.serving.faults", "repro_torch.serving.fleet",
         "repro_torch.serving.fleet.autoscale",
         "repro_torch.serving.fleet.placement",
         "repro_torch.serving.fleet.roles",
         "repro_torch.serving.fleet.router"}
assert fleet <= set(names), fleet - set(names)
archs = {"repro_torch.models.moe", "repro_torch.models.frontends"}
assert archs <= set(names), archs - set(names)
train = {"repro_torch.optim.adamw", "repro_torch.optim.schedule",
         "repro_torch.data.synthetic", "repro_torch.data.pipeline",
         "repro_torch.checkpoint.manager", "repro_torch.runtime.train",
         "repro_torch.runtime.fault", "repro_torch.launch.train"}
assert train <= set(names), train - set(names)
cases = {"repro_torch.prefetch", "repro_torch.prefetch.engine",
         "repro_torch.prefetch.predictors", "repro_torch.prefetch.static",
         "repro_torch.prefetch.trace", "repro_torch.prefetch.workloads",
         "repro_torch.sched", "repro_torch.sched.cluster",
         "repro_torch.sched.policies", "repro_torch.sched.scheduler",
         "repro_torch.sched.simulator", "repro_torch.sched.workload"}
assert cases <= set(names), cases - set(names)
dry = {"repro_torch.launch.serve", "repro_torch.launch.specs",
       "repro_torch.launch.dryrun", "repro_torch.profiler.cost",
       "repro_torch.profiler.hotspots", "repro_torch.runtime.tiering"}
assert dry <= set(names), dry - set(names)
mesh = {"repro_torch.common.parallel", "repro_torch.launch.mesh",
        "repro_torch.runtime.sharding"}
assert mesh <= set(names), mesh - set(names)
import repro_torch.common.parallel as par
assert par.SINGLE.mesh is None and par.SINGLE.all_axes == ()
"""


def test_port_imports_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE, str(DEV_SERVE),
                          str(LBENCH), str(QUICKSTART), str(TRAIN_LM),
                          str(SCHEDULE), str(SERVE_EX), str(DRYRUN_MB),
                          *map(str, PROBES)],
                         env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 30


def test_port_calls_no_library_kernels():
    banned = ("scaled_dot_product_attention", "torch.compile",
              "import triton", "cpp_extension", "_int_mm")
    for path in [*(SRC / "repro_torch").rglob("*"), DEV_SERVE, LBENCH,
                 QUICKSTART, TRAIN_LM, SCHEDULE, SERVE_EX, DRYRUN_MB,
                 *PROBES]:
        if path.suffix in (".py", ".cu", ".cuh"):
            text = path.read_text()
            for word in banned:
                assert word not in text, (path, word)


def _cfg():
    return dataclasses.replace(configs.reduced("smollm_360m"),
                               dtype="float32")


def _lbench_script():
    spec = importlib.util.spec_from_file_location("lbench_torch", LBENCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("entry", ["engine", "cells", "init", "device",
                                   "lbench", "fleet", "train_launcher",
                                   "train_example", "train_state",
                                   "serve_launcher", "serve_example"])
def test_entry_points_default_to_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "engine":
            ServingEngine.build(_cfg(), EngineConfig())
        elif entry == "cells":
            serve_rt.make_engine_cells(_cfg(), n_slots=2, max_seq=32,
                                       buckets=(16,))
        elif entry == "init":
            M.init_model(_cfg())
        elif entry == "lbench":
            _lbench_script().run(n_elements=128, l2_elements=128)
        elif entry == "fleet":
            FleetRouter.build(_cfg(), EngineConfig(), FleetConfig())
        elif entry == "train_launcher":
            from repro_torch.launch import train as launch

            launch.main(["--arch", "smollm_360m", "--reduced", "--steps",
                         "1"])
        elif entry == "train_example":
            spec = importlib.util.spec_from_file_location("train_lm_torch",
                                                          TRAIN_LM)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            mod.main(["--smoke", "--steps", "1"])
        elif entry == "serve_launcher":
            from repro_torch.launch import serve as launch

            launch.main(["--arch", "smollm_360m", "--reduced"])
        elif entry == "serve_example":
            spec = importlib.util.spec_from_file_location(
                "serve_batch_torch", SERVE_EX)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            mod.main([])
        elif entry == "train_state":
            from repro_torch.runtime import train as train_rt

            train_rt.init_train_state(_cfg())
        else:
            resolve_device()


@pytest.mark.parametrize("override,item", [
    (dict(prefetch="frontier"), "'frontier'"),
    (dict(prefetch="static"), "'static'"),
])
def test_options_outside_the_slice_raise(override, item):
    """The pager's page-in predictors that need a schedule or hints the
    pager does not have raise the reference's `ValueError` (the engine's
    and the pager's config alike)."""
    ecfg = dataclasses.replace(EngineConfig(), **override)
    with pytest.raises(ValueError, match=item):
        ServingEngine.build(_cfg(), ecfg, device="cpu")
    with pytest.raises(ValueError, match=item):
        PagerConfig(**override)


@pytest.mark.parametrize("arch", ["smollm_360m", "granite_3_2b"])
def test_catalog_arch_seeds_the_admission_prior(arch):
    """`catalog_arch` is ported: the engine builds and its admission
    controller starts from the catalog workload's prior on the engine's
    own chip and topology (one H100 by default)."""
    from repro_torch.core import tiers as ttiers
    from repro_torch.serving.engine import AdmissionController

    ecfg = dataclasses.replace(EngineConfig(), catalog_arch=arch)
    eng = ServingEngine.build(_cfg(), ecfg, device="cpu")
    want = AdmissionController.from_catalog(
        ttiers.h100_topology(), arch, ecfg.catalog_shape).per_slot_loi
    assert want > 0.0 and eng.admission.per_slot_loi == want


@pytest.mark.parametrize("override", [dict(prefill_chunk=16),
                                      dict(prefix_cache=True)])
def test_chunked_prefill_and_prefix_cache_build(override):
    """Chunked prefill and the prefix cache are ported: the engine
    builds with them and carries the chunk cell or the trie."""
    ecfg = dataclasses.replace(EngineConfig(prefill_buckets=(32,)),
                               **override)
    eng = ServingEngine.build(_cfg(), ecfg, device="cpu")
    if "prefill_chunk" in override:
        assert eng.cells.chunk_fn is not None and eng.cells.chunk == 16
    else:
        assert eng.prefix_cache is not None
        assert eng.pager.prefix_cache is eng.prefix_cache


def test_contiguous_layout_builds():
    """`paged=False` is ported: the engine builds with contiguous
    (nb, n_slots, max_seq, KV, hd) caches and parks at max_seq."""
    ecfg = EngineConfig(prefill_buckets=(32,), paged=False, pool_dtype="fp")
    eng = ServingEngine.build(_cfg(), ecfg, device="cpu")
    assert not eng.cells.paged and eng.cells.verify_fn is None
    k = eng.caches["pos0"]["k"]
    assert k.shape[1:3] == (ecfg.n_slots, ecfg.max_seq)
    assert eng.batcher.t_vector()[0] == ecfg.max_seq


@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_speculative_decoding_builds(mode):
    """Speculative decoding is ported: the engine builds the verify cell
    (and, for the draft proposer, the draft cell, its seeded weights and
    its contiguous scratch caches of extent max_seq + k), and int8 pools
    switch to per-token sub-scales."""
    ecfg = EngineConfig(prefill_buckets=(32,), speculative=mode)
    eng = ServingEngine.build(_cfg(), ecfg, device="cpu")
    assert eng.cells.verify_fn is not None and eng.cells.spec_k == 4
    assert eng.cells.sz_granularity == "token"
    if mode == "draft":
        assert eng.cells.draft_cfg == _cfg()
        assert eng.draft_caches["pos0"]["k"].shape[2] == ecfg.max_seq + 4
    else:
        assert eng.cells.draft_fn is None and eng.draft_caches is None


@pytest.mark.parametrize("case", ["mamba2_780m", "jamba_1_5_large_398b",
                                  "seamless_m4t_large_v2", "speculative",
                                  "contiguous", "train"])
def test_unported_archs_raise(case):
    """Every arch of the reference's catalog is ported, and an MoE arch's
    expert-parallel layer runs without a mesh as `moe_dense`. The engine
    builds every stack over a mesh since A16d: SSM, hybrid and enc-dec
    stacks on both layouts (the slot-resident leaves' specs those of
    `paged_cache_pspec` / `cache_pspec`: the SSM state's heads and the
    conv tails' channels over `model`, the cross-KV's heads in the pool,
    its encoder positions in the contiguous caches) and speculative
    decoding (the verify cell over the mesh, the draft replicated). The
    train bundle builds every arch over a mesh since A16e. The mesh is a
    stand-in with axis sizes only: the cells and the bundles come before
    any collective."""
    from types import SimpleNamespace

    from repro_torch.common.config import TrainConfig
    from repro_torch.models import moe as moe_mod
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import train as train_rt

    P = shd.P
    assert len(configs.list_archs()) == 10
    configs.get("jamba_1_5_large_398b")
    moe = dataclasses.replace(_cfg(), num_experts=4, experts_per_token=2,
                              moe_d_ff=64)
    params = M.init_model(moe, device="cpu")
    layer = {k: v[0] for k, v in params["blocks"]["pos0"]["moe"].items()}
    x = torch.zeros(1, 2, moe.d_model)
    assert moe_mod.moe_ep(layer, x, moe)[0].shape == x.shape
    stub = SimpleNamespace(shape={"data": 1, "model": 2}, get_group=None)
    kw = dict(n_slots=2, max_seq=16, buckets=(8,), device="cpu", mesh=stub)
    if case == "train":
        for arch in configs.list_archs():
            b = train_rt.make_bundle(configs.reduced(arch), TrainConfig(),
                                     mesh=stub)
            assert b.ctx.mesh is stub and b.ctx.tp_axis == "model"
            assert set(b.batch_pspecs) == set(
                train_rt.batch_keys(configs.reduced(arch)))
        return
    if case == "contiguous":
        cells = serve_rt.make_engine_cells(configs.reduced("smollm_360m"),
                                           paged=False, **kw)
        assert not cells.paged and cells.ctx.mesh is stub
        assert cells.cache_pspecs["pos0"]["k"] == P(
            None, None, "model", None, None)
        return
    if case == "speculative":
        cells = serve_rt.make_engine_cells(
            configs.reduced("smollm_360m"), speculative="ngram",
            pool_dtype="int8", sz_granularity="token", **kw)
        assert cells.verify_fn is not None and cells.spec_k == 4
        assert cells.cache_pspecs["pos0"]["k_sz"] == P(None, None, None,
                                                       None, None)
        return
    cfg = configs.reduced(case)
    enc = 8 if cfg.num_encoder_layers else 0
    for paged in (True, False):
        cells = serve_rt.make_engine_cells(cfg, paged=paged, enc_len=enc,
                                           **kw)
        specs = [c for c in cells.cache_pspecs.values()]
        assert cells.ctx.mesh is stub and cells.paged == paged
        for c in specs:
            if "state" in c:
                assert c["state"] == P(None, None, "model", None, None)
                assert c["tail_x"] == c["tail_B"] == P(None, None, None,
                                                       "model")
            if "cross_k" in c:
                assert c["cross_k"] == (P(None, None, None, "model", None)
                                        if paged else
                                        P(None, None, "model", None, None))
        assert any("state" in c or "cross_k" in c for c in specs)


def test_engine_defaults_match_reference_main_path():
    """`EngineConfig()` is the reference's main path, the substrate on
    "auto" included."""
    e = EngineConfig()
    assert (e.paged, e.pool_dtype, e.page_tokens, e.prefill_chunk,
            e.admission, e.substrate) == (True, "int8", 16, None, "loi",
                                          "auto")

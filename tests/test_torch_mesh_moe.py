"""The port's expert-parallel MoE (`models.moe.moe_ep`) over 4 gloo ranks
on the CPU (a dp2tp2 mesh, EP over `model`) against the reference's
`moe_ep` on a JAX (2, 2) mesh of 4 forced host devices (a subprocess,
`tests/test_multidevice.py`'s pattern), on the same float32 weights and
inputs drawn with numpy: reduced granite-moe with 8 experts, top 2.

* with drops (capacity_factor 1.0: some (token, choice) pairs pass their
  expert's capacity on a rank): y and aux within 1e-5 of the reference's;
* without drops (capacity_factor 8.0, the reference test's): the same,
  and within 1e-4 of `moe_dense` (y relative to its largest entry, aux
  absolute), the reference's own thresholds;
* with the batch split over `data` and the experts' ff dim over `data`
  too (fsdp): the port gathers the ff shards, so it equals the
  reference's "gather" mode; the reference's "rowcol" sums the expert
  outputs of different tokens over `data` there (ROADMAP §C), which the
  last test pins."""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.module import load_numpy_params  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import dev_serve_torch as dst  # noqa: E402

CAPS = {"drops": 1.0, "nodrops": 8.0}

REF_CODE = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro import configs
from repro.common.parallel import ParallelCtx
from repro.models import moe as moe_mod

d = np.load(sys.argv[1])
caps = json.loads(sys.argv[2])
params = {k: jnp.asarray(d[k]) for k in ("router", "w_gate", "w_up", "w_down")}
x = jnp.asarray(d["x"])
mesh = jax.make_mesh((2, 2), ("data", "model"))
out = {}
for name, cap in caps.items():
    cfg = dataclasses.replace(
        configs.reduced("granite_moe_1b_a400m"), num_experts=8,
        experts_per_token=2, capacity_factor=cap, dtype="float32",
        param_dtype="float32")
    cases = {"none": (None, "rowcol"), "gather": ("data", "gather"),
             "rowcol": ("data", "rowcol")}
    for case, (fsdp, mode) in cases.items():
        ctx = ParallelCtx(mesh=mesh, dp_axes=("data",), fsdp_axis=fsdp,
                          tp_axis="model", moe_fsdp_mode=mode)
        y, aux = jax.jit(lambda p, x: moe_mod.moe_ep(p, x, cfg, ctx))(
            params, x)
        out[f"{name}_{case}_y"] = np.asarray(y)
        out[f"{name}_{case}_aux"] = np.asarray(aux)
np.savez(sys.argv[3], **out)
print("REF_OK")
"""


def _cfg(cap):
    return dataclasses.replace(
        tconfigs.reduced("granite_moe_1b_a400m"), num_experts=8,
        experts_per_token=2, capacity_factor=cap, dtype="float32",
        param_dtype="float32")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = _cfg(1.0)
    rng = np.random.default_rng(0)
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    params = {
        "router": rng.normal(0, d ** -0.5, (d, e)),
        "w_gate": rng.normal(0, d ** -0.5, (e, d, ff)),
        "w_up": rng.normal(0, d ** -0.5, (e, d, ff)),
        "w_down": rng.normal(0, ff ** -0.5, (e, ff, d)),
    }
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.normal(0, 1, (4, 8, d)).astype(np.float32)
    tmp = tmp_path_factory.mktemp("moe_ep")
    np.savez(tmp / "in.npz", x=x, **params)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                          " --xla_force_host_platform_device_count=4"))
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_CODE, str(tmp / "in.npz"),
         json.dumps(CAPS), str(tmp / "ref.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    cases = [(_cfg(cap), fsdp, mode) for cap in CAPS.values()
             for fsdp, mode in ((None, "rowcol"), ("data", "rowcol"))]
    got = tmesh.run_ranks(dst.mesh_moe_rank, 4,
                          (2, 2, params, x, cases, "cpu"), device="cpu",
                          threads=1, timeout_s=120, wall_s=300)
    out, err = ref.communicate(timeout=300)
    assert ref.returncode == 0 and "REF_OK" in out, err[-3000:]
    jref = dict(np.load(tmp / "ref.npz"))
    port = {}
    for i, (name, fsdp) in enumerate((n, f) for n in CAPS
                                     for f in ("none", "fsdp")):
        port[f"{name}_{fsdp}"] = [r[i] for r in got]
    tparams = load_numpy_params(params, device="cpu")
    dense = {n: tmoe.moe_dense(tparams, torch.from_numpy(x), _cfg(c))
             for n, c in CAPS.items()}
    return jref, port, dense


def _close(a, b, tol):
    np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


def test_every_rank_returns_the_same_output(runs):
    _, port, _ = runs
    for key, ranks in port.items():
        for r in ranks[1:]:
            np.testing.assert_array_equal(r["y"], ranks[0]["y"], key)
            assert r["aux"] == ranks[0]["aux"], key


def test_moe_ep_with_drops_matches_reference(runs):
    jref, port, _ = runs
    ranks = port["drops_none"]
    assert sum(r["dropped"] for r in ranks) > 0      # the case drops
    _close(ranks[0]["y"], jref["drops_none_y"], 1e-5)
    _close(ranks[0]["aux"], jref["drops_none_aux"], 1e-5)


def test_moe_ep_without_drops_matches_dense_and_reference(runs):
    jref, port, dense = runs
    r = port["nodrops_none"][0]
    assert sum(x["dropped"] for x in port["nodrops_none"]) == 0
    _close(r["y"], jref["nodrops_none_y"], 1e-5)
    _close(r["aux"], jref["nodrops_none_aux"], 1e-5)
    y, aux = (t.numpy() for t in dense["nodrops"])
    assert np.abs(r["y"] - y).max() / np.abs(y).max() < 1e-4
    assert abs(r["aux"] - float(aux)) < 1e-4


def test_moe_ep_fsdp_gathers_ff_shards(runs):
    """Batch over `data` and each expert's ff over `data`: the port's
    rowcol request takes the gather schedule (its tokens differ across
    `data`), equal to the reference's gather mode, with and without
    drops; without drops also to moe_dense."""
    jref, port, dense = runs
    for name in CAPS:
        r = port[f"{name}_fsdp"][0]
        _close(r["y"], jref[f"{name}_gather_y"], 1e-5)
        _close(r["aux"], jref[f"{name}_gather_aux"], 1e-5)
    y = dense["nodrops"][0].numpy()
    got = port["nodrops_fsdp"][0]["y"]
    assert np.abs(got - y).max() / np.abs(y).max() < 1e-4


def test_reference_rowcol_sums_other_ranks_tokens(runs):
    """ROADMAP §C: the reference's rowcol schedule with the batch split
    over the fsdp axis adds the expert outputs of the other data rank's
    tokens (one sum over `data` of partial products of different token
    blocks), so it parts from moe_dense even without drops."""
    jref, _, dense = runs
    y = dense["nodrops"][0].numpy()
    err = np.abs(jref["nodrops_rowcol_y"] - y).max() / np.abs(y).max()
    assert err > 1e-2
    assert np.abs(jref["nodrops_gather_y"] - y).max() / np.abs(y).max() \
        < 1e-4

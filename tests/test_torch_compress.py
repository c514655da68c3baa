"""`repro_torch.optim.compress` against `repro.optim.compress`.

* `quantize`, `dequantize` and `init_error_state` in this process, bit
  for bit (half-to-even rounding at exact halves, the 1e-12 floor of an
  all-zero tensor, a tensor with one large entry);
* `compressed_psum` on 4 gloo ranks (a dp2tp2 mesh,
  `dev_train_torch.compress_rank`) over `data`, `model` and both, each
  rank with its own gradient and error trees, against the reference's
  under `shard_map` on a JAX (2, 2) mesh of forced host devices in a
  subprocess (the pattern of `tests/test_multidevice.py`): every rank's
  mean and new error state bit-equal."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.optim import compress as jcompress  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.optim import compress as tcompress  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import dev_train_torch as dtt  # noqa: E402

AXIS_SETS = [("data",), ("model",), ("data", "model")]
N = 4


def _tree(rng, scale):
    return {"a": (rng.normal(0, scale, (8, 5))).astype(np.float32),
            "b": {"c": (rng.normal(0, scale, (7,))).astype(np.float32)}}


def _inputs():
    rng = np.random.default_rng(0)
    grads = [_tree(rng, 1.0 + r) for r in range(N)]
    errors = [_tree(rng, 1e-3) for _ in range(N)]
    return grads, errors


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree)}


JAX_CODE = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.optim import compress

data = np.load(sys.argv[1], allow_pickle=True)
grads, errors = data["grads"].item(), data["errors"].item()
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}
for i, axes in enumerate([("data",), ("model",), ("data", "model")]):
    def body(g, e, axes=axes):
        g = jax.tree.map(lambda x: x[0], g)
        e = jax.tree.map(lambda x: x[0], e)
        m, ne = compress.compressed_psum(g, e, axes)
        return (jax.tree.map(lambda x: x[None], m),
                jax.tree.map(lambda x: x[None], ne))
    spec = P(("data", "model"))
    f = jax.shard_map(body, mesh=mesh, in_specs=(spec, spec),
                      out_specs=(spec, spec), check_vma=False)
    m, ne = jax.jit(f)(grads, errors)
    for k, v in (("mean", m), ("error", ne)):
        for name, x in (("a", v["a"]), ("b/c", v["b"]["c"])):
            out[f"{i}/{k}/{name}"] = np.asarray(x)
np.savez(sys.argv[2], **out)
print("COMPRESS_OK")
"""


def _stack(trees):
    return {"a": np.stack([t["a"] for t in trees]),
            "b": {"c": np.stack([t["b"]["c"] for t in trees])}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    grads, errors = _inputs()
    tmp = tmp_path_factory.mktemp("compress")
    np.savez(tmp / "in.npz", grads=np.array(_stack(grads), dtype=object),
             errors=np.array(_stack(errors), dtype=object))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                          " --xla_force_host_platform_device_count=4")
               .strip(), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_CODE, str(tmp / "in.npz"),
         str(tmp / "out.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        got = tmesh.run_ranks(dtt.compress_rank, N,
                              (2, 2, grads, errors, AXIS_SETS, "cpu"),
                              device="cpu", threads=1, timeout_s=60,
                              wall_s=300)
    finally:
        out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0 and "COMPRESS_OK" in out, err[-3000:]
    ref = dict(np.load(tmp / "out.npz"))
    return got, ref


@pytest.mark.parametrize("i", range(len(AXIS_SETS)),
                         ids=["+".join(a) for a in AXIS_SETS])
def test_compressed_psum_equals_the_reference_under_shard_map(runs, i):
    got, ref = runs
    for r in range(N):
        for kind in ("mean", "error"):
            for name, x in _flat(got[r][i][kind]).items():
                want = ref[f"{i}/{kind}/{name}"][r]
                assert x.dtype == want.dtype == np.float32
                np.testing.assert_array_equal(
                    x.view(np.uint32), want.view(np.uint32),
                    err_msg=f"rank {r} {kind} {name}")


def _quant_inputs():
    rng = np.random.default_rng(3)
    halves = (np.arange(-10, 11, dtype=np.float32) + 0.5) / 127.0 * 10.0
    halves[0] = -10.0                       # absmax 10: scale 10 / 127
    spike = rng.normal(0, 1e-3, (64,)).astype(np.float32)
    spike[5] = 40.0
    return {"normal": rng.normal(0, 2, (33, 7)).astype(np.float32),
            "halves": halves, "zeros": np.zeros((4, 4), np.float32),
            "spike": spike}


@pytest.mark.parametrize("name", list(_quant_inputs()))
def test_quantize_and_dequantize_bit_equal(name):
    g = _quant_inputs()[name]
    q, scale = tcompress.quantize(torch.from_numpy(g))
    jq, jscale = jcompress.quantize(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert np.float32(scale.item()).view(np.uint32) == \
        np.asarray(jscale).view(np.uint32)
    deq = tcompress.dequantize(q, scale).numpy()
    np.testing.assert_array_equal(
        deq.view(np.uint32),
        np.asarray(jcompress.dequantize(jq, jscale)).view(np.uint32))


def test_init_error_state_matches():
    params = {"w": torch.ones(3, 4, dtype=torch.bfloat16),
              "n": {"s": torch.ones(5)}}
    e = tcompress.init_error_state(params)
    je = jcompress.init_error_state({"w": jnp.ones((3, 4), jnp.bfloat16),
                                     "n": {"s": jnp.ones(5)}})
    for name, x in _flat({k: v for k, v in [("w", e["w"].numpy()),
                                            ("n", {"s": e["n"]["s"]
                                                   .numpy()})]}).items():
        want = _flat(je)[name]
        assert x.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(x, want)

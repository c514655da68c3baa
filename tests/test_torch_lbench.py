"""The port's LBench op against the reference's on the same numpy inputs:
on CPU tensors the port takes its plain version, compared with the Pallas
kernel in interpret mode and with the reference's oracle at rtol = atol =
2e-5 (the reference's own kernel tolerance; float32 chains). The flop and
byte model equal the reference's; the kernel refuses CPU tensors. The
port's Fig 11 script (`scripts/lbench_torch.py`) runs its three panels
on the CPU at a small size."""

import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import interference as jitf  # noqa: E402
from repro.kernels.lbench import ref as jref  # noqa: E402
from repro.kernels.lbench.lbench import lbench_pallas  # noqa: E402
from repro_torch import configs, kernels  # noqa: E402
from repro_torch.core import tiers as ttiers  # noqa: E402
from repro_torch.kernels.lbench import ops as tops  # noqa: E402
from repro_torch.kernels.lbench import ref as tref  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
LBENCH = pathlib.Path(__file__).resolve().parents[1] / "scripts" / \
    "lbench_torch.py"


@pytest.mark.parametrize("n", [512, 4096])
@pytest.mark.parametrize("nflop", [0, 1, 2, 5, 16, 32, 128])
def test_lbench_matches_reference(nflop, n):
    a = np.random.default_rng(n + nflop).standard_normal(n).astype(
        np.float32)
    kernels.reset_counters()
    out = tops.lbench(torch.from_numpy(a), nflop).numpy()
    assert kernels.REFERENCE_CALLS["lbench"] == 1
    assert kernels.LAUNCHES["lbench"] == 0
    np.testing.assert_allclose(
        out, np.asarray(lbench_pallas(jnp.asarray(a), nflop,
                                      interpret=True)), **TOL)
    np.testing.assert_allclose(
        out, np.asarray(jref.lbench(jnp.asarray(a), nflop)), **TOL)


def test_lbench_is_out_of_place_and_keeps_dtype():
    a = torch.linspace(-2.0, 2.0, 257)
    b = a.clone()
    for nflop in (0, 3):
        out = tops.lbench(a, nflop)
        assert out.data_ptr() != a.data_ptr() and out.shape == a.shape
    assert torch.equal(a, b)
    x = np.linspace(-1.5, 1.5, 384, dtype=np.float32)
    bf = tref.lbench(torch.from_numpy(x).to(torch.bfloat16), 6)
    assert bf.dtype == torch.bfloat16
    np.testing.assert_allclose(
        bf.float().numpy(),
        np.asarray(jref.lbench(jnp.asarray(x, jnp.bfloat16), 6),
                   np.float32), rtol=0, atol=0)


@pytest.mark.parametrize("nflop", [0, 1, 2, 5, 17])
def test_lbench_flop_and_byte_model_match_reference(nflop):
    for n in (1, 100, 1 << 28):
        assert tops.flops(n, nflop) == jref.flops(n, nflop)
        assert tops.bytes_moved(n) == jref.bytes_moved(n)
        assert tops.bytes_moved(n, 2) == jref.bytes_moved(n, 2)


def test_lbench_kernel_refuses_cpu_tensors():
    a = torch.zeros(128)
    with pytest.raises(ValueError, match="CUDA"):
        tops.lbench(a, 2, impl="cuda")
    with pytest.raises(ValueError, match="nflop"):
        tops.lbench(a, -1)


def test_fig11_script_panels_on_the_cpu(capsys):
    spec = importlib.util.spec_from_file_location("lbench_torch", LBENCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    kernels.reset_counters()
    rows = mod.run(device="cpu", n_elements=4096, l2_elements=512,
                   repeats=1)
    left = [r for r in rows if r["panel"] == "left"]
    assert [r["nflop"] for r in left] == 2 * list(mod.LEFT_NFLOPS)
    assert [r["elements"] for r in left] == [4096] * 6 + [512] * 6
    for r in left:
        assert r["us"] > 0 and r["loi"] == jitf.lbench_loi(
            r["nflop"], r["elements"], ttiers.h100_topology())
    assert kernels.REFERENCE_CALLS["lbench"] == 2 * 12
    middle = [r for r in rows if r["panel"] == "middle"]
    assert [r["nflop"] for r in middle] == [1, 2, 4, 8, 16, 32, 64, 128]
    right = [r["arch"] for r in rows if r["panel"] == "right"]
    assert right == configs.list_archs()
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(rows)
    assert all(len(line.split(",", 2)) == 3 for line in lines)
    assert lines[0].startswith("fig11_lbench_nflop1,")

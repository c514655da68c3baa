"""The port's W8A8 int8 matmul against the reference's on the same numpy
inputs: `quantize_rows` equal bit for bit on both axes; the op on CPU
tensors (the plain version) against the Pallas kernel in interpret mode
on the reference test's four shapes at rtol = atol = 1e-6 (its own
tolerance); zero operands exact; the plain version's float64 product (the
one torch has on CUDA) equal to its int32 product."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.matmul_w8a8 import ops as jops  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.matmul_w8a8 import ops as tops  # noqa: E402
from repro_torch.kernels.matmul_w8a8 import ref as tref  # noqa: E402

SHAPES = [(128, 128, 128), (256, 384, 256), (130, 96, 200), (1, 128, 256)]


def _operands(M, K, N):
    rng = np.random.default_rng(M + K + N)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = (rng.standard_normal((K, N)) * 0.5).astype(np.float32)
    return a, b


@pytest.mark.parametrize("axis", [-1, 0, 1])
def test_quantize_rows_matches_reference(axis):
    a, _ = _operands(96, 200, 1)
    a[3] = 0.0                        # an all-zero row keeps MIN_SCALE
    a[5, 7] = 1e-9
    q, s = tops.quantize_rows(torch.from_numpy(a), axis=axis)
    jq, js = jops.quantize_rows(jnp.asarray(a), axis=axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_matmul_w8a8_matches_reference(M, K, N):
    a, b = _operands(M, K, N)
    a8, sa = jops.quantize_rows(jnp.asarray(a))
    b8, sb = jops.quantize_rows(jnp.asarray(b), axis=0)
    want = np.asarray(jops.matmul_w8a8(a8, b8, sa, sb, impl="interpret"))
    kernels.reset_counters()
    got = tops.matmul_w8a8(*(torch.from_numpy(np.array(x))
                             for x in (a8, b8, sa, sb)))
    assert kernels.REFERENCE_CALLS["matmul_w8a8"] == 1
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    fp = a @ b
    assert np.abs(got.numpy() - fp).max() / np.abs(fp).max() < 0.05


def test_matmul_w8a8_zero_operands_exact():
    a8, sa = tops.quantize_rows(torch.zeros(64, 128))
    b8, sb = tops.quantize_rows(torch.zeros(128, 64), axis=0)
    out = tops.matmul_w8a8(a8, b8, sa, sb)
    assert torch.equal(out, torch.zeros(64, 64))


@pytest.mark.parametrize("M,K,N", SHAPES + [(8, 960, 2560)])
def test_plain_float64_product_equals_int32(M, K, N):
    """The float64 product is exact: equal to the int32 one on the CPU,
    down to the epilogue, at the extremes of the int8 range too."""
    rng = np.random.default_rng(K)
    a8 = torch.from_numpy(rng.integers(-127, 128, (M, K), dtype=np.int8))
    b8 = torch.from_numpy(rng.integers(-127, 128, (K, N), dtype=np.int8))
    a8[0] = 127
    b8[:, 0] = 127
    sa = torch.from_numpy(rng.uniform(1e-3, 1e-1, M).astype(np.float32))
    sb = torch.from_numpy(rng.uniform(1e-3, 1e-1, N).astype(np.float32))
    acc = tref.int_matmul(a8, b8, via="int32")
    assert acc.dtype == torch.int32 and int(acc[0, 0]) == 127 * 127 * K
    assert torch.equal(tref.int_matmul(a8, b8, via="float64"), acc)
    assert torch.equal(tref.matmul_w8a8(a8, b8, sa, sb, via="float64"),
                       tref.matmul_w8a8(a8, b8, sa, sb, via="int32"))


def test_matmul_w8a8_kernel_refuses_cpu_tensors():
    a8, sa = tops.quantize_rows(torch.ones(4, 8))
    b8, sb = tops.quantize_rows(torch.ones(8, 4), axis=0)
    with pytest.raises(ValueError, match="CUDA"):
        tops.matmul_w8a8(a8, b8, sa, sb, impl="cuda")

"""W8A8 int8 matmul: symmetric per-row / per-column scales, int32
accumulation, a float32 dequant epilogue. The op lives in `ops.py`
(`repro_torch.kernels.matmul_w8a8.ops.matmul_w8a8`); re-exporting it
here would shadow the same-named kernel submodule, as in the
reference."""

from repro_torch.kernels.matmul_w8a8.ops import quantize_rows  # noqa: F401

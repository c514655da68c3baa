"""Hand-written Hopper kernels for the perf-critical layers, behind
device-dispatching ops (the port's counterpart of `repro.kernels`).

Each kernel package has three modules, as in the reference:
  <name>.py  - the ctypes wrapper of the CUDA C++ kernel (source under
               `csrc/`, built by `build.py` with nvcc for sm_90a); it
               checks device, dtype, shape and contiguity and counts its
               launches in `LAUNCHES`
  ops.py     - the public op: dispatches by the tensor's device
  ref.py     - the plain PyTorch version, with the reference's semantics

Dispatch goes by the device of the tensor an op is given: a CUDA tensor
launches the kernel (or raises), a CPU tensor takes the plain version.
There is no fallback from a kernel that fails to build or launch.
`force_backend("reference")` exists so that a caller can run the plain
versions on the card to compare against (`chip_smoke.py`).

Kernels on the serving and training paths: `page_io` (the grouped page copy: pool
insert, the substrate's page_out / page_in streams, the fleet's
prefill->decode handoff between two pools and the layer-ahead layer_in
stream of `prefetch.static`, and the tiered train step's `state_in` /
`state_out` copies of its pool-tier leaves, `runtime.tiering`),
`flash_attention`
(bucket prefill and the training forward: `flash_mha`; its backward:
`flash_mha_bwd`; chunked prefill: `paged_prefill_flash`,
`paged_prefill_insert_flash`, `paged_prefill_insert_flash_q8`),
`decode_attention` (paged decode over the block table: `paged_flash_decode`;
decode over a contiguous cache: `flash_decode`), `ssd_scan` (the
Mamba2 chunked SSD scan of the SSM layers' prompt pass and the training
forward: `ssd_scan`; its backward recomputes through the plain chunked
version, as the reference's does).

Kernels of the analysis path (`core.quantify`, `scripts/lbench_torch.py`):
`lbench` (the paper's FMA-chain roofline and interference probe) and
`matmul_w8a8` (int8 x int8 -> int32 matmul with a per-row / per-column
dequant epilogue).
"""

from __future__ import annotations

import torch

_FORCED: str | None = None

# launches of each kernel since the last reset (incremented by the
# wrapper right after it launches, nowhere else; flash_decode's launches
# that also write the log-sum-exp count as "flash_decode_lse") and calls
# that took the plain version
LAUNCHES = {"write_pages": 0, "page_out": 0, "page_in": 0, "handoff": 0,
            "layer_in": 0, "state_in": 0, "state_out": 0,
            "flash_mha": 0, "flash_mha_bwd": 0,
            "paged_flash_decode": 0, "paged_prefill_flash": 0,
            "paged_prefill_insert_flash": 0,
            "paged_prefill_insert_flash_q8": 0, "flash_decode": 0,
            "flash_decode_lse": 0,
            "lbench": 0, "matmul_w8a8": 0, "ssd_scan": 0}
REFERENCE_CALLS = {"write_pages": 0, "page_out": 0, "page_in": 0,
                   "handoff": 0, "layer_in": 0, "state_in": 0,
                   "state_out": 0,
                   "mha": 0, "mha_bwd": 0, "paged_decode_mha": 0,
                   "paged_prefill_mha": 0,
                   "paged_prefill_insert_mha": 0,
                   "paged_prefill_insert_mha_q8": 0, "decode_mha": 0,
                   "lbench": 0, "matmul_w8a8": 0, "ssd": 0}


def force_backend(name: str | None) -> None:
    """Force 'cuda' | 'reference' | None (dispatch by tensor device)."""
    if name not in (None, "cuda", "reference"):
        raise ValueError(f"unknown kernel backend {name!r}")
    global _FORCED
    _FORCED = name


def reset_counters() -> None:
    for counts in (LAUNCHES, REFERENCE_CALLS):
        for k in counts:
            counts[k] = 0


# the cost mode of `profiler.cost` while it counts (None otherwise): an op
# that has a kernel unit hands it the kernel's cost instead of running
_COST_SINK = None


def costed(x: torch.Tensor) -> bool:
    """True while `profiler.cost` counts and `x` is a meta tensor: the op
    is then one kernel unit — it records its kernel's `cost(...)` with
    `record_unit` and returns empty outputs of the right shapes, without
    tracing its plain version. Dispatch by device is unchanged for every
    other tensor."""
    return _COST_SINK is not None and x.device.type == "meta"


def record_unit(name: str, flops: float, nbytes: float, inputs,
                outputs) -> None:
    """One unit of kernel `name`: its flops and bytes from the kernel's
    cost formula, and the tensors it reads and writes at its boundary."""
    _COST_SINK.unit(name, flops, nbytes, inputs, outputs)


def record_collective(kind: str, wire_bytes: float, shape, axis) -> None:
    """One collective a traced step would issue (`common.parallel` under
    the cost mode): its kind, its wire bytes under the ring model, the
    shape of its input and its mesh axis."""
    _COST_SINK.collective(kind, wire_bytes, shape, axis)


def select_impl(x: torch.Tensor, impl: str | None = None) -> str:
    """Resolve an op's implementation for input tensor `x`: "cuda" (launch
    the kernel) or "reference" (the plain PyTorch version). With no
    request and nothing forced, the tensor's device decides. Asking for
    the kernel on a CPU tensor raises."""
    impl = impl or _FORCED or (
        "cuda" if x.device.type == "cuda" else "reference")
    if impl not in ("cuda", "reference"):
        raise ValueError(f"unknown kernel impl {impl!r}")
    if impl == "cuda" and x.device.type != "cuda":
        raise ValueError(
            f"the CUDA kernel needs CUDA tensors, got {x.device}")
    return impl

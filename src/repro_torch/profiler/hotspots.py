"""Hotspot attribution: the cost model's flops and bytes grouped by the
port's model functions on the Python stack (port of
`repro.profiler.hotspots`, which groups an HLO's dot flops and wire bytes
by jax op_name scope). The dry-run's equivalent of a wall-clock profile.

Each op the step dispatches, and each kernel unit, goes to exactly one
group: the chain of `repro_torch.models` functions it was called from,
outermost first and cut to `depth` ("model.forward/blocks.stack_apply/
blocks._apply_layer_train"), else the chain of the port's other
functions (the train step, the optimizer), else "(unscoped)"; an op of
the backward is grouped by its autograd node ("(backward)/MmBackward0").
So the groups sum to the totals of `cost.analyze_step`.
"""

from __future__ import annotations

from typing import Callable

from repro_torch.profiler.cost import run_counted


def hotspots(fn: Callable, *args, depth: int = 3, **kwargs) -> dict:
    """{group: {"flops", "bytes", "count"}} of one call of `fn` on meta
    tensors; "bytes" is the cost model's `hbm_bytes` share."""
    _, mode = run_counted(fn, *args, depth=depth, **kwargs)
    return {k: dict(v) for k, v in mode.groups.items()}


def print_hotspots(fn: Callable, *args, depth: int = 4, top: int = 15,
                   **kwargs) -> dict:
    """Print the `top` groups by flops and by bytes; returns the groups."""
    agg = hotspots(fn, *args, depth=depth, **kwargs)
    rows = sorted(agg.items(), key=lambda kv: -kv[1]["flops"])
    print(f"{'scope':70s} {'Tflops':>10s} {'GB':>10s}")
    for k, v in rows[:top]:
        print(f"{k[:70]:70s} {v['flops'] / 1e12:10.3f} "
              f"{v['bytes'] / 1e9:10.3f}")
    rows = sorted(agg.items(), key=lambda kv: -kv[1]["bytes"])
    print("--- by bytes ---")
    for k, v in rows[:top // 2]:
        print(f"{k[:70]:70s} {v['flops'] / 1e12:10.3f} "
              f"{v['bytes'] / 1e9:10.3f}")
    return agg

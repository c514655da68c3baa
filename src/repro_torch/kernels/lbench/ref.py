"""Plain PyTorch version of LBench, the paper's interference kernel
(`repro.kernels.lbench.ref`, same semantics).

Per element:
    if NFLOP % 2 == 1: beta = A[i] + alpha
    else:              beta = A[i]            (read, no flop consumed)
    repeat NFLOP//2 times: beta = beta * A[i] + alpha
    A[i] = beta

The chain runs in float32 for any input dtype and casts back at the end;
`nflop=0` is a copy. flops/element = NFLOP, bytes/element = 8 (one f32
read and one write), so AI = NFLOP/8 flop/B: sweeping NFLOP sweeps the
roofline's x-axis, which is how the paper dials the level of
interference.
"""

from __future__ import annotations

import torch


def lbench(a: torch.Tensor, nflop: int, alpha: float = 0.5) -> torch.Tensor:
    if nflop == 0:
        return a.clone()               # out of place, like the kernel
    a32 = a.float()
    beta = a32 + alpha if (nflop % 2 == 1) else a32
    for _ in range(nflop // 2):
        beta = beta * a32 + alpha
    return beta.to(a.dtype)


def flops(n_elements: int, nflop: int) -> int:
    per = (nflop % 2) + 2 * (nflop // 2)
    return n_elements * per


def bytes_moved(n_elements: int, itemsize: int = 4) -> int:
    return 2 * n_elements * itemsize

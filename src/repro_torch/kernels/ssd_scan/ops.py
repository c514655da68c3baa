"""Public SSD op (the Mamba2 inner scan): a CUDA tensor launches the
chunked-SSD kernel (`ssd_scan.py`) at every S, a CPU tensor follows the
reference's plain branch (the exact scan up to S = 64, the chunked
matmul form above). Decode is one O(1) recurrence step, plain PyTorch as
in the reference.

Both branches are differentiable. The plain branch by autograd through
`ref` / `chunked`. The kernel branch is a `torch.autograd.Function`
whose backward recomputes the forward through `chunked.ssd_chunked` and
takes its vjp, exactly as the reference's `ssd_pallas` custom_vjp
(`_ssd_bwd`) takes the vjp of `ssd_chunked_jnp`: a hand-written CUDA
backward is a later step (ROADMAP B12)."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.kernels.ssd_scan import chunked, ref
from repro_torch.kernels.ssd_scan import ssd_scan as ks


def ssd_flops(B: int, S: int, H: int, P: int, N: int, Q: int = ks.Q) -> int:
    """Operations of the chunked SSD at chunk length Q (the CUDA kernel's,
    `ssd_scan.Q`), counted for this S (the last chunk holds what is
    left): per (b, h) and chunk of L positions, the causal halves of the
    C.B^T scores and of the intra-chunk product, L(L+1)/2 (N + P)
    multiply-adds, plus the inter-chunk term and the state update,
    2 L P N multiply-adds."""
    full, rest = divmod(S, Q)
    per = lambda L: 2 * (L * (L + 1) // 2 * (N + P) + 2 * L * P * N)  # noqa
    return B * H * (full * per(Q) + (per(rest) if rest else 0))


def ssd_cost(x_shape, B_shape, *, itemsize: int = 2, b_itemsize: int = 2,
             has_D: bool = True, has_init: bool = False) -> tuple[int, int]:
    """(operations, bytes) of one ssd_scan call: `ssd_flops`; x read and
    y written, B and C read at their itemsizes, the float32 dt, A and D
    read, the float32 final state written (and the initial state read
    when given). The kernels table's bound (`chip_smoke.py`) and the
    dry-run's unit (`profiler.cost`) both read it."""
    Bb, S, H, P = x_shape
    G, N = B_shape[2], B_shape[3]
    nbytes = (2 * Bb * S * H * P * itemsize + 2 * Bb * S * G * N * b_itemsize
              + Bb * S * H * 4 + (2 if has_D else 1) * H * 4
              + (2 if has_init else 1) * Bb * H * P * N * 4)
    return ssd_flops(Bb, S, H, P, N), nbytes


def ssd(x, dt, A, Bmat, Cmat, D=None, init_state=None, *, chunk: int = 128,
        impl: Optional[str] = None):
    """Chunked SSD scan. Returns (y (B,S,H,P), final_state (B,H,P,N)).
    `chunk` is the plain version's chunk target; the kernel picks its
    own (the decomposition is exact for any chunk length). Under the cost
    mode a meta call is one unit of ssd_scan (its backward recomputes
    through the plain chunked version, as on the card)."""
    if kernels.costed(x):
        return _SsdScan.apply(x, dt, A, Bmat, Cmat, D, init_state, chunk)
    if kernels.select_impl(x, impl) == "reference":
        kernels.REFERENCE_CALLS["ssd"] += 1
        if x.shape[1] <= 64:
            return ref.ssd(x, dt, A, Bmat, Cmat, D, init_state)
        return chunked.ssd_chunked(x, dt, A, Bmat, Cmat, D, init_state,
                                   chunk)
    return _SsdScan.apply(x, dt, A, Bmat, Cmat, D, init_state, chunk)


class _SsdScan(torch.autograd.Function):
    """`ssd_cuda` forward; the backward is the vjp of the plain chunked
    version at `chunk`, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, dt, A, Bmat, Cmat, D, init_state, chunk):
        ctx.chunk = chunk
        if any(ctx.needs_input_grad[:7]):
            ctx.save_for_backward(x, dt, A, Bmat, Cmat, D, init_state)
        if kernels.costed(x):
            Bb, _, H, P = x.shape
            y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
            state = torch.empty((Bb, H, P, Bmat.shape[3]),
                                dtype=torch.float32, device=x.device)
            kernels.record_unit("ssd_scan", *ssd_cost(
                x.shape, Bmat.shape, itemsize=x.element_size(),
                b_itemsize=Bmat.element_size(), has_D=D is not None,
                has_init=init_state is not None),
                (x, dt, A, Bmat, Cmat, D, init_state), (y, state))
            return y, state
        return ks.ssd_cuda(x.contiguous(), dt, A, Bmat.contiguous(),
                           Cmat.contiguous(), D, init_state)

    @staticmethod
    def backward(ctx, dy, dstate):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:7]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) if t is not None else None
                   for t, n in zip(saved, need)]
            y, state = chunked.ssd_chunked(*ins, ctx.chunk)
            wrt = [t for t, n in zip(ins, need) if n]
            grads = iter(torch.autograd.grad((y, state), wrt, (dy, dstate),
                                             allow_unused=True))
        return (*(next(grads) if n else None for n in need), None)


ssd_decode = ref.ssd_decode  # O(1)-per-token update; plain PyTorch

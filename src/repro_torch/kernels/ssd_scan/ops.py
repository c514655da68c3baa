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


def ssd(x, dt, A, Bmat, Cmat, D=None, init_state=None, *, chunk: int = 128,
        impl: Optional[str] = None):
    """Chunked SSD scan. Returns (y (B,S,H,P), final_state (B,H,P,N)).
    `chunk` is the plain version's chunk target; the kernel picks its
    own (the decomposition is exact for any chunk length)."""
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
        from repro_torch.kernels.ssd_scan import ssd_scan as ks

        ctx.chunk = chunk
        if any(ctx.needs_input_grad[:7]):
            ctx.save_for_backward(x, dt, A, Bmat, Cmat, D, init_state)
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

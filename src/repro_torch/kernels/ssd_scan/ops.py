"""Public SSD op (the Mamba2 inner scan): a CUDA tensor launches the
chunked-SSD kernel (`ssd_scan.py`) at every S, a CPU tensor follows the
reference's plain branch (the exact scan up to S = 64, the chunked
matmul form above). Decode is one O(1) recurrence step, plain PyTorch as
in the reference."""

from __future__ import annotations

from typing import Optional

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
    from repro_torch.kernels.ssd_scan import ssd_scan as ks

    return ks.ssd_cuda(x.contiguous(), dt, A, Bmat.contiguous(),
                       Cmat.contiguous(), D, init_state)


ssd_decode = ref.ssd_decode  # O(1)-per-token update; plain PyTorch

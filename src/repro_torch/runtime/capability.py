"""Capability probes for the physical KV substrate (port of
`repro.runtime.capability`).

The reference asks XLA whether `pinned_host` placement and transfers
compile. Here the questions are CUDA's: can the process allocate pinned
host memory for a card, and does the page-copy kernel reach that memory
through a mapped device address (`cudaHostGetDevicePointer`)? On the CPU
both answers are no, so "auto" resolves to "emulated", as on XLA:CPU.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch


def _cuda(device) -> Optional[torch.device]:
    dev = torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return dev


def _pinned() -> torch.Tensor:
    return torch.zeros(8, pin_memory=True)


@functools.cache
def _host_input(device: str) -> bool:
    try:
        t = _pinned()
    except RuntimeError:
        return False
    return t.is_pinned()


@functools.cache
def _internal(device: str) -> bool:
    """Only a failed mapping answers no; a kernel build or library layout
    error propagates (and is not cached)."""
    if not _host_input(device):
        return False
    from repro_torch.kernels.page_io import page_io

    with torch.cuda.device(torch.device(device)):
        try:
            page_io.host_device_ptr(_pinned())
        except page_io.HostMappingError:
            return False
    return True


def supports_host_input(device=None) -> bool:
    """A CUDA device is present and pinned host memory can be allocated
    (the twin's placement)."""
    dev = _cuda(device)
    return dev is not None and _host_input(str(dev))


def supports_internal_transfer(device=None) -> bool:
    """The page-copy kernel reaches a pinned tensor through its mapped
    device address (`cudaHostGetDevicePointer` succeeds): the page
    streams can run device <-> host inside one kernel."""
    dev = _cuda(device)
    return dev is not None and _internal(str(dev))


def supports_host_output(device=None) -> bool:
    """Kernels can write pinned host memory: the same mapped address as
    the internal transfer."""
    return supports_internal_transfer(device)


def resolve_substrate_mode(requested: str, *, host_input: bool,
                           host_output: bool, internal: bool) -> str:
    """Pure mode resolution for the physical KV substrate.

    The substrate keeps a host-resident twin of the pool pages: it needs
    pinned_host *placement* of standing arrays (host_input — the twin is
    an input to nothing but device_put, but placement uses the same
    compile path) and jittable internal transfers for the page streams.
    host_output alone is not enough (can't round-trip pages back out).

      requested="physical"  — demand the real thing; raise if unsupported
      requested="emulated"  — force default-memory twin (same code shape,
                              same ledger; bytes counted, not moved
                              across memory kinds)
      requested="auto"      — physical when the backend can, else emulated
      requested="off"       — no substrate at all
    """
    if requested not in ("auto", "off", "emulated", "physical"):
        raise ValueError(
            f"substrate={requested!r} not in ('auto', 'off', 'emulated', "
            f"'physical')")
    if requested in ("off", "emulated"):
        return requested
    physical_ok = host_input and internal
    if requested == "physical":
        if not physical_ok:
            raise RuntimeError(
                "substrate='physical' requested but the backend probes "
                f"report host_input={host_input} internal={internal} "
                f"(host_output={host_output}); use 'auto' or 'emulated'")
        return "physical"
    return "physical" if physical_ok else "emulated"


def substrate_mode(requested: str = "auto", device=None) -> str:
    """Resolve the substrate mode against the probes of `device` (the
    card when one is present, else the CPU)."""
    return resolve_substrate_mode(
        requested,
        host_input=supports_host_input(device),
        host_output=supports_host_output(device),
        internal=supports_internal_transfer(device),
    )

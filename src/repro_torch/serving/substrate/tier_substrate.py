"""`TierSubstrate` — owns the host-resident pool twin and the page streams
that reconcile it against the pager's tier map (port of
`repro.serving.substrate.tier_substrate`).

See the package docstring for the model. Shape notes: every paged leaf
has the physical page axis at position 1 (k/v: (nb, P_phys,
page_tokens, KV, hd); k_sz/v_sz: (nb, P_phys, KV, 2)), so one id vector
drives all leaves of a stream, and each stream is ONE launch of the
grouped page copy (`kernels.page_io.copy_pages`) over every leaf.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import torch

from repro_torch.common.pytree import leaf_bytes
from repro_torch.kernels.page_io import ops as page_ops
from repro_torch.models import blocks
from repro_torch.runtime import sharding
from repro_torch.serving.substrate.ledger import HostDone, SubstrateLedger


def _leaves(tree) -> List[torch.Tensor]:
    return [leaf for sub in tree.values() for leaf in sub.values()]


def _pool_leaves(caches, twin) -> List[torch.Tensor]:
    """The device-pool leaves of `caches` matching `twin`'s structure, in
    `_leaves(twin)` order."""
    return [caches[pos][k] for pos, sub in twin.items() for k in sub]


class TierSubstrate:
    """Two-tier physical placement for the paged KV pool.

    mode       — "physical" (pinned host twin) or "emulated" (a twin on
                 the pool's own device, identical streams); resolve it
                 with `runtime.capability.substrate_mode` first — this
                 class does not probe.
    host_memory_kind — the memory the physical twin lands in; the engine
                 feeds `TierTopology.pool.memory_kind` (`core.tiers.
                 TierSpec`), so the pool tier the virtual clock prices is
                 the tier the bytes physically occupy. Only "pinned_host"
                 exists on this card.
    mesh, pool_pspec — over a mesh, the `DeviceMesh` and the cache tree's
                 specs (`runtime.sharding.paged_cache_pspec`): `caches`
                 holds the rank's shard of the pool, and so does the twin,
                 so page_out / page_in move the rank's shard with no
                 reshard; `page_bytes` (what the ledger prices) are the
                 GLOBAL page's, each leaf's local bytes times its number
                 of shards, as the reference's ledger reads a global
                 array's nbytes.

    On the card the streams run on a side stream: each drain first waits
    for the main stream (the pool as the step left it), and `fence()`
    makes the main stream wait for the last page_out before a cell writes
    the pool in place again — the reference's snapshot semantics (its
    arrays are immutable; this pool is not), while the copy overlaps the
    host's launch work.
    """

    def __init__(self, caches, mode: str, *,
                 host_memory_kind: str = "pinned_host", mesh=None,
                 pool_pspec=None):
        if mode not in ("physical", "emulated"):
            raise ValueError(
                f"mode={mode!r}; resolve 'auto'/'off' via "
                "runtime.capability.substrate_mode before constructing")
        if host_memory_kind != "pinned_host":
            raise ValueError(
                f"host_memory_kind={host_memory_kind!r}: the pool twin "
                "lives in pinned host memory ('pinned_host')")
        self.mode = mode
        # fault-injection wiring (serving.faults): the fleet router sets
        # `faults`/`engine_id` after construction; when unset every
        # transfer succeeds on the first attempt and no retry state is
        # touched. An injected failure is a virtual retry (ledger and
        # clock only): the stream is still issued exactly once, and a
        # real error from the build, the launch or the host mapping
        # propagates as it does without a plan
        self.faults = None
        self.engine_id = 0
        self.retries = 0
        self.retry_bytes = 0.0
        self._backoff_pending_s = 0.0
        self._side: Optional[torch.cuda.Stream] = None
        self._out_event: Optional[torch.cuda.Event] = None
        twin = blocks.init_pool_twin(caches, pinned=mode == "physical")
        self.enabled = bool(twin)
        if not self.enabled:        # SSM-only stack: no paged KV leaves
            self.twin = None
            self.ledger = SubstrateLedger(0.0, mode)
            return
        self.twin = twin
        leaves = _leaves(twin)
        self.device = _pool_leaves(caches, twin)[0].device
        # MEASURED page bytes: real tensor nbytes over the page axis, not
        # the closed-form kv-byte walk (they agree to float rounding)
        shards = ([1] * len(leaves) if mesh is None else
                  _leaves(sharding.tree_nbytes_scale(
                      {pos: {k: pool_pspec[pos][k] for k in sub}
                       for pos, sub in twin.items()}, mesh)))
        self.page_bytes = float(sum(
            leaf_bytes(leaf) / leaf.shape[1] * n
            for leaf, n in zip(leaves, shards)))
        self.ledger = SubstrateLedger(self.page_bytes, mode)
        self._resident: set = set()
        if self.device.type == "cuda":
            self._side = torch.cuda.Stream(self.device)

    # ----------------------------------------------------------- streams
    def _attempt_transfer(self, site: str, n_pages: int, step: int) -> None:
        """Consult the fault injector before issuing a stream: each
        injected failure logs a `retry` event (wasted link bytes, zero
        placement delta) and accrues exponential backoff on the pending
        virtual-time bill (`take_backoff`). Bounded: after
        `plan.max_retries` failed attempts the fault is fatal — an
        unreachable tier must surface, not spin."""
        if self.faults is None:
            return
        attempt = 1
        while self.faults.transfer_fails(f"substrate/{site}"):
            self.ledger.record("retry", n_pages, step=step)
            self.retries += 1
            self.retry_bytes += n_pages * self.page_bytes
            self._backoff_pending_s += self.faults.backoff_s(attempt)
            attempt += 1
            if attempt > self.faults.plan.max_retries:
                raise RuntimeError(
                    f"substrate {site} failed "
                    f"{self.faults.plan.max_retries} consecutive "
                    f"attempts (engine {self.engine_id}, step {step}) — "
                    f"tier unreachable")

    def take_backoff(self) -> float:
        """Drain the accumulated retry backoff (seconds of virtual time
        the engine must charge to its clock)."""
        dt, self._backoff_pending_s = self._backoff_pending_s, 0.0
        return dt

    @contextlib.contextmanager
    def _on_side(self, moving: bool):
        """Run the enclosed streams on the side stream, after everything
        the main stream has queued so far (no-op on the CPU, or when no
        page moves)."""
        if self._side is None or not moving:
            yield
            return
        self._side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._side):
            yield

    def _done(self):
        """The completion handle of the streams issued so far: an event
        recorded on the side stream, or `HostDone` where they already ran
        (the CPU)."""
        if self._side is None:
            return HostDone()
        ev = torch.cuda.Event()
        ev.record(self._side)
        return ev

    def fence(self) -> None:
        """Make the main stream wait for the last page_out before a cell
        writes the pool in place (no-op when none is pending)."""
        if self._out_event is not None:
            torch.cuda.current_stream(self.device).wait_event(
                self._out_event)
            self._out_event = None

    def drain(self, pager, caches, *, step: int = 0) -> dict:
        """Reconcile host placement against the pager's tier map: issue
        the page_out / page_in / drop streams for every page whose
        placement changed since the last drain. Async — call `sync()`
        to wait on the issued transfers. Returns the per-kind page
        counts of this drain."""
        if not self.enabled:
            return {}
        target = set(pager.pool_page_ids().tolist())
        outs = sorted(target - self._resident)
        gone = self._resident - target
        promoted = sorted(p for p in gone if pager.ref[p] > 0)
        freed = sorted(p for p in gone if pager.ref[p] <= 0)
        if freed:
            self.ledger.record("drop", len(freed), step=step)
        twin = _leaves(self.twin)
        # the ids and the page_in scratch are allocated on the side stream
        # (inside `_on_side`), so the caching allocator hands their blocks
        # only to later work on that stream: they are dropped after the
        # launch and the ledger keeps just the completion handle, so
        # device memory does not grow with the bytes a run pages in
        with self._on_side(bool(promoted or outs)):
            if promoted:
                self._attempt_transfer("page_in", len(promoted), step)
                # lands in device scratch, never in the pool: the device
                # pool stays authoritative
                ids = torch.tensor(promoted, dtype=torch.int32,
                                   device=self.device)
                got = [torch.empty((t.shape[0], len(promoted),
                                    *t.shape[2:]), dtype=t.dtype,
                                   device=self.device) for t in twin]
                page_ops.copy_pages(got, None, twin, ids, name="page_in")
                self.ledger.record("page_in", len(promoted), step=step,
                                   payload=(self._done(),))
            if outs:
                self._attempt_transfer("page_out", len(outs), step)
                ids = torch.tensor(outs, dtype=torch.int32,
                                   device=self.device)
                page_ops.copy_pages(twin, ids, _pool_leaves(caches,
                                                            self.twin),
                                    ids, name="page_out")
                done = self._done()
                if self._side is not None:
                    self._out_event = done
                self.ledger.record("page_out", len(outs), step=step,
                                   payload=(done,))
        self._resident = target
        return {"page_out": len(outs), "page_in": len(promoted),
                "drop": len(freed)}

    def record_handoff(self, n_pages: int, *, step: int = 0) -> None:
        """Account a fleet prefill->decode handoff copy (the page copy
        runs along the physical axis; the substrate prices it at measured
        page bytes). No placement change: the source pages stay wherever
        their tier map says."""
        if self.enabled and n_pages:
            self.ledger.record("handoff", int(n_pages), step=step)

    # -------------------------------------------------------- accounting
    def sync(self) -> int:
        """Complete every in-flight stream (waits on their events)."""
        return self.ledger.sync()

    def counters(self) -> dict:
        return self.ledger.counters()

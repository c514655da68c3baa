"""Disaggregated prefill/decode engine roles: the pool-transfer ledger (port
of `repro.serving.fleet.roles`).

The disaggregated-memory thesis applied to token serving: a
prefill-role engine runs chunked prefill and *produces* KV pages into
its pool; a decode-role engine *consumes* them. Mechanically a handoff is
three existing primitives composed across two engines:

1. the prefill engine completes the last chunk, emits the first token,
   guard-**pins** the slot's prompt pages and parks the slot in the
   ``handoff`` phase (`ServingEngine._prefill_tick`), queueing a
   :class:`~repro_torch.serving.engine.HandoffRecord`;
2. :func:`execute_handoff` admits the request into a decode-engine
   slot, allocates destination pages through the decode engine's pager
   (`KVPager.admit`), and copies the page *payload* — every paged cache
   leaf (`k`/`v` + int8 `k_sz`/`v_sz` scale rows) along the physical
   page axis, in ONE launch of the grouped page copy (the "handoff"
   stream of `kernels.page_io.copy_pages`) — pricing the transfer at
   pool bandwidth on the virtual clock (`advance_to(t_emit +
   pages*page_bytes/BW)`);
3. the prefill engine drops the guard pin and **releases** the source
   slot (`complete_handoff` -> `KVPager.release`), returning its pages
   to the producer's free list.

On the card the pools are written in place, so the copy is ordered on
the stream: both engines' pending page_out (which reads their pools) is
fenced first, and every cell of either engine runs on the same stream as
the copy, so the destination's next decode sees the pages and the
source's next write of a released page comes after the copy read it.

The :class:`TransferLedger` is the router's accounting of every page
movement — pages, bytes, and per-transfer latency — so bench lanes can
report the pool traffic the role split generates.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch

from repro_torch.kernels.page_io import ops as page_ops
from repro_torch.models.blocks import PAGED_LEAF_NAMES
from repro_torch.serving.engine import HandoffRecord, ServingEngine

__all__ = ["TransferLedger", "copy_pages", "can_accept_handoff",
           "execute_handoff"]


@dataclasses.dataclass
class TransferRecord:
    request_id: int
    src_engine: int
    dst_engine: int
    n_pages: int
    bytes: float
    t_emit: float                 # prefill clock at first-token emission
    t_ready: float                # decode clock when pages landed
    retries: int = 0              # failed copy attempts (fault injection)


class TransferLedger:
    """Append-only log of prefill->decode page transfers."""

    def __init__(self) -> None:
        self.records: List[TransferRecord] = []

    def record(self, rec: TransferRecord) -> None:
        self.records.append(rec)

    def counters(self) -> dict:
        n = len(self.records)
        return {
            "transfers": n,
            "pages": sum(r.n_pages for r in self.records),
            "bytes": sum(r.bytes for r in self.records),
            "mean_latency_s": (
                sum(r.t_ready - r.t_emit for r in self.records) / n
                if n else 0.0
            ),
            # fault-recovery accounting: failed attempts re-crossed the
            # link, so their bytes are real interference even though no
            # page ever landed from them
            "retries": sum(r.retries for r in self.records),
            "retry_bytes": sum(r.retries * r.bytes for r in self.records),
        }


def copy_pages(src_caches, dst_caches, src_pages, dst_pages):
    """Copy the payload of `src_pages` (physical ids in the source pool)
    onto `dst_pages` of the destination pool, in place, for every paged
    leaf — k/v and, for int8 pools, the per-page (scale, zero) rows ride
    along, so quantized pages transfer bit-exactly. Leaves index pages on
    axis 1 (layer-stacked axis 0). One launch of the grouped page copy
    over all leaves of all positions (the plain version on the CPU).
    Returns `dst_caches`."""
    if len(src_pages) != len(dst_pages):
        raise ValueError("src/dst page counts differ")
    dst, src = [], []
    for pos, c in dst_caches.items():
        for key in PAGED_LEAF_NAMES:
            if key in c:
                dst.append(c[key])
                src.append(src_caches[pos][key])
    if not dst or not len(dst_pages):
        return dst_caches
    dev = dst[0].device
    page_ops.copy_pages(
        dst, torch.tensor(dst_pages, dtype=torch.int32, device=dev),
        src, torch.tensor(src_pages, dtype=torch.int32, device=dev),
        name="handoff")
    return dst_caches


def can_accept_handoff(dst: ServingEngine, rec: HandoffRecord) -> bool:
    """Room for the transfer right now: a free slot and enough free
    physical pages to own the prompt."""
    return (dst.batcher.n_free > 0
            and dst.pager.counters()["free_pages"] >= len(rec.pages))


def execute_handoff(rec: HandoffRecord, src: ServingEngine,
                    dst: ServingEngine, *, src_id: int, dst_id: int,
                    ledger: TransferLedger, faults=None) -> float:
    """Move `rec`'s request from the prefill engine `src` into a decode
    slot on `dst`. Returns the decode-side ready time (virtual s).

    `faults` (a `serving.faults.FaultInjector`) flakes the copy at the
    "handoff" site: each failed attempt re-prices the full payload over
    the link plus exponential backoff, bounded by `plan.max_retries`
    before the fault surfaces as fatal. The payload lands exactly once —
    only the t_ready bill and the ledger's retry counters change."""
    if not can_accept_handoff(dst, rec):
        raise RuntimeError(
            f"decode engine {dst_id} cannot accept handoff for request "
            f"{rec.request.request_id} (free slots {dst.batcher.n_free}, "
            f"free pages {dst.pager.counters()['free_pages']})"
        )
    req = rec.request
    n_pages = len(rec.pages)
    slot = dst.batcher.admit(req, start_pos=rec.n_tokens)
    dst.pager.admit(slot.index, rec.n_tokens)
    dst_pages = [int(p) for p in dst.pager.phys[slot.index, :n_pages]]
    # page_out streams read the pools on each engine's side stream: the
    # copy writes dst's pool and reads src's after them
    src._fence()
    dst._fence()
    dst.caches = copy_pages(src.caches, dst.caches, rec.pages, dst_pages)
    dst.tokens[slot.index] = rec.first_token
    # the transfer serializes after first-token emission and prices the
    # page payload over the pool link — the decode engine cannot start
    # this slot before the pages land. With the substrate on, page bytes
    # come MEASURED from the pool twin's tensor nbytes (and the copy is
    # logged as a handoff stream in the source engine's ledger); the
    # pager's derived page_bytes is the substrate-off fallback — the two
    # agree to float rounding, so fleet figures are mode-invariant.
    if src.substrate is not None:
        page_b = src.substrate.page_bytes
        src.substrate.record_handoff(n_pages, step=src.steps)
    else:
        page_b = src.pager.page_bytes
    t_xfer = n_pages * page_b / src.topo.pool.bandwidth
    retries, t_backoff = 0, 0.0
    if faults is not None:
        while faults.transfer_fails("handoff"):
            retries += 1
            t_backoff += faults.backoff_s(retries)
            if retries >= faults.plan.max_retries:
                raise RuntimeError(
                    f"handoff for request {req.request_id} failed "
                    f"{retries} consecutive attempts — link unreachable")
    t_ready = rec.t_emit + (1 + retries) * t_xfer + t_backoff
    dst.advance_to(t_ready)
    src.complete_handoff(rec)
    ledger.record(TransferRecord(
        request_id=req.request_id, src_engine=src_id, dst_engine=dst_id,
        n_pages=n_pages, bytes=n_pages * page_b,
        t_emit=rec.t_emit, t_ready=t_ready, retries=retries,
    ))
    return t_ready

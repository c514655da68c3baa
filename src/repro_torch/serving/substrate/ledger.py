"""Completion-tracked transfer ledger for the physical KV substrate (port
of `repro.serving.substrate.ledger`).

One `TransferEvent` per issued stream (see the package docstring for
the stream kinds). `bytes` is measured from the actual twin tensors'
`nbytes` — `page_bytes` here is handed in by `TierSubstrate` as
sum(leaf.nbytes / n_phys_pages) over the twin leaves, so the ledger
never re-derives footprint from model math. `placement_bytes()` is the
running host-resident footprint the engine's `phys_tiers()` pool
accounting must match after every drain.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

# stream kinds -> whether bytes actually move on the tier link.
# "retry" is a FAILED transfer attempt re-issued by the fault-recovery
# layer: the bytes crossed the link and were wasted, so they count as
# moved, but the pages never changed placement — the placement contract
# (`pool_bytes_used == placement_bytes`) stays exact through any number
# of retries.
KINDS = ("page_out", "page_in", "drop", "handoff", "retry")
_MOVES = {"page_out": True, "page_in": True, "drop": False,
          "handoff": True, "retry": True}
# placement delta (host-resident pages) per stream page
_PLACEMENT = {"page_out": +1, "page_in": -1, "drop": -1, "handoff": 0,
              "retry": 0}


@dataclasses.dataclass
class TransferEvent:
    step: int
    kind: str                   # one of KINDS
    n_pages: int
    bytes: float                # measured payload bytes on the stream
    mode: str                   # "physical" | "emulated"
    completed: bool = False
    # completion handles (objects with `synchronize()`): the stream's
    # `torch.cuda.Event` on the card, `HostDone` on the CPU; dropped on
    # sync()
    payload: Tuple = dataclasses.field(
        default=(), repr=False, compare=False)


class HostDone:
    """Completion handle of a stream that ran synchronously (on the CPU):
    nothing to wait on, but its event stays in flight until `sync()`, as
    the reference's does."""

    def synchronize(self) -> None:
        pass


class SubstrateLedger:
    """Append-only event log + running placement/byte counters."""

    def __init__(self, page_bytes: float, mode: str):
        self.page_bytes = float(page_bytes)
        self.mode = mode
        self.events: List[TransferEvent] = []
        self.resident_pages = 0
        self.bytes_by_kind = {k: 0.0 for k in KINDS}

    def record(self, kind: str, n_pages: int, *, step: int,
               payload: Tuple = ()) -> TransferEvent:
        if kind not in KINDS:
            raise ValueError(f"unknown stream kind {kind!r}; "
                             f"expected one of {KINDS}")
        moved = n_pages * self.page_bytes if _MOVES[kind] else 0.0
        ev = TransferEvent(
            step=step, kind=kind, n_pages=int(n_pages), bytes=moved,
            mode=self.mode, completed=not payload,
            payload=tuple(payload),
        )
        self.resident_pages += _PLACEMENT[kind] * ev.n_pages
        self.bytes_by_kind[kind] += moved
        self.events.append(ev)
        return ev

    def placement_bytes(self) -> float:
        """Host-resident pool footprint, from measured page bytes."""
        return self.resident_pages * self.page_bytes

    def sync(self) -> int:
        """Wait on every in-flight stream's completion handle; returns how
        many events this call completed. Payload references are dropped
        so the handles don't outlive their accounting."""
        n = 0
        for ev in self.events:
            if ev.completed:
                continue
            for item in ev.payload:
                if hasattr(item, "synchronize"):
                    item.synchronize()
            ev.payload = ()
            ev.completed = True
            n += 1
        return n

    def counters(self) -> dict:
        done = sum(1 for ev in self.events if ev.completed)
        return {
            "mode": self.mode,
            "events": len(self.events),
            "completed": done,
            "in_flight": len(self.events) - done,
            "resident_pages": self.resident_pages,
            "placement_bytes": self.placement_bytes(),
            **{f"{k}_bytes": v for k, v in self.bytes_by_kind.items()},
            **{f"{k}_pages": sum(ev.n_pages for ev in self.events
                                 if ev.kind == k) for k in KINDS},
        }

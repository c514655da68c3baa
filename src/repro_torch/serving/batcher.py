"""Slot bookkeeping for continuous batching.

The engine decodes a fixed batch of `n_slots` sequences; requests flow
through slots (admit on free, release on completion) so new prompts join
in-flight decode without ever changing the jitted cell's shapes. Inactive
slots park their write cursor at `park_pos` (>= cache length), which turns
the masked KV insert into a no-op (`models.attention._cache_insert` writes
nothing for out-of-range positions; the paged write path drops the scatter
the same way) — the "slot masking" half of the fixed-shape contract.

A slot has two phases. `decode` is the classic lane: the request was
prefilled in one shot (or finished its chunks) and generates one token per
engine step. `prefill` is the chunked-prefill lane: the slot is OCCUPIED
(it owns KV pages and blocks admission) but excluded from the decode
batch — its prompt advances one page-aligned chunk at a time, interleaved
with everyone else's decode steps, until `begin_decode` flips it live.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.serving.queue import Request


@dataclasses.dataclass
class Slot:
    index: int
    request: Optional[Request] = None
    t: int = 0                 # next cache write position (absolute)
    emitted: int = 0           # tokens generated so far (incl. prefill's)
    phase: str = "decode"      # "decode" | "prefill" (chunked prefill)
    prefill_pos: int = 0       # prompt tokens prefilled so far
    seq: int = -1              # admission order (FIFO chunk scheduling)

    @property
    def occupied(self) -> bool:
        return self.request is not None

    @property
    def active(self) -> bool:
        """In the decode batch (occupied AND past its prefill phase)."""
        return self.request is not None and self.phase == "decode"

    @property
    def prefilling(self) -> bool:
        return self.request is not None and self.phase == "prefill"


class ContinuousBatcher:
    """Fixed-slot admission/release with bucketed prefill shapes."""

    def __init__(self, n_slots: int, prefill_buckets: Sequence[int],
                 park_pos: int):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        self.n_slots = n_slots
        self.buckets = tuple(sorted(prefill_buckets))
        self.park_pos = park_pos
        self.slots: List[Slot] = [Slot(i) for i in range(n_slots)]
        self._free: List[int] = list(range(n_slots))[::-1]  # pop() -> slot 0
        self._seq = itertools.count()

    # ------------------------------------------------------------ buckets
    def bucket_for(self, prompt_len: int) -> int:
        """Prompts must land exactly on a bucket: SSM/conv state is a
        sequential reduction over the prompt, so right-padding would
        corrupt it — generators quantize lengths instead (see queue.py)."""
        if prompt_len not in self.buckets:
            raise ValueError(
                f"prompt_len {prompt_len} not in prefill buckets "
                f"{self.buckets}; quantize the stream"
            )
        return prompt_len

    # ----------------------------------------------------------- slots
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_active(self) -> int:
        return sum(1 for s in self.slots if s.active)

    @property
    def n_prefilling(self) -> int:
        return sum(1 for s in self.slots if s.prefilling)

    @property
    def n_busy(self) -> int:
        """Occupied slots (decode-active + mid-chunked-prefill)."""
        return self.n_slots - self.n_free

    def active_mask(self) -> np.ndarray:
        return np.array([s.active for s in self.slots], dtype=bool)

    def prefilling_slots(self) -> List[Slot]:
        """Mid-prefill slots in admission order (FIFO chunk scheduling)."""
        return sorted(
            (s for s in self.slots if s.prefilling), key=lambda s: s.seq
        )

    def admit(self, request: Request, start_pos: int,
              phase: str = "decode", prefill_pos: int = 0,
              emitted: Optional[int] = None) -> Slot:
        """`prefill_pos` (prefill phase only): first prompt token still to
        be prefilled — a prefix-cache hit maps the leading pages shared
        and starts chunking at the first divergent page instead of 0.
        `emitted` (decode phase only) overrides the default of 1 — the
        thaw/migration path resumes a request that already generated
        several tokens before it was preempted or its engine died."""
        if not self._free:
            raise RuntimeError("no free slot")
        slot = self.slots[self._free.pop()]
        slot.request = request
        slot.phase = phase
        slot.seq = next(self._seq)
        if phase == "decode":
            slot.t = start_pos
            # prefill emits the first token; a resumed slot picks up its
            # pre-preemption count
            slot.emitted = 1 if emitted is None else emitted
        else:
            slot.t = self.park_pos  # masked until begin_decode
            slot.emitted = 0
            slot.prefill_pos = prefill_pos
        return slot

    def begin_decode(self, slot: Slot, start_pos: int) -> None:
        """A chunked prefill finished: the slot joins the decode batch."""
        if not slot.prefilling:
            raise RuntimeError(f"slot {slot.index} is not prefilling")
        slot.phase = "decode"
        slot.t = start_pos
        slot.emitted = 1
        slot.prefill_pos = 0

    def release(self, slot: Slot) -> Request:
        req = slot.request
        if req is None:
            raise RuntimeError(f"slot {slot.index} already free")
        slot.request = None
        slot.t = self.park_pos
        slot.emitted = 0
        slot.phase = "decode"
        slot.prefill_pos = 0
        slot.seq = -1
        self._free.append(slot.index)
        return req

    # ------------------------------------------------------- step arrays
    def t_vector(self) -> np.ndarray:
        """Per-slot write positions; inactive (free or still-prefilling)
        slots parked out of range so their cache writes mask away."""
        return np.array(
            [s.t if s.active else self.park_pos for s in self.slots],
            dtype=np.int32,
        )

    def advance(self, counts: Optional[np.ndarray] = None) -> None:
        """Advance every active slot's cursor: by 1 (plain greedy decode)
        or by `counts[slot.index]` tokens (speculative decode — one
        verify step commits `1 + accepted` tokens per slot)."""
        for s in self.slots:
            if s.active:
                n = 1 if counts is None else int(counts[s.index])
                s.t += n
                s.emitted += n

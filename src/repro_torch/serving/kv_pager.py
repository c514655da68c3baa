"""Paged tier-aware KV-cache manager (copy of `repro.serving.kv_pager`,
numpy only) — the serving realization of the paper's page-grain
placement on top of the framework's tier model.

The decode caches of the in-flight batch are divided into fixed-size pages
(`page_tokens` tokens of self-attention K/V per slot). Each page lives in
one tier: `local` (HBM) or `pool` (pinned host memory behind the PCIe
link). Per decode step the pager derives each page's access weight from
the hot-tail/cold-prefix decode traffic model (`core.access`), charges the
step's bytes to the tier each page occupies, and under the `hotness`
policy re-places pages with the paper's placement engine
(`core.placement.place`).

Policies: hotness (hot tail local, cold prefix evicted to the pool),
static (first-come local until the budget fills — the no-paging
baseline), none (no local budget).

The pager is the serving stack's single PAGE ALLOCATOR: every valid
(slot, page) owns a physical page id from a shared free list, and
`block_table()` emits the logical->physical map the engine's paged cells
read and write the pool through (the paged decode kernel, the prefill
insert's page writer). Tables may alias (refcounted pages, `pin`/`unpin`,
`map_shared`/`remap_shared`, copy-on-write `cow_split`); shared bytes are
accounted once. Under free-list pressure the allocator calls back into
the engine's shared-prefix trie (`prefix_cache`) to reclaim cached pages.

Slots can be preempted and restored (`freeze` / `thaw` / `drop_frozen`):
a pinned freeze keeps the slot's pages under a freeze hold, retagged
pool tier, and a spilled one releases them.

Pool-read accounting has two modes:

* `prefetch=None` (default): expected-value weighted accounting; all
  pool reads are ASSUMED layer-ahead prefetchable, so the engine
  overlaps pool time with compute.
* `prefetch=<predictor>` (prediction-driven page-in, `repro_torch.
  prefetch`): the cold prefix is touched on a DISCRETE deterministic
  schedule (mean rate = `cold_touch`) and every pool touch is classified
  — staged ahead by the predictor (overlappable) or a demand page-in
  (the engine serializes it). `prefetch="demand"` is the null predictor,
  the demand-paging baseline. Mispredicted stages are excess pool-link
  traffic (`counters()["prefetch_excess_bytes"]`). Staging is
  accounting, as in the reference: the substrate moves pages by tier
  changes, not by predictions.

An optional `recorder` (`prefetch.trace.TraceRecorder`) captures the
discrete page-touch stream for offline predictor scoring in either mode.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core import placement as plc
from repro_torch.core import tiers as tr
from repro_torch.core.access import DECODE_COLD_TOUCH, DECODE_HOT_WINDOW, \
    TensorAccess

LOCAL, POOL = 0, 1


@dataclasses.dataclass(frozen=True)
class PagerConfig:
    page_tokens: int = 32
    local_budget_bytes: Optional[float] = None   # None -> unbounded (no
    # eviction pressure; the "none" policy forces this)
    policy: str = "hotness"                      # hotness | static | none
    hot_window: int = DECODE_HOT_WINDOW          # tokens read at full rate
    cold_touch: float = DECODE_COLD_TOUCH        # cold-prefix touch/step
    rebalance_every: int = 1                     # steps between re-places
    # --- prediction-driven page-in (repro.prefetch) ---
    prefetch: Optional[str] = None   # predictor name | "demand" | None
    prefetch_degree: int = 8         # max pages staged ahead per step
    # --- debug-mode consistency checking ---
    validate: bool = False           # cross-check frees vs the block table
    # (a freed page still mapped by a live slot raises instead of being
    # silently recycled into a second owner)

    def __post_init__(self):
        if self.policy not in ("hotness", "static", "none"):
            raise ValueError(f"unknown pager policy {self.policy!r}")
        if self.page_tokens < 1:
            raise ValueError("page_tokens must be >= 1")
        if self.prefetch is not None and self.prefetch not in (
                "demand", "next_line", "stride", "stream", "markov",
                "ghb", "adaptive"):
            raise ValueError(
                f"pager prefetch {self.prefetch!r} must be a stream-"
                "learnable predictor (or 'demand'/'adaptive'); "
                "'static'/'frontier' need schedules/hints the pager "
                "does not have"
            )

    @property
    def cold_period(self) -> int:
        """Steps between discrete touches of one cold page (mean rate
        matches the weighted model's `cold_touch`)."""
        return max(1, int(round(1.0 / max(self.cold_touch, 1e-9))))


@dataclasses.dataclass
class StepTraffic:
    local_bytes: float
    pool_bytes: float
    # split of pool_bytes under prediction-driven page-in: staged-ahead
    # transfers overlap compute; demand page-ins serialize. The legacy
    # weighted mode reports everything as prefetchable (the old model).
    demand_pool_bytes: float = 0.0
    prefetch_pool_bytes: float = 0.0

    @property
    def total(self) -> float:
        return self.local_bytes + self.pool_bytes


class KVPager:
    """Page table + tier accounting for `n_slots` in-flight sequences.

    `bytes_per_token`: self-attention K/V bytes per cached token per slot.
    `resident_bytes`: per-slot non-paged state (SSM state, conv tails,
    cross-attention KV) — pinned local, read whole every step.
    """

    def __init__(self, n_slots: int, max_seq: int, bytes_per_token: float,
                 resident_bytes: float, pcfg: PagerConfig,
                 topo: Optional[tr.TierTopology] = None):
        self.cfg = pcfg
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.bytes_per_token = float(bytes_per_token)
        self.resident_bytes = float(resident_bytes)
        self.page_bytes = self.bytes_per_token * pcfg.page_tokens
        self.n_pages = -(-max_seq // pcfg.page_tokens)  # ceil
        self.n_phys = n_slots * self.n_pages
        self.topo = topo or tr.h100_topology()

        self.valid = np.zeros((n_slots, self.n_pages), dtype=bool)
        self.lengths = np.zeros(n_slots, dtype=np.int64)
        # physical page ids: every valid (slot, page) maps to one from a
        # shared LIFO free list — interleaved admissions scatter a slot's
        # pages through the pool, which is exactly what the paged decode
        # kernel's block-index map exists for. Tables may ALIAS: `ref`
        # counts mappings (slot entries + pins) per physical page; a page
        # returns to the free list only when its refcount hits zero.
        self.phys = np.full((n_slots, self.n_pages), -1, dtype=np.int64)
        self.ref = np.zeros(self.n_phys, dtype=np.int32)
        self.tier_phys = np.full(self.n_phys, LOCAL, dtype=np.int8)
        self.pins = 0                 # non-slot refs (trie + guard pins)
        self._free_phys = list(range(self.n_phys))
        self._bt_cache: Optional[np.ndarray] = None
        # the engine wires a `serving.prefix_cache.PrefixCache` here; the
        # allocator calls back into it to reclaim trie-only pages when the
        # free list runs dry (LRU leaf eviction)
        self.prefix_cache = None

        self._steps = 0
        self.total_local_bytes = 0.0
        self.total_pool_bytes = 0.0
        self.total_demand_pool_bytes = 0.0
        self.total_prefetch_pool_bytes = 0.0
        self.evictions = 0
        self.promotions = 0
        self.prefetch_issued = 0
        self.prefetch_useful = 0
        self.cow_splits = 0
        self.shared_mapped_pages = 0
        self.freezes = 0              # slot preemptions (`freeze`)
        self.thaws = 0                # pinned snapshots restored (`thaw`)
        # COW copy traffic (read old + write new) accumulates here and is
        # charged by the next `step` at the page's tier — the engine COWs
        # via `ensure_tail_pages` BEFORE the decode cell, so the bytes
        # land in that step's accounting
        self._cow_local_pending = 0.0
        self._cow_pool_pending = 0.0
        self.recorder = None          # optional prefetch.trace.TraceRecorder
        self._predictor = None
        self._staged: set = set()     # (slot, page) staged ahead, untouched
        if pcfg.prefetch is not None:
            from repro_torch.prefetch.predictors import make_predictor

            if pcfg.prefetch == "stream":
                # one stream region per slot: global page ids are
                # slot-major, so each slot's cold walk is its own stream
                self._predictor = make_predictor(
                    "stream", region_pages=self.n_pages,
                    max_streams=max(n_slots, 2),
                )
            else:
                self._predictor = make_predictor(pcfg.prefetch)

    # ------------------------------------------------------------ budget
    @property
    def budget(self) -> float:
        if self.cfg.policy == "none" or self.cfg.local_budget_bytes is None:
            return float("inf")
        return float(self.cfg.local_budget_bytes)

    @property
    def tier(self) -> np.ndarray:
        """(n_slots, n_pages) tier of each mapped table entry — a derived
        READ-ONLY view now that tiers live per physical page (aliased
        entries must agree by construction). Invalid entries read LOCAL."""
        return np.where(
            self.valid, self.tier_phys[np.clip(self.phys, 0, None)],
            np.int8(LOCAL),
        )

    def local_bytes_used(self) -> float:
        """Deduplicated local-tier footprint: each live PHYSICAL page is
        counted once no matter how many slots map it."""
        return float(((self.ref > 0) & (self.tier_phys == LOCAL)).sum()
                     * self.page_bytes)

    def pool_bytes_used(self) -> float:
        return float(((self.ref > 0) & (self.tier_phys == POOL)).sum()
                     * self.page_bytes)

    def pool_page_ids(self) -> np.ndarray:
        """Physical ids of live pool-resident pages — the reconciliation
        target set the serving substrate (`serving.substrate`) mirrors
        into its host twin each step. Dedup rules match
        `pool_bytes_used`: a physical page counts once however many
        slot/trie mappings alias it, so after a drain the substrate
        ledger's placement_bytes equals pool_bytes_used exactly."""
        return np.nonzero((self.ref > 0) & (self.tier_phys == POOL))[0]

    # --------------------------------------------------------- lifecycle
    def _take_free(self, k: int) -> List[int]:
        """Pop `k` physical pages off the LIFO free-list tail, in the same
        order the old per-page pop() walked it (determinism: block tables
        replay identically across runs). Under free-list pressure the
        prefix trie gives back LRU cached pages first — trie-only pages
        are clean read copies, always safe to drop."""
        if len(self._free_phys) < k and self.prefix_cache is not None:
            self.prefix_cache.reclaim(self, k - len(self._free_phys))
        if len(self._free_phys) < k:
            raise RuntimeError(
                f"page pool exhausted: need {k}, "
                f"free {len(self._free_phys)}"
            )
        taken = self._free_phys[-k:]
        del self._free_phys[-k:]
        return taken[::-1]

    def _alloc_pages(self, slot: int, upto_page: int) -> None:
        """Mark pages [0, upto_page) of `slot` valid; new pages are
        PRIVATE (ref = 1) and start in the tier the policy dictates."""
        newly = ~self.valid[slot, :upto_page]
        if not newly.any():
            return
        self._bt_cache = None
        pages = np.nonzero(newly)[0]
        taken = self._take_free(len(pages))
        self.phys[slot, pages] = taken
        if self.cfg.policy == "static":
            # first-come local until the budget fills; permanent thereafter
            for p, g in zip(pages, taken):
                fits = (self.local_bytes_used() + self.page_bytes
                        <= self.budget)
                self.tier_phys[g] = LOCAL if fits else POOL
                self.ref[g] = 1
                self.valid[slot, p] = True
        else:
            # hotness/none: allocate local (the tail is the hot end); the
            # next rebalance evicts whatever the budget cannot hold
            self.tier_phys[taken] = LOCAL
            self.ref[taken] = 1
            self.valid[slot, :upto_page] = True

    def admit(self, slot: int, length: int) -> None:
        """A prefilled request enters `slot` with `length` cached tokens."""
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range")
        self.release(slot)
        self.extend(slot, length)

    def extend(self, slot: int, length: int) -> None:
        """Grow `slot` to `length` cached tokens without releasing it —
        the chunked-prefill path: each chunk extends the slot by one
        page-aligned chunk BEFORE the chunk cell writes through the block
        table, so the pages it scatters into are always live. Pages
        already mapped (including shared prefix pages) are kept."""
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range")
        if length <= self.lengths[slot]:
            return
        self.lengths[slot] = length
        self._alloc_pages(slot, self._page_of(length - 1) + 1)
        if self.cfg.policy == "hotness":
            self.rebalance()

    # ---------------------------------------------------------- sharing
    def pin(self, pages) -> None:
        """Take a non-slot reference on `pages` (the prefix trie's hold on
        its cached pages; also the engine's guard pin between trie match
        and table remap, so an allocation in between cannot reclaim the
        matched pages out from under the hit)."""
        pages = np.asarray(pages, dtype=np.int64)
        if pages.size == 0:
            return
        if self.cfg.validate and (self.ref[pages] <= 0).any():
            raise RuntimeError("pin of a free physical page")
        self.ref[pages] += 1
        self.pins += int(pages.size)

    def unpin(self, pages) -> None:
        """Drop a pin; pages whose refcount hits zero return to the free
        list (order-preserving, batched)."""
        pages = np.asarray(pages, dtype=np.int64)
        if pages.size == 0:
            return
        self.ref[pages] -= 1
        self.pins -= int(pages.size)
        if self.cfg.validate and (self.ref[pages] < 0).any():
            raise RuntimeError("unpin without a matching pin")
        dead = pages[self.ref[pages] == 0]
        if dead.size:
            if self.cfg.validate:
                self._validate_freed(dead)
            self._free_phys.extend(dead.tolist())

    def map_shared(self, slot: int, pages, n_tokens: int) -> None:
        """Map already-cached `pages` (physical ids, logical order) as the
        leading table entries of freshly admitted `slot`, increffing each —
        the prefix-cache HIT path. The slot's cached length becomes
        `n_tokens`; chunked prefill then starts at the first divergent
        page instead of token 0."""
        pages = np.asarray(pages, dtype=np.int64)
        k = int(pages.size)
        if k == 0:
            return
        if self.cfg.validate:
            if self.valid[slot, :k].any():
                raise RuntimeError("map_shared into a non-fresh slot")
            if (self.ref[pages] <= 0).any():
                raise RuntimeError("map_shared of a free physical page")
        self._bt_cache = None
        self.phys[slot, :k] = pages
        self.valid[slot, :k] = True
        self.ref[pages] += 1
        self.lengths[slot] = max(int(self.lengths[slot]), int(n_tokens))
        self.shared_mapped_pages += k
        if self.cfg.policy == "hotness":
            self.rebalance()

    def remap_shared(self, slot: int, pages) -> None:
        """Swap the leading logical pages of `slot` onto already-cached
        physical `pages`, freeing the slot's private duplicates — the
        insert-then-dedupe path for bucketed (single-shot) prefill: the
        fused insert scatters into freshly allocated private pages (its
        kernel contract demands uniquely owned targets), then the matched
        prefix deduplicates against the trie's identical copies."""
        tgt = np.asarray(pages, dtype=np.int64)
        k = int(tgt.size)
        if k == 0:
            return
        if self.cfg.validate and not self.valid[slot, :k].all():
            raise RuntimeError("remap_shared past the slot's mapped pages")
        cur = self.phys[slot, :k].copy()
        diff = cur != tgt
        if not diff.any():
            return
        self._bt_cache = None
        self.ref[tgt[diff]] += 1
        self.phys[slot, :k][diff] = tgt[diff]
        old = cur[diff]
        self.ref[old] -= 1
        dead = old[self.ref[old] == 0]
        if dead.size:
            if self.cfg.validate:
                self._validate_freed(dead)
            self._free_phys.extend(dead.tolist())
        self.shared_mapped_pages += int(diff.sum())

    def cow_split(self, slot: int, page: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write: `slot` is about to write into logical `page`
        whose physical page is shared (ref > 1). Take a free page, repoint
        the writer at it, decref the shared original, and return the
        (old_phys, new_phys) pair so the engine can run its page-copy cell
        — the shared page itself is NEVER mutated. Returns None when the
        page is already private."""
        old = int(self.phys[slot, page])
        if self.ref[old] <= 1:
            return None
        new = self._take_free(1)[0]
        self._bt_cache = None
        self.ref[old] -= 1
        self.ref[new] = 1
        self.tier_phys[new] = self.tier_phys[old]
        self.phys[slot, page] = new
        self.cow_splits += 1
        # the copy reads the shared page and writes the private one, both
        # at the page's tier; charged by the next step()
        if self.tier_phys[new] == POOL:
            self._cow_pool_pending += 2.0 * self.page_bytes
        else:
            self._cow_local_pending += 2.0 * self.page_bytes
        return (old, new)

    def ensure_tail_pages(self, active: np.ndarray,
                          lookahead: int = 1) -> List[Tuple[int, int]]:
        """Make every active slot's next `lookahead` write-position pages
        PRIVATE and live — called by the engine BEFORE the paged decode
        cell so the block table it passes already names physical pages
        the slot exclusively owns for the tokens about to be written
        (`step` allocates/splits lazily otherwise, which is too late for
        a layout that is real on device). `lookahead=1` covers plain
        greedy decode (the single tail token); the speculative engine
        passes `lookahead=spec_k` so all k candidate rows of the verify
        cell land in live private pages (only the first page can be
        shared — pages past the tail are fresh allocations — but the COW
        check runs over the whole window anyway). Pages a partial
        acceptance leaves unused are rolled back by `truncate`. Returns
        the (old_phys, new_phys) COW pairs the engine must copy before
        the write."""
        cow: List[Tuple[int, int]] = []
        for s in np.nonzero(np.asarray(active, dtype=bool))[0]:
            lo = self._page_of(int(self.lengths[s]))
            hi = self._page_of(int(self.lengths[s]) + lookahead - 1)
            for p in range(lo, min(hi, self.n_pages - 1) + 1):
                if not self.valid[s, p]:
                    self._alloc_pages(int(s), p + 1)
                elif self.ref[self.phys[s, p]] > 1:
                    pair = self.cow_split(int(s), p)
                    if pair is not None:
                        cow.append(pair)
        return cow

    def truncate(self, slot: int) -> int:
        """Roll back `slot`'s page table to its committed length:
        release every valid page wholly beyond `lengths[slot]` — the
        speculative-decode rollback. A partially accepted verify step
        leaves the pages `ensure_tail_pages(lookahead=k)` allocated for
        the rejected candidates mapped but unused (and their KV content
        is garbage beyond the frontier, which every kernel masks); this
        returns them to the free list so the pool footprint tracks
        ACCEPTED tokens, not proposed ones. The pages are private by
        construction (fresh allocations or COW splits), but the release
        is refcounted like every other decref anyway. Returns the number
        of table entries dropped."""
        length = int(self.lengths[slot])
        first_keep = 0 if length <= 0 else self._page_of(length - 1) + 1
        drop = np.nonzero(self.valid[slot, first_keep:])[0] + first_keep
        if drop.size == 0:
            return 0
        self._bt_cache = None
        pages = self.phys[slot, drop]
        self.ref[pages] -= 1
        if self.cfg.validate and (self.ref[pages] < 0).any():
            raise RuntimeError(
                f"truncate: slot {slot} released a page whose refcount "
                "was already zero"
            )
        self.valid[slot, drop] = False
        self.phys[slot, drop] = -1
        dead = pages[self.ref[pages] == 0]
        if dead.size:
            if self.cfg.validate:
                self._validate_freed(dead)
            self._free_phys.extend(dead.tolist())
        if self._staged:
            dropped = set(drop.tolist())
            self._staged = {
                (s, p) for (s, p) in self._staged
                if not (s == slot and p in dropped)
            }
        return int(drop.size)

    # ------------------------------------------------- preempt / restore
    def freeze(self, slot: int, *, spill: bool = False) -> dict:
        """Preempt `slot`: snapshot its table and give the slot back.

        Default (``spill=False``) — the cheap paged preemption: the
        slot's pages are pinned (a non-slot "freeze hold" reference,
        exactly like the prefix trie's), evicted WHOLESALE to the pool
        tier (the next substrate drain pages them out to the host twin),
        and the slot itself is released for another request. The
        returned snapshot names the physical pages in logical order;
        `thaw` remaps them into a fresh slot with the KV content intact —
        no recompute.

        ``spill=True`` — forfeit the pages entirely (the
        pool-exhaustion preemption path, where keeping them would defeat
        the point): the slot is released, its pages return to the free
        list, and the snapshot carries ``pages=None`` — restoring
        requires a teacher-forced refill of prompt + emitted history.

        Either way the refcount cover invariant
        (`ref.sum() == valid.sum() + pins`) holds throughout, so
        `validate=True` stays green across any preempt/restore
        interleaving.
        """
        length = int(self.lengths[slot])
        owned = np.nonzero(self.valid[slot])[0]
        if owned.size == 0 or (owned != np.arange(owned.size)).any():
            raise RuntimeError(
                f"freeze: slot {slot} table is empty or non-contiguous")
        self.freezes += 1
        if spill:
            self.release(slot)
            return {"pages": None, "length": length}
        pages = self.phys[slot, owned].copy()
        self.pin(pages)
        if np.isfinite(self.budget):
            # wholesale eviction to the pool tier; a budget-less pager
            # (policy "none") has no pool to evict to — the pages just
            # sit pinned in local memory
            self.tier_phys[pages] = POOL
        self.release(slot)
        return {"pages": pages, "length": length}

    def thaw(self, slot: int, snap: dict) -> None:
        """Restore a frozen snapshot into fresh `slot`: remap the held
        pages as the slot's leading table entries and drop the freeze
        hold. The hotness rebalancer re-promotes the hot tail on the
        next step; until then reads hit the pool tier (the restore cost
        the virtual clock prices)."""
        pages = snap["pages"]
        if pages is None:
            raise ValueError(
                "thaw of a spilled snapshot — the KV content is gone; "
                "restore via teacher-forced refill instead")
        self.map_shared(slot, pages, snap["length"])
        # map_shared counts toward the prefix-dedup stat; a thaw is a
        # restore, not a dedup — keep the stat's meaning
        self.shared_mapped_pages -= int(np.asarray(pages).size)
        self.unpin(pages)
        self.thaws += 1

    def drop_frozen(self, snap: dict) -> None:
        """Abandon a frozen snapshot (cancelled or migrated request):
        drop the freeze hold so unshared pages return to the free
        list."""
        if snap["pages"] is not None:
            self.unpin(snap["pages"])

    def release(self, slot: int) -> None:
        """Decref a finished/evicted slot's pages in ONE batched call;
        pages whose refcount hits zero return to the free list (order-
        preserving — shared prefix pages survive under the trie's pin or
        another slot's mapping)."""
        owned = self.valid[slot]
        if owned.any():
            self._bt_cache = None
            pages = self.phys[slot, owned]
            self.ref[pages] -= 1
            if self.cfg.validate and (self.ref[pages] < 0).any():
                raise RuntimeError(
                    f"double free: slot {slot} released a page whose "
                    "refcount was already zero"
                )
            dead = pages[self.ref[pages] == 0]
            if dead.size:
                if self.cfg.validate:
                    self._validate_freed(dead, skip_slot=slot)
                self._free_phys.extend(dead.tolist())
        self.phys[slot, :] = -1
        self.valid[slot, :] = False
        self.lengths[slot] = 0
        self._staged = {(s, p) for (s, p) in self._staged if s != slot}

    def _validate_freed(self, dead: np.ndarray,
                        skip_slot: Optional[int] = None) -> None:
        """Debug-mode liveness cross-check (`PagerConfig.validate`): a
        page about to re-enter the free list must not be mapped by any
        live block-table entry — a stale table entry would silently hand
        the recycled page a second owner and corrupt both sequences."""
        if dead.size == 0:
            return
        mask = self.valid.copy()
        if skip_slot is not None:
            mask[skip_slot] = False     # the releasing slot's own entries
        live = self.phys[mask]
        bad = np.intersect1d(dead, live)
        if bad.size:
            raise RuntimeError(
                f"pager free: physical pages {bad.tolist()} returned to "
                "the free list while still mapped in the block table "
                "(stale-entry reuse)"
            )

    def _page_of(self, pos: int) -> int:
        return max(int(pos), 0) // self.cfg.page_tokens

    def block_table(self) -> np.ndarray:
        """(n_slots, n_pages) logical->physical page map for the paged
        kernels (`kernels.decode_attention.ops.paged_decode_mha`,
        `kernels.flash_attention.ops.paged_prefill_mha`) AND the engine's
        paged cache-write cells. Invalid entries are 0 — the kernels'
        length/causal masks keep them out of the math (ops clamps
        identically). Rows may alias (shared prefixes): the gather path
        reads aliased pages fine; the WRITE paths never see an aliased
        target because `ensure_tail_pages`/`remap_shared` guarantee write
        pages are private before any scatter. The returned array is
        cached until the mapping changes (steady-state decode re-reads
        the same object, so the engine can skip the device upload by
        identity); treat it as read-only."""
        if self._bt_cache is None:
            self._bt_cache = np.where(self.valid, self.phys, 0).astype(
                np.int32)
        return self._bt_cache

    def phys_tiers(self) -> np.ndarray:
        """(n_slots * n_pages,) tier tag of every PHYSICAL page: LOCAL /
        POOL for live pages (ref > 0, slot-mapped or trie-cached), -1 for
        free-list pages. The physical-pool view of the tier split — what
        the byte accounting charges and what a memory-kind-capable
        backend would pin each page to. Shared pages appear ONCE here by
        construction (the deduplicated footprint)."""
        return np.where(self.ref > 0, self.tier_phys,
                        np.int8(-1)).astype(np.int8)

    # ------------------------------------------------------ access model
    def _page_weights(self) -> np.ndarray:
        """(n_slots, n_pages) per-step touch weight of each valid page
        under the hot-tail/cold-prefix model, fractional at the hot/cold
        page boundary."""
        starts = np.arange(self.n_pages) * self.cfg.page_tokens
        ends = starts + self.cfg.page_tokens
        hot_lo = self.lengths[:, None] - self.cfg.hot_window
        # tokens of each page inside [hot_lo, length)
        hot_tokens = np.clip(
            np.minimum(ends[None, :], self.lengths[:, None])
            - np.maximum(starts[None, :], hot_lo),
            0, self.cfg.page_tokens,
        )
        frac_hot = hot_tokens / self.cfg.page_tokens
        w = frac_hot + (1.0 - frac_hot) * self.cfg.cold_touch
        return np.where(self.valid, w, 0.0)

    def _discrete_touches(self, active: np.ndarray) -> list:
        """Deterministic per-step page-touch list [(slot, page), ...]:
        hot-tail pages every step, cold-prefix pages on a round-robin of
        period `cold_period` (page p of any slot is touched at steps
        where p ≡ step (mod period), so the touched cold set walks +1
        page per step — the same mean rate as the weighted model, made
        observable)."""
        period = self.cfg.cold_period
        touches = []
        for s in np.nonzero(active)[0]:
            length = int(self.lengths[s])
            if length <= 0:
                continue
            last = self._page_of(length - 1)
            hot_lo = self._page_of(max(length - self.cfg.hot_window, 0))
            for p in range(hot_lo, last + 1):
                if self.valid[s, p]:
                    touches.append((int(s), p, False))
            for p in range(0, hot_lo):
                if self.valid[s, p] and (p - self._steps) % period == 0:
                    touches.append((int(s), p, True))
        return touches

    def _gid(self, slot: int, page: int) -> int:
        return slot * self.n_pages + page

    def step(self, active: np.ndarray,
             tokens: Optional[np.ndarray] = None) -> StepTraffic:
        """Account one decode step for the `active` slot mask: reads per
        the traffic model against current page tiers, plus the new token's
        KV write into its (tail) page and the resident state. Pending COW
        copy bytes (splits since the last step) are flushed here.

        `tokens` (n_slots,) commits a PER-SLOT token count instead of 1 —
        the speculative-verify path: one verify call emits `1 + accepted`
        tokens per slot but sweeps the pool-resident pages ONCE, so the
        read side of this accounting is charged once per call while the
        lengths (and tail writes) advance by `tokens[s]`. That read-once/
        advance-many asymmetry IS the speculative speedup under the
        paper's corridor: decode traffic is page reads, and amortizing a
        sweep over the acceptance length divides the bytes per emitted
        token by it. (Rejected candidate rows also wrote KV, but those
        are overwritten in place before ever being read — sub-token
        noise against the per-step page sweep, excluded by the model.)"""
        active = np.asarray(active, dtype=bool)
        touches = None
        if self.recorder is not None or self._predictor is not None:
            touches = self._discrete_touches(active)
            if self.recorder is not None:
                self.recorder.record(
                    self._gid(s, p) for s, p, _ in touches
                )

        demand_b = staged_b = 0.0
        if self._predictor is None:
            # expected-value weighted accounting (the pre-subsystem
            # model); every pool byte is assumed layer-ahead prefetchable
            tier = self.tier
            w = self._page_weights() * active[:, None]
            local_r = float(
                (w * (tier == LOCAL)).sum() * self.page_bytes
            )
            pool_r = float(
                (w * (tier == POOL)).sum() * self.page_bytes
            )
        else:
            # discrete prediction-driven paging: each pool touch is a
            # demand page-in unless the predictor staged it ahead. Only
            # the COLD walk feeds the predictor — hot-tail touches are
            # local by placement and move with the tail; they are not
            # page-in candidates and would only pollute the stream the
            # predictor must learn.
            local_r = pool_r = 0.0
            for s, p, cold in touches:
                if self.tier_phys[self.phys[s, p]] == LOCAL:
                    local_r += self.page_bytes
                elif (s, p) in self._staged:
                    self._staged.discard((s, p))
                    self.prefetch_useful += 1
                    local_r += self.page_bytes   # staged copy: local read
                else:
                    demand_b += self.page_bytes
                if cold:
                    self._predictor.observe(self._gid(s, p))
            # stage the predictor's forecast for the NEXT step's touches:
            # the transfer crosses the pool link now (overlapped with
            # compute); mispredictions become excess link traffic
            self._predictor.start_step()
            for gid in self._predictor.predict(self.cfg.prefetch_degree):
                s, p = divmod(int(gid), self.n_pages)
                if (0 <= s < self.n_slots and 0 <= p < self.n_pages
                        and self.valid[s, p]
                        and self.tier_phys[self.phys[s, p]] == POOL
                        and (s, p) not in self._staged):
                    self._staged.add((s, p))
                    self.prefetch_issued += 1
                    staged_b += self.page_bytes

        # tokens[s] (default 1) tokens of KV written at the tail of each
        # active slot — each write page must be private, so a shared tail
        # page splits first (COW; never mutate a page with ref > 1)
        wr_local = wr_pool = 0.0
        counts = None if tokens is None else np.asarray(tokens)
        for s in np.nonzero(active)[0]:
            n_s = 1 if counts is None else int(counts[s])
            for _ in range(n_s):
                p = self._page_of(int(self.lengths[s]))  # write pos == len
                if p >= self.n_pages:
                    break
                if not self.valid[s, p]:
                    self._alloc_pages(int(s), p + 1)
                elif self.ref[self.phys[s, p]] > 1:
                    self.cow_split(int(s), p)
                if self.tier_phys[self.phys[s, p]] == POOL:
                    wr_pool += self.bytes_per_token
                else:
                    wr_local += self.bytes_per_token
                self.lengths[s] += 1
        cow_local, cow_pool = self._cow_local_pending, self._cow_pool_pending
        self._cow_local_pending = self._cow_pool_pending = 0.0
        local_b = (local_r + wr_local + cow_local
                   + self.resident_bytes * active.sum())
        pool_b = pool_r + wr_pool + demand_b + staged_b + cow_pool

        self._steps += 1
        if (self.cfg.policy == "hotness"
                and self._steps % self.cfg.rebalance_every == 0):
            self.rebalance()

        self.total_local_bytes += local_b
        self.total_pool_bytes += pool_b
        if self._predictor is None:
            # legacy overlap assumption: all pool traffic prefetchable
            demand, staged = 0.0, pool_b
        else:
            # COW pool copies serialize like demand page-ins: the split
            # must land before the write the decode cell is about to do
            demand = demand_b + wr_pool + cow_pool
            staged = staged_b
        self.total_demand_pool_bytes += demand
        self.total_prefetch_pool_bytes += staged
        return StepTraffic(local_b, pool_b, demand, staged)

    # --------------------------------------------------------- placement
    def rebalance(self) -> None:
        """Re-place live pages with the paper's placement engine: build a
        PHYSICAL-page-grain access profile and run the `hotness` policy
        against the local budget — the exact analogue of
        `runtime/tiering.py` applying `core.placement` to training state
        at tensor grain. A shared page's weight is the SUM of its
        sharers' touch weights (ten sharers of a prefix page make it ten
        times hotter than any single copy — dedup concentrates heat);
        trie-only pages carry no slot weight and drift poolward first."""
        owned = np.nonzero(self.ref > 0)[0]
        n_owned = len(owned)
        if (n_owned == 0 or not np.isfinite(self.budget)
                or self.page_bytes <= 0):
            return  # nothing paged (e.g. SSM-only archs: no self-attn KV)
        w_sp = self._page_weights()
        wg = np.zeros(self.n_phys)
        np.add.at(wg, self.phys[self.valid], w_sp[self.valid])
        # epsilon recency gradient: among equal-weight cold pages, evict
        # the oldest first (LRU within the cold class) — recency of a
        # shared page is its NEWEST mapping; placement-only, never part
        # of traffic accounting
        rec = np.zeros(self.n_phys)
        s_idx, p_idx = np.nonzero(self.valid)
        if s_idx.size:
            np.maximum.at(rec, self.phys[s_idx, p_idx], p_idx + 1)
        eps = 1e-9 / max(self.n_pages, 1)
        profile = [
            TensorAccess(f"g{g}", int(self.page_bytes),
                         float(wg[g]) + eps * float(rec[g]), "cache")
            for g in owned
        ]
        total = n_owned * self.page_bytes
        pool_fraction = max(0.0, 1.0 - self.budget / total)
        place = plc.place(profile, self.topo, "hotness", pool_fraction)
        before = self.tier_phys.copy()
        for g, a in zip(owned, profile):
            self.tier_phys[g] = (
                LOCAL if place.tier_of(a.name) == "hbm" else POOL
            )
        moved = (before != self.tier_phys) & (self.ref > 0)
        self.evictions += int((moved & (self.tier_phys == POOL)).sum())
        self.promotions += int((moved & (self.tier_phys == LOCAL)).sum())
        if self._staged:
            # a staged copy whose page got promoted (or freed) is moot
            self._staged = {
                (s, p) for (s, p) in self._staged
                if self.valid[s, p]
                and self.tier_phys[self.phys[s, p]] == POOL
            }

    # ----------------------------------------------------------- metrics
    def remote_share(self) -> float:
        """Pool-tier share of cumulative cache traffic (the acceptance
        metric: tier-aware paging must push this down)."""
        total = self.total_local_bytes + self.total_pool_bytes
        return self.total_pool_bytes / total if total else 0.0

    def demand_share(self) -> float:
        """Share of cumulative traffic that STALLS on the pool tier
        (demand page-ins; staged transfers overlap compute). Prediction-
        driven page-in must push this down vs the 'demand' baseline."""
        total = self.total_local_bytes + self.total_pool_bytes
        return self.total_demand_pool_bytes / total if total else 0.0

    def counters(self) -> dict:
        return {
            "steps": self._steps,
            "local_bytes": self.total_local_bytes,
            "pool_bytes": self.total_pool_bytes,
            "demand_pool_bytes": self.total_demand_pool_bytes,
            "prefetch_pool_bytes": self.total_prefetch_pool_bytes,
            "remote_share": self.remote_share(),
            "demand_share": self.demand_share(),
            "evictions": self.evictions,
            "promotions": self.promotions,
            "prefetch_issued": self.prefetch_issued,
            "prefetch_useful": self.prefetch_useful,
            "prefetch_excess_bytes": (
                (self.prefetch_issued - self.prefetch_useful)
                * self.page_bytes
            ),
            "local_used": self.local_bytes_used(),
            "pool_used": self.pool_bytes_used(),
            "cow_splits": self.cow_splits,
            "shared_mapped_pages": self.shared_mapped_pages,
            "freezes": self.freezes,
            "thaws": self.thaws,
            "pins": self.pins,
            "free_pages": len(self._free_phys),
        }

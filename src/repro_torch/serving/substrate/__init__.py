"""Physical memory substrate under the paged-KV runtime (port of
`repro.serving.substrate`).

The paper's two-tier local/pool memory system, made physical. Without
it the pool tier is bookkeeping: `KVPager.phys_tiers()` prices every
page against `core.tiers` bandwidth/latency while all pages live in one
device pool. The substrate realizes the split:

  device pool   — the engine's paged cache leaves ("k"/"v" and the int8
                  "k_sz"/"v_sz" scale tensors) stay authoritative in
                  device memory: every kernel keeps reading the same
                  tensors, and the substrate never writes them, so token
                  streams are bit-identical with the substrate on or off.
  host twin     — a same-shape zeros twin of the paged leaves
                  (`models.blocks.init_pool_twin`) in pinned host memory,
                  which the page-copy kernel reaches through its mapped
                  device address (`cudaHostGetDevicePointer`). Pages whose
                  pager tier is POOL are mirrored here; LOCAL and free
                  pages are not.

TIER TRANSITIONS ARE RECONCILED, NOT HOOKED: once per decode step the
engine calls `TierSubstrate.drain(pager, caches)`, which diffs the
pager's live pool set (`KVPager.pool_page_ids()`) against the pages
currently host-resident and issues the difference as async streams —

  page_out  — newly pool-tiered pages (hot-tail eviction, cold-prefix
              demotion, static-policy spill, COW copies landing in the
              pool) copy from the device pool into the host twin: one
              launch of the grouped page copy over every leaf, a
              device->host stream over PCIe in physical mode.
  page_in   — pool pages promoted back to LOCAL copy out of the twin
              into device scratch (host->device); the device pool
              already holds the payload, so the result is only held for
              completion tracking.
  drop      — pages freed while pool-resident (slot release, prefix
              trie reclaim) leave the twin with zero transfer bytes.

The streams run on a side stream behind the main stream's queued work;
the main stream waits for the last page_out (`TierSubstrate.fence()`)
before a cell writes the pool in place again. Within-step churn (a page
evicted and promoted between two drains) coalesces to its net placement
change — the stream contract is placement-accurate, not event-replaying.
Id vectors are not padded: nothing compiles per burst size here.

Every stream appends a `TransferEvent` to the `SubstrateLedger`:
MEASURED bytes (leaf `nbytes` of the actual twin tensors, not the
closed-form kv-byte walk), completion tracked via `sync()` (the stream's
CUDA event; transfers are issued without blocking the step). The
accounting contract, tested in `tests/test_torch_substrate.py`:

    pager.pool_bytes_used() == ledger.placement_bytes()

after every drain, in both modes.

MODES (`runtime.capability.resolve_substrate_mode`): "physical" puts the
twin in pinned host memory and needs the CUDA probes (pinned memory can
be allocated and is mapped); "emulated" runs the identical streams with
the twin on the pool's own device (the CPU in the tests) so the ledger,
byte accounting and tests are the same everywhere; "auto" picks physical
when the device can; "off" disables the substrate (and `ServingEngine`
also disables it when the cache has no paged leaves — SSM-only stacks
have no page-addressable KV).
"""

from repro_torch.serving.substrate.ledger import SubstrateLedger, TransferEvent
from repro_torch.serving.substrate.tier_substrate import TierSubstrate

__all__ = ["SubstrateLedger", "TierSubstrate", "TransferEvent"]

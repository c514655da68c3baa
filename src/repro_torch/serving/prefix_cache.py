"""Shared-prefix radix cache over the pager's physical pages (copy of
`repro.serving.prefix_cache`; pure Python bookkeeping, no tensors).

Serving traffic is dominated by requests that open with the same system
prompt. Their KV for those tokens is bit-identical (K/V at position i is a
function of token i, the weights and the rotary phase — not of the
suffix), so every slot re-prefilling and re-storing its own copy is pure
memory over-provisioning — the waste the source paper quantifies and
that a shared pool is meant to reclaim. This module is the lookup
structure that turns the pager's refcounted pages into a dedup cache.

KEYING — a radix trie at PAGE granularity. Each edge is one full block of
`page_tokens` token ids (a tuple, hashed directly); a node owns the
physical page holding that block's K/V. Matching a prompt walks full
blocks from the root and stops at the first divergent block, so a hit is
always a page-aligned prefix — the only grain the block table can alias.
A node may also hang TERMINAL partial-block children (key = the prompt's
trailing partial block, matched only when it equals the entire remaining
prompt): that is what makes copy-on-write real — a sharer of a partial
tail page must split it before its first decode token lands in the
unused slack of the shared page.

LIFECYCLE — the trie holds its pages via `KVPager.pin` (a non-slot
reference), so a cached prefix survives the donor slot's release; slots
that hit map the pages via `map_shared`/`remap_shared` (ref += 1 each).
Under free-list pressure the pager calls back into `reclaim`, which
unpins least-recently-matched leaves until enough pages actually return
to the free list — evicting a leaf whose page is still mapped by a live
slot frees nothing (the slot's ref keeps it alive), so reclaim keeps
walking. Capacity can also be capped directly (`capacity_pages`).

The trie stores no tensor data — pages live in the engine's paged pools;
for int8 pools the scale/zero tensors ride the same physical page ids, so
sharing quantized payload shares its quantization metadata for free.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


class _Node:
    __slots__ = ("key", "parent", "children", "partial", "phys", "stamp")

    def __init__(self, key: Tuple[int, ...], parent: Optional["_Node"],
                 phys: Optional[int], stamp: int):
        self.key = key          # the token block this node's page caches
        self.parent = parent
        self.children = {}      # full block tuple -> _Node
        self.partial = {}       # terminal partial-tail tuple -> _Node
        self.phys = phys        # physical page id (None only at root)
        self.stamp = stamp      # last match/insert tick (LRU eviction)


@dataclasses.dataclass
class PrefixHit:
    """A page-aligned prefix match: `pages` are the full-block physical
    pages (logical order), `tail_page` the optional terminal partial
    block (only when it equals the prompt's entire remainder)."""

    pages: List[int]
    n_full_tokens: int
    tail_page: Optional[int] = None
    n_tokens: int = 0

    @property
    def all_pages(self) -> List[int]:
        return self.pages + ([self.tail_page]
                             if self.tail_page is not None else [])


class PrefixCache:
    """Radix trie mapping page-granular token blocks to cached physical
    pages. Pure bookkeeping: pages are owned by the `KVPager` (the trie
    pins them) and the KV bytes live in the engine's paged pools."""

    def __init__(self, page_tokens: int,
                 capacity_pages: Optional[int] = None):
        if page_tokens < 1:
            raise ValueError("page_tokens must be >= 1")
        if capacity_pages is not None and capacity_pages < 1:
            raise ValueError("capacity_pages must be >= 1 (or None)")
        self.page_tokens = page_tokens
        self.capacity_pages = capacity_pages
        self._root = _Node((), None, None, 0)
        self._stamp = 0
        self.cached_pages = 0
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.hit_pages = 0
        self.inserted_pages = 0
        self.evicted_pages = 0

    def _tick(self) -> int:
        self._stamp += 1
        return self._stamp

    # ------------------------------------------------------------ match
    def match(self, tokens) -> Optional[PrefixHit]:
        """Longest page-aligned cached prefix of `tokens`, plus the
        terminal partial block iff it covers the prompt's entire
        remainder. Returns None on a cold miss. Touches matched nodes'
        LRU stamps. The caller must `pin` the hit's pages before any
        allocation that could trigger `reclaim` (the guard pin)."""
        toks = tuple(int(t) for t in tokens)
        P = self.page_tokens
        node = self._root
        pages: List[int] = []
        i = 0
        while i + P <= len(toks):
            child = node.children.get(toks[i:i + P])
            if child is None:
                break
            node = child
            node.stamp = self._tick()
            pages.append(child.phys)
            i += P
        tail = None
        n_tail = 0
        rest = toks[i:]
        if 0 < len(rest) < P:
            pnode = node.partial.get(rest)
            if pnode is not None:
                pnode.stamp = self._tick()
                tail = pnode.phys
                n_tail = len(rest)
        if not pages and tail is None:
            self.misses += 1
            return None
        self.hits += 1
        self.hit_pages += len(pages) + (tail is not None)
        self.hit_tokens += len(pages) * P + n_tail
        return PrefixHit(pages=pages, n_full_tokens=len(pages) * P,
                         tail_page=tail, n_tokens=len(pages) * P + n_tail)

    # ----------------------------------------------------------- insert
    def insert(self, tokens, phys_row, pager,
               include_partial: bool = False) -> int:
        """Cache a freshly prefilled prompt: walk/extend the trie along
        `tokens`, pinning each NEW node's page from `phys_row` (the
        owning slot's physical page ids, logical order). Existing nodes
        keep their page — the caller deduplicates the slot's table
        against them via `remap_shared`/`map_shared`. With
        `include_partial`, a trailing partial block becomes a terminal
        node too (the COW-able shared tail). Returns pages added."""
        toks = tuple(int(t) for t in tokens)
        P = self.page_tokens
        node = self._root
        added = 0
        i = 0
        j = 0                       # logical page index into phys_row
        while i + P <= len(toks):
            key = toks[i:i + P]
            child = node.children.get(key)
            if child is None:
                child = _Node(key, node, int(phys_row[j]), self._tick())
                node.children[key] = child
                pager.pin([child.phys])
                self.cached_pages += 1
                self.inserted_pages += 1
                added += 1
            else:
                child.stamp = self._tick()
            node = child
            i += P
            j += 1
        rest = toks[i:]
        if include_partial and 0 < len(rest) < P:
            pnode = node.partial.get(rest)
            if pnode is None:
                pnode = _Node(rest, node, int(phys_row[j]), self._tick())
                node.partial[rest] = pnode
                pager.pin([pnode.phys])
                self.cached_pages += 1
                self.inserted_pages += 1
                added += 1
            else:
                pnode.stamp = self._tick()
        if self.capacity_pages is not None:
            while self.cached_pages > self.capacity_pages:
                if not self._evict_lru(pager):
                    break
        return added

    # --------------------------------------------------------- eviction
    def _leaves(self) -> List[_Node]:
        out: List[_Node] = []
        stack = [self._root]
        while stack:
            n = stack.pop()
            kids = list(n.children.values()) + list(n.partial.values())
            if n is not self._root and not kids:
                out.append(n)
            stack.extend(kids)
        return out

    def _evict_lru(self, pager) -> bool:
        """Unpin the least-recently-matched LEAF (interior nodes anchor
        longer cached prefixes and cannot go first). Returns False when
        the trie is empty."""
        leaves = self._leaves()
        if not leaves:
            return False
        leaf = min(leaves, key=lambda n: n.stamp)
        parent = leaf.parent
        if len(leaf.key) == self.page_tokens:
            del parent.children[leaf.key]
        else:
            del parent.partial[leaf.key]
        self.cached_pages -= 1
        self.evicted_pages += 1
        pager.unpin([leaf.phys])
        return True

    def reclaim(self, pager, n_pages: int) -> int:
        """Free-list pressure callback from `KVPager._take_free`: evict
        LRU leaves until at least `n_pages` pages actually reached the
        free list (an evicted page still mapped by a live slot frees
        nothing — keep walking) or the trie is empty. Returns pages
        freed."""
        freed0 = len(pager._free_phys)
        while len(pager._free_phys) - freed0 < n_pages:
            if not self._evict_lru(pager):
                break
        return len(pager._free_phys) - freed0

    def clear(self, pager) -> None:
        """Drop every cached prefix (unpinning all pages)."""
        while self._evict_lru(pager):
            pass

    # ---------------------------------------------------------- metrics
    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def counters(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hit_rate,
            "hit_tokens": self.hit_tokens,
            "hit_pages": self.hit_pages,
            "inserted_pages": self.inserted_pages,
            "evicted_pages": self.evicted_pages,
            "cached_pages": self.cached_pages,
        }

"""BFS over a pool-resident CSR graph — the paper's §7.1 case study (copy
of `repro.prefetch.workloads`: the same numpy draws from the same seed).

The adjacency array (`indices` of the CSR) lives on the pool tier; BFS
frontier expansion reads the adjacency lists of the current frontier's
vertices. Because frontier vertices are scattered, the page-touch stream
is irregular — the access pattern HW prefetchers fail on — but the
*application* knows the next frontier exactly (it just computed it), so
it can direct prefetch of the next chunk's adjacency pages. The paper
measures this cutting remote accesses by ~50% for a 13% speedup; the
`frontier` predictor + `PrefetchEngine` reproduce the mechanism and
`remote_reduction` the headline number.

`bfs_trace` chunks each BFS level into engine steps of `chunk` vertices;
`hints[i]` carries step i+1's adjacency pages (the app-directed forecast
— within a level the remaining frontier is known, and the first chunk of
level L+1 is known once level L's expansion completes).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.prefetch.trace import AccessTrace


def random_csr(n_vertices: int, avg_degree: int,
               seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform random digraph in CSR form (indptr, indices). Degrees are
    Poisson-ish around `avg_degree`; endpoints uniform — adjacency pages
    of any frontier are scattered over the whole `indices` array."""
    rng = np.random.default_rng(seed)
    degrees = rng.poisson(avg_degree, n_vertices).astype(np.int64)
    degrees = np.maximum(degrees, 1)
    indptr = np.zeros(n_vertices + 1, dtype=np.int64)
    np.cumsum(degrees, out=indptr[1:])
    indices = rng.integers(0, n_vertices, indptr[-1]).astype(np.int64)
    return indptr, indices


def bfs_levels(indptr: np.ndarray, indices: np.ndarray,
               src: int = 0) -> List[np.ndarray]:
    """Top-down BFS; returns the frontier per level in DISCOVERY order
    (the natural queue order — sorting it would turn the adjacency walk
    into a near-sequential CSR sweep and hand HW prefetchers an easy
    pattern the real workload does not have)."""
    n = len(indptr) - 1
    visited = np.zeros(n, dtype=bool)
    visited[src] = True
    frontier = np.array([src], dtype=np.int64)
    levels = [frontier]
    while len(frontier):
        neigh = np.concatenate(
            [indices[indptr[v]:indptr[v + 1]] for v in frontier]
        )
        fresh = ~visited[neigh]
        # first-seen dedup in discovery order
        first = np.zeros(len(neigh), dtype=bool)
        seen_at = {}
        for i in np.nonzero(fresh)[0]:
            u = int(neigh[i])
            if u not in seen_at:
                seen_at[u] = i
                first[i] = True
        nxt = neigh[first]
        visited[nxt] = True
        if not len(nxt):
            break
        levels.append(nxt)
        frontier = nxt
    return levels


@dataclasses.dataclass
class BFSTrace:
    trace: AccessTrace
    levels: List[np.ndarray]
    n_vertices: int
    n_edges: int


def _adjacency_pages(indptr, vertices, edges_per_page) -> List[int]:
    """Distinct pages of the CSR `indices` array covering the adjacency
    lists of `vertices`, in traversal order."""
    pages: List[int] = []
    seen = set()
    for v in vertices:
        lo, hi = indptr[v], indptr[v + 1]
        for p in range(lo // edges_per_page, max(hi - 1, lo) //
                       edges_per_page + 1):
            if p not in seen:
                seen.add(p)
                pages.append(int(p))
    return pages


def bfs_trace(n_vertices: int = 4096, avg_degree: int = 16,
              page_bytes: float = 1024.0, bytes_per_edge: int = 4,
              chunk: int = 32, src: int = 0, seed: int = 0) -> BFSTrace:
    """Build the BFS page-touch trace with application-directed hints.

    Step i touches the adjacency pages of `chunk` frontier vertices;
    `hints[i]` is step i+1's page list (the software pipeline: expand
    chunk j while prefetching chunk j+1's lists)."""
    indptr, indices = random_csr(n_vertices, avg_degree, seed)
    edges_per_page = max(1, int(page_bytes) // bytes_per_edge)
    n_pages = -(-len(indices) // edges_per_page)
    levels = bfs_levels(indptr, indices, src)

    chunks: List[np.ndarray] = []
    for frontier in levels:
        for i in range(0, len(frontier), chunk):
            chunks.append(frontier[i:i + chunk])
    steps = [_adjacency_pages(indptr, c, edges_per_page) for c in chunks]
    hints = steps[1:] + [[]]
    trace = AccessTrace(
        f"bfs_v{n_vertices}_d{avg_degree}", "bfs", page_bytes, n_pages,
        steps, hints=hints,
    ).validate()
    return BFSTrace(trace, levels, n_vertices, int(len(indices)))

"""Speculative-decoding proposers and the greedy acceptance rule (a
numpy copy of `repro.serving.speculative`).

A PROPOSER guesses `k - 1` draft tokens per slot, the verify cell
(`runtime.serve.build_decode_verify_paged`) scores all k candidates in
ONE paged-decode call, and `accept_greedy` keeps the longest candidate
prefix that matches what greedy decode would have produced. The token
stream is bit-identical to plain greedy decode by construction on fp
pools; proposers only change how many tokens each sweep yields.

* `ngram_propose` — self-speculative: match the slot's own trailing
  n-gram against its earlier history (prompt + generated tokens) and
  replay what followed the most recent earlier occurrence. Stateless and
  host-only.
* the draft proposer (`ServingEngine._propose_draft` over
  `runtime.serve.build_decode_draft`) — a draft model decodes `k - 1`
  tokens ahead against its own contiguous caches, caught up from the
  committed history so rejected speculation never poisons it.

The acceptance rule: with candidates `cand[0..k-1]` (cand[0] = the
slot's last emitted token) and verify outputs `greedy[0..k-1]`
(greedy[j] = the model's pick for the position after cand[j]), draft
cand[j+1] is kept only if it equals greedy[j], and the step emits
`greedy[0..a]` where `a` is the first mismatch (or k-1). At least one
token always lands.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def ngram_propose(history: np.ndarray, n_draft: int,
                  max_ngram: int = 4) -> np.ndarray:
    """Propose `n_draft` continuation tokens for `history` by suffix
    n-gram matching: find the LONGEST trailing n-gram (n down from
    `max_ngram`) with an earlier occurrence in `history`, prefer the
    MOST RECENT earlier occurrence, and replay the tokens that followed
    it. Deterministic, stateless, O(max_ngram * len(history)) with
    vectorized scans. Falls back to repeating the last token (a bet on
    degenerate loops) when no n-gram recurs."""
    hist = np.asarray(history, dtype=np.int64).ravel()
    L = int(hist.size)
    out = np.zeros(n_draft, dtype=np.int32)
    if L == 0 or n_draft <= 0:
        return out
    for n in range(min(max_ngram, L - 1), 0, -1):
        sfx = hist[L - n:]
        # candidate start positions of an EARLIER occurrence (must end
        # before the suffix itself starts)
        starts = np.arange(0, L - n)
        ok = np.ones(starts.size, dtype=bool)
        for j in range(n):
            ok &= hist[starts + j] == sfx[j]
        if not ok.any():
            continue
        i = int(starts[ok][-1])            # most recent earlier match
        cont = hist[i + n:i + n + n_draft]
        if cont.size == 0:
            continue
        out[:cont.size] = cont
        out[cont.size:] = cont[-1]         # pad by repeating the tail
        return out
    out[:] = hist[-1]
    return out


def accept_greedy(cand: Sequence[int],
                  greedy: Sequence[int]) -> Tuple[int, list]:
    """Greedy-verification acceptance for ONE slot: `cand[0..k-1]` the
    scored candidates (cand[0] = last emitted token), `greedy[0..k-1]`
    the verify cell's argmax row. Returns `(n_accepted_drafts, emit)`
    where `emit = greedy[0..a]` is the token burst to commit
    (`1 + n_accepted_drafts` tokens) — exactly the tokens `a + 1`
    successive greedy decode steps would have emitted."""
    cand = np.asarray(cand)
    greedy = np.asarray(greedy)
    k = int(cand.size)
    a = 0
    while a < k - 1 and int(cand[a + 1]) == int(greedy[a]):
        a += 1
    return a, [int(t) for t in greedy[:a + 1]]

"""Level 1 access records the KV pager feeds to the placement engine
(copy of the pieces of `repro.core.access` the serving path uses)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TensorAccess:
    name: str
    bytes: int                 # global bytes
    touches: float             # byte-touches per step / bytes (density)
    category: str              # param|expert|moment|embed|cache|other

    @property
    def traffic(self) -> float:
        return self.bytes * self.touches


# --- per-step decode traffic over the KV cache (paper Fig 10 spread) ---
# A decode step reads the most recent tokens at full rate and the cold
# prefix at a reduced effective rate; the pager's hot-tail/cold-prefix
# page weights come from these two constants.
DECODE_HOT_WINDOW = 4096   # tokens of KV tail read at full rate each step
DECODE_COLD_TOUCH = 0.05   # effective per-step touch of the cold prefix

"""Level 1: per-tensor access profiles and bandwidth-capacity scaling
curves (copy of `repro.core.access`).

The paper measures page-grain access counts with PEBS; the unit of
placement here is the named tensor of the train or serve state (meta
tensors from `runtime.train.abstract_train_state` or
`runtime.serve.abstract_params`/`abstract_caches` are enough: only shapes
and dtypes are read). `touches_per_step` is derived from each workload's
semantics (how many times each byte moves per step):

  train:  param read fwd (+ recompute under remat), read in bwd, grad
          write + optimizer read/write; moments read+write once (opt
          phase only: the coldest large state, the paper's pool-tier
          residents);
  serve:  param read per step; expert weights scaled by the expected
          fraction of experts activated by the step's tokens
          (1 - (1 - k/E)^T — the Fig 6 skew for MoE);
          KV cache read per decode step, 1/S write share.

The bandwidth-capacity curve (paper Fig 6) is the CDF of traffic over
footprint with tensors sorted by traffic density.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

from repro_torch.common.config import ModelConfig, ShapeConfig
from repro_torch.common.pytree import leaf_bytes, named_leaves


@dataclasses.dataclass
class TensorAccess:
    name: str
    bytes: int                 # global bytes
    touches: float             # byte-touches per step / bytes (density)
    category: str              # param|expert|moment|embed|cache|other

    @property
    def traffic(self) -> float:
        return self.bytes * self.touches


def _category(name: str) -> str:
    if re.search(r"moe/(w_gate|w_up|w_down)", name):
        return "expert"
    if "opt" in name.split("/")[:-1]:        # optimizer-state subtree
        return "moment"
    if "embedding" in name or "lm_head" in name:
        return "embed"
    if re.search(r"(^|/)(k|v|cross_k|cross_v|state|tail_)", name):
        return "cache"
    return "param"


def expected_expert_fraction(cfg: ModelConfig, tokens: int) -> float:
    """Expected fraction of experts activated by `tokens` routed tokens."""
    if not cfg.num_experts:
        return 1.0
    p_miss = (1.0 - cfg.experts_per_token / cfg.num_experts) ** max(tokens, 1)
    return 1.0 - p_miss


ZIPF_ALPHA = 1.0  # expert-popularity skew (observed MoE routing is Zipf-ish)

# --- per-step decode traffic over the KV cache (paper Fig 10 spread) ---
# A decode step does NOT stream the whole KV prefix at full rate: attention
# mass concentrates on the most recent tokens, and paged/blocked decode
# kernels fetch the cold prefix at a reduced effective rate (sparse /
# compressed / skipped blocks). Modeling the cache as hot-tail + cold-prefix
# is what moves catalog decode cells off the silent/link-saturating extremes
# and populates the intermediate LoI band of the paper's Fig 10.
DECODE_HOT_WINDOW = 4096   # tokens of KV tail read at full rate each step
DECODE_COLD_TOUCH = 0.05   # effective per-step touch of the cold prefix


# --- paged-pool payload dtypes (mirrors models.blocks.POOL_DTYPES) ---
# int8 pools carry one float32 (scale, zero) pair per (page, KV head) per
# K and per V — the "k_sz"/"v_sz" leaves — amortized over the page's
# tokens in the bytes-per-token accounting.
POOL_PAYLOAD_BYTES = {"bf16": 2, "int8": 1}
POOL_SZ_BYTES = 8               # float32 (scale, zero)


def kv_pool_token_bytes(n_attn_layers: int, kv_heads: int, head_dim: int,
                        page_tokens: int, pool_dtype: str,
                        fp_bytes: int = 4,
                        sz_granularity: str = "page") -> float:
    """Self-attention K/V bytes per cached token under a paged pool of
    `pool_dtype` — the closed-form twin of the serving engine's
    cache-tree walk (`serving.engine._kv_bytes_per_token`):

        2 (K and V) * kv_heads * head_dim * payload_bytes * n_layers
        [+ 2 * kv_heads * 8 / page_tokens * n_layers   when int8]

    `fp_bytes` is the compute dtype's itemsize (the "fp" safety-net pool
    stores it unchanged). This is what makes the pager, `phys_tiers()`
    and the admission corridor see the real ~4x pool-byte cut of int8
    pools instead of pricing fp bytes that never cross the link.

    `sz_granularity="token"` prices the speculative-decoding per-token
    sub-scale layout (`kernels.quant.quantize_tokens`): one (scale,
    zero) pair per token row instead of per page, so the int8 sz term
    loses its /page_tokens amortization."""
    payload = POOL_PAYLOAD_BYTES.get(pool_dtype, fp_bytes)
    per_tok = 2.0 * kv_heads * head_dim * payload * n_attn_layers
    if pool_dtype == "int8":
        sz = 2.0 * kv_heads * POOL_SZ_BYTES * n_attn_layers
        if sz_granularity != "token":
            sz /= page_tokens
        per_tok += sz
    return per_tok


def kv_dedup_token_bytes(n_tokens: int, shared_tokens: int,
                         n_sharers: int, token_bytes: float) -> float:
    """Deduplicated pool bytes per cached token when `n_sharers` slots of
    `n_tokens` each share a `shared_tokens`-long prefix (the serving
    prefix cache, `serving.prefix_cache`): the shared prefix is stored
    ONCE, every private suffix once each —

        (n_sharers * (n_tokens - shared_tokens) + shared_tokens)
            * token_bytes / (n_sharers * n_tokens)

    The closed-form twin of `KVPager.phys_tiers()` under sharing: at
    shared_tokens = 0 it degenerates to `token_bytes`; as the shared
    prefix dominates, footprint per token tends to token_bytes /
    n_sharers — the memory over-provisioning the paper quantifies,
    reclaimed by refcounted pages instead of extra capacity."""
    if n_sharers < 1:
        raise ValueError("n_sharers must be >= 1")
    if not 0 <= shared_tokens <= n_tokens:
        raise ValueError("need 0 <= shared_tokens <= n_tokens")
    if n_tokens == 0:
        return 0.0
    stored = n_sharers * (n_tokens - shared_tokens) + shared_tokens
    return stored * token_bytes / (n_sharers * n_tokens)


def decode_cache_split(seq_len: int) -> list[tuple[str, float, float]]:
    """(suffix, byte_fraction, touches) portions of a seq-indexed KV leaf
    for one decode step under the hot-tail/cold-prefix traffic model."""
    hot_frac = min(1.0, DECODE_HOT_WINDOW / max(seq_len, 1))
    if hot_frac >= 1.0:
        return [("", 1.0, 1.0)]
    return [
        ("[hot]", hot_frac, 1.0),
        ("[cold]", 1.0 - hot_frac, DECODE_COLD_TOUCH),
    ]


def expert_activation_probs(cfg: ModelConfig, tokens: int) -> np.ndarray:
    """Per-expert probability of being activated by a step's tokens under a
    Zipf(ZIPF_ALPHA) routing popularity. This is the MoE realization of the
    paper's Fig 6 skew: a minority of experts receives most traffic, so the
    cold tail is pool-eligible at serving time."""
    E, k = cfg.num_experts, cfg.experts_per_token
    ranks = np.arange(1, E + 1, dtype=np.float64)
    pop = ranks ** -ZIPF_ALPHA
    pop /= pop.sum()
    p_tok = np.minimum(1.0, k * pop)          # P(one token routes to e)
    return 1.0 - (1.0 - p_tok) ** max(tokens, 1)


def train_profile(state, cfg: ModelConfig, shape: ShapeConfig,
                  remat: str = "block") -> list[TensorAccess]:
    """Access profile for one optimizer step."""
    out = []
    fwd_reads = 2.0 if remat == "block" else 1.0  # fwd + recompute
    tokens = shape.tokens
    emb_frac = min(1.0, tokens / cfg.vocab_size)
    for name, leaf in named_leaves(state):
        b = leaf_bytes(leaf)
        if b == 0 or name == "step" or name.endswith("count"):
            continue
        cat = _category(name)
        if cat == "moment":
            touches = 2.0                      # read + write in opt phase
        elif cat == "embed" and "embedding" in name:
            # gather rows fwd + scatter-add grads; unembed matmul reads all
            touches = fwd_reads * emb_frac + 1.0 + 3.0
        elif cat == "expert":
            # all experts receive grads in train; dense traffic
            touches = fwd_reads + 1.0 + 3.0   # fwd(+remat), bwd read, opt
        else:
            touches = fwd_reads + 1.0 + 3.0
        out.append(TensorAccess(name, b, touches, cat))
    return out


def serve_profile(params, caches, cfg: ModelConfig, shape: ShapeConfig,
                  expert_grain: bool = True) -> list[TensorAccess]:
    """Access profile for one decode step (or prefill if caches is None).

    With `expert_grain`, the stacked expert tensors are profiled per expert
    (the analysis analogue of the paper's page-grain PEBS sampling): each
    expert's activation probability follows the Zipf routing model, which is
    what produces the Fig 6-style skewed bandwidth-capacity curve for MoE
    archs at serving time.
    """
    out = []
    tokens = shape.global_batch if shape.kind == "decode" else shape.tokens
    emb_frac = min(1.0, tokens / cfg.vocab_size)
    p_act = (
        expert_activation_probs(cfg, tokens) if cfg.num_experts else None
    )
    for name, leaf in named_leaves(params):
        b = leaf_bytes(leaf)
        if b == 0:
            continue
        cat = _category(name)
        if cat == "expert":
            if expert_grain and cfg.num_experts:
                be = b // cfg.num_experts
                for e in range(cfg.num_experts):
                    out.append(TensorAccess(
                        f"{name}[e{e}]", be, float(p_act[e]), "expert"
                    ))
                continue
            touches = expected_expert_fraction(cfg, tokens)
        elif cat == "embed" and "embedding" in name:
            touches = emb_frac + 1.0          # gather + unembed matmul
        else:
            touches = 1.0
        out.append(TensorAccess(name, b, touches, cat))
    if caches is not None:
        for name, leaf in named_leaves(caches):
            b = leaf_bytes(leaf)
            if b == 0:
                continue
            # seq-indexed self-attention K/V (and an int8 pool's per-page
            # scale arrays, which ride with their pages): hot tail at full
            # rate, cold prefix at the reduced paged-decode rate (Fig 10
            # spread); SSM state / conv tails / cross-KV are read whole
            # every step.
            if shape.kind == "decode" and re.search(
                    r"(^|/)(k|v)(_sz)?$", name):
                for sfx, frac, touches in decode_cache_split(shape.seq_len):
                    out.append(TensorAccess(
                        f"cache/{name}{sfx}", int(b * frac), touches, "cache"
                    ))
                continue
            out.append(TensorAccess("cache/" + name, b, 1.0, "cache"))
    return out


def with_prefetch_excess(profile: list[TensorAccess], excess_bytes: float,
                         name: str = "prefetch/excess"
                         ) -> list[TensorAccess]:
    """Fold a prefetcher's fetched-but-unused bytes back into an access
    profile (paper §4.2: SuperLU's speculative HW prefetcher adds 37%
    excess traffic). The excess is real pool-link traffic per step — it
    inflates the profile's pool time, injected LoI, and interference
    coefficient exactly like useful traffic does, which is how a
    low-accuracy prefetcher turns itself into an interference injector.
    `excess_bytes` comes from the prefetch simulators'
    `PrefetchReport.excess_bytes` (`prefetch.engine`; per trace, divide
    by steps for per-step) or the pager's `prefetch_excess_bytes`
    counter."""
    if excess_bytes <= 0:
        return list(profile)
    return list(profile) + [
        TensorAccess(name, int(excess_bytes), 1.0, "other")
    ]


# ------------------------------------------------- Fig 6 scaling curve
def bandwidth_capacity_curve(profile: list[TensorAccess]):
    """Returns (footprint_fraction, traffic_fraction) arrays — the CDF of
    accesses vs footprint with tensors sorted by traffic density (hot
    first). The paper's Fig 6, tensor-grain."""
    items = sorted(profile, key=lambda a: a.touches, reverse=True)
    total_b = sum(a.bytes for a in items) or 1
    total_t = sum(a.traffic for a in items) or 1
    xs, ys = [0.0], [0.0]
    cb = ct = 0.0
    for a in items:
        cb += a.bytes
        ct += a.traffic
        xs.append(cb / total_b)
        ys.append(ct / total_t)
    return np.array(xs), np.array(ys)


def arithmetic_intensity(flops: float, profile: list[TensorAccess],
                         activation_bytes: float = 0.0) -> float:
    traffic = sum(a.traffic for a in profile) + activation_bytes
    return flops / traffic if traffic else 0.0

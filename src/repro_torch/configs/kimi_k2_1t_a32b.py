"""kimi-k2-1t-a32b — 61L d=7168 64H (GQA kv=8) expert-ff=2048 vocab=163840,
MoE 384 experts top-8 — trillion-param MoE.  [arXiv:2501.kimi2; unverified]

This is the showcase arch for the paper's technique: total params (1.03T)
vs active params (~32B) is exactly the skewed bandwidth-capacity curve of
paper Fig 6 (BFS/XSBench): a small fraction of the footprint receives nearly
all accesses, so the cold expert majority is pool-tier eligible.
"""

from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,
    d_ff=0,
    moe_d_ff=2048,
    vocab_size=163840,
    num_experts=384,
    experts_per_token=8,
    moe_layer_period=1,
    source="arXiv:2501.kimi2",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-reduced",
        family="moe",
        num_layers=2,
        d_model=128,
        num_heads=8,
        num_kv_heads=2,
        head_dim=16,
        d_ff=0,
        moe_d_ff=64,
        vocab_size=256,
        num_experts=8,
        experts_per_token=2,
        moe_layer_period=1,
    )

"""granite-moe-1b-a400m — 24L d=1024 16H (GQA kv=8) expert-ff=512 vocab=49155,
MoE 32 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""

from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=0,
    moe_d_ff=512,
    vocab_size=49155,
    num_experts=32,
    experts_per_token=8,
    moe_layer_period=1,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m-reduced",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=0,
        moe_d_ff=32,
        vocab_size=128,
        num_experts=4,
        experts_per_token=2,
        moe_layer_period=1,
        tie_embeddings=True,
    )

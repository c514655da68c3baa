"""jamba-1.5-large-398b — 72L d=8192 64H (GQA kv=8) d_ff=24576 vocab=65536,
MoE 16 experts top-2, Mamba+attention 1:7 interleave.  [arXiv:2403.19887; hf]

Layer pattern: attention on every 8th layer (1:7 attn:mamba), MoE on every
2nd layer (Jamba places MoE at period 2); remaining MLPs are dense.
"""

from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    num_experts=16,
    experts_per_token=2,
    moe_d_ff=24576,
    moe_layer_period=2,
    attn_layer_period=8,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_width=4,
    source="arXiv:2403.19887",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="jamba-reduced",
        family="hybrid",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=128,
        num_experts=4,
        experts_per_token=2,
        moe_d_ff=128,
        moe_layer_period=2,
        attn_layer_period=2,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_expand=2,
        conv_width=4,
    )

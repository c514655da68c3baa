"""qwen2.5-32b — 64L d=5120 40H (GQA kv=8) d_ff=27648 vocab=152064 — GQA,
QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]
"""

from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen2.5-0.5B",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-reduced",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        qkv_bias=True,
    )

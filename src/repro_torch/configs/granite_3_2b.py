"""granite-3-2b — 40L d=2048 32H (GQA kv=8) d_ff=8192 vocab=49155 — GQA.
[hf:ibm-granite/granite-3.0-2b-base; hf]
"""

from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=49155,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-2b-base",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-3-reduced",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        tie_embeddings=True,
    )

"""smollm-360m — 32L d=960 15H (GQA kv=5) d_ff=2560 vocab=49152 — llama-arch
small.  [hf:HuggingFaceTB/SmolLM-135M; hf]

Control arch for the tiering technique: the whole training state fits HBM,
so a correct placement policy must choose all-HBM (pool fraction -> 0).
"""

from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="smollm-reduced",
        family="dense",
        num_layers=2,
        d_model=60,
        num_heads=3,
        num_kv_heads=1,
        head_dim=20,
        d_ff=128,
        vocab_size=128,
        tie_embeddings=True,
    )

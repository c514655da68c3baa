"""paligemma-3b — 18L d=2048 8H (GQA kv=1) d_ff=16384 vocab=257216 — SigLIP +
gemma.  [arXiv:2407.07726; hf]

The SigLIP vision tower is a stub, as in the reference: 256 precomputed
patch embeddings (already projected to d_model, `models.frontends`) are
prepended to the text tokens; the gemma decoder is built in full.
"""

from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    act="geglu",
    tie_embeddings=True,
    frontend="vision_stub",
    num_prefix_tokens=256,
    source="arXiv:2407.07726",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="paligemma-reduced",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        act="geglu",
        tie_embeddings=True,
        frontend="vision_stub",
        num_prefix_tokens=8,
    )

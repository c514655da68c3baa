"""mamba2-780m — 48L d=1536, attention-free SSM, ssm_state=128, vocab=50280.
SSD (state-space duality).  [arXiv:2405.21060; unverified]
"""

from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    head_dim=1,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_width=4,
    tie_embeddings=True,
    source="arXiv:2405.21060",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mamba2-reduced",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=0,
        num_kv_heads=0,
        head_dim=1,
        d_ff=0,
        vocab_size=128,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_expand=2,
        conv_width=4,
        tie_embeddings=True,
    )

"""seamless-m4t-large-v2 — enc-dec 24L(+24L enc) d=1024 16H (GQA kv=16)
d_ff=8192 vocab=256206 — multimodal (audio).  [arXiv:2308.11596; hf]

The speech frontend is a stub, as in the reference: precomputed frame
embeddings of shape (batch, frames, d_model) (`models.frontends`) feed the
text/unit encoder; the decoder cross-attends to encoder output.
"""

from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,
    num_encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    act="gelu",
    frontend="audio_stub",
    num_prefix_tokens=0,  # encoder consumes the frames; no decoder prefix
    source="arXiv:2308.11596",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="seamless-reduced",
        family="audio",
        num_layers=2,
        num_encoder_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        act="gelu",
        frontend="audio_stub",
    )

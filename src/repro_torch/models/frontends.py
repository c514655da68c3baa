"""Modality frontend stubs (port of `repro.models.frontends`): the
transformer backbone is built in full; the SigLIP vision tower and the
speech feature extractor are replaced by precomputed patch / frame
embeddings supplied as model inputs."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.models.module import torch_dtype


def frontend_embed_shape(cfg: ModelConfig, batch: int, seq_len: int):
    """Shape of the precomputed frontend embeddings for a workload cell.

    vision_stub: fixed num_prefix_tokens patch embeddings per example.
    audio_stub : seq_len encoder frames per example (the encoder consumes
                 the frames; the decoder length is the text side).
    """
    if cfg.frontend == "vision_stub":
        return (batch, cfg.num_prefix_tokens, cfg.d_model)
    if cfg.frontend == "audio_stub":
        return (batch, seq_len, cfg.d_model)
    return None


def synthetic_frontend_embeds(cfg: ModelConfig, batch: int, seq_len: int,
                              generator: Optional[torch.Generator] = None,
                              *, device=None):
    """N(0, 0.02^2) embeddings in cfg.dtype drawn from `generator` (on its
    device), or from a generator seeded 17 on `device` (the reference's
    default key is PRNGKey(17); the numbers differ, the role does not).
    None for archs without a frontend."""
    shape = frontend_embed_shape(cfg, batch, seq_len)
    if shape is None:
        return None
    if generator is None:
        generator = torch.Generator(device or "cpu").manual_seed(17)
    return (torch.randn(shape, generator=generator,
                        device=generator.device) * 0.02).to(
        torch_dtype(cfg.dtype))

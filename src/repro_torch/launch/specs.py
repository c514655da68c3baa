"""Meta-tensor input stand-ins for every (arch x shape) cell (port of
`repro.launch.specs`).

`input_specs(arch, shape)` returns the inputs the dry-run traces with:
tensors on the meta device with the reference's shapes and dtypes
(nothing allocated). Frontend archs get their precomputed patch or frame
embeddings as inputs: the vision prefix takes `S - num_prefix_tokens`
text tokens beside `num_prefix_tokens` patches, the audio
encoder-decoder a BOS prompt beside S frames.
"""

from __future__ import annotations

import torch

from repro_torch import configs
from repro_torch.common.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.models.frontends import frontend_embed_shape
from repro_torch.models.module import torch_dtype


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _frontend_specs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    out = {}
    shape = frontend_embed_shape(cfg, batch, seq)
    if cfg.frontend == "vision_stub":
        out["patches"] = _meta(shape, torch_dtype(cfg.dtype))
    elif cfg.frontend == "audio_stub":
        out["frames"] = _meta(shape, torch_dtype(cfg.dtype))
    return out


def _n_text(cfg: ModelConfig, S: int) -> int:
    return S - cfg.num_prefix_tokens if cfg.frontend == "vision_stub" else S


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": _meta((B, _n_text(cfg, S) + 1), torch.int32)}
    batch.update(_frontend_specs(cfg, B, S))
    return batch


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if cfg.frontend == "audio_stub":
        # the encoder consumes S frames; the decoder prompt is a BOS token
        return {"tokens": _meta((B, 1), torch.int32),
                **_frontend_specs(cfg, B, S)}
    batch = {"tokens": _meta((B, _n_text(cfg, S)), torch.int32)}
    batch.update(_frontend_specs(cfg, B, S))
    return batch


def decode_token_specs(cfg: ModelConfig, shape: ShapeConfig) -> torch.Tensor:
    return _meta((shape.global_batch,), torch.int32)


def input_specs(arch: str, shape_name: str) -> dict:
    """Meta inputs for the cell's step function (see `launch.dryrun`)."""
    return cell_specs(configs.get(arch), SHAPES[shape_name])


def cell_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """`input_specs` for a config and shape given directly."""
    if shape.kind == "train":
        return {"batch": train_batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {"batch": prefill_batch_specs(cfg, shape)}
    return {"token": decode_token_specs(cfg, shape),
            "t": _meta((), torch.int32)}

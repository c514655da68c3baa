"""Architecture config registry of the port: the reference's ten archs.

Each module exposes `CONFIG` (the full, published-width config) and
`reduced()` (a tiny same-family config for CPU tests), copied from
`repro.configs`; `shapes_for(name)` returns the shape cells that are
runnable for that arch (long_500k only for sub-quadratic archs) and
`all_cells()` the dry-run matrix: dense decoders, mixture-of-experts decoders
(granite-moe, kimi-k2), the SSM arch mamba2-780m, the hybrid attention +
SSM + MoE stack jamba-1.5-large, the vision-prefix decoder paligemma-3b
and the audio encoder-decoder seamless-m4t-large-v2.
"""

from __future__ import annotations

import importlib

from repro_torch.common.config import SHAPES, ModelConfig, ShapeConfig

ARCH_IDS = [
    "granite_moe_1b_a400m",
    "kimi_k2_1t_a32b",
    "mamba2_780m",
    "jamba_1_5_large_398b",
    "mistral_nemo_12b",
    "qwen2_5_32b",
    "smollm_360m",
    "granite_3_2b",
    "seamless_m4t_large_v2",
    "paligemma_3b",
]

_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


def canonical(name: str) -> str:
    name = name.replace(".", "_")
    return _ALIASES.get(name, name.replace("-", "_"))


def _module(name: str):
    return importlib.import_module(f"repro_torch.configs.{canonical(name)}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def reduced(name: str) -> ModelConfig:
    return _module(name).reduced()


def list_archs() -> list[str]:
    return list(ARCH_IDS)


def shapes_for(name: str) -> list[ShapeConfig]:
    cfg = get(name)
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and not cfg.sub_quadratic:
            continue  # pure full-attention arch: documented skip
        out.append(s)
    return out


def all_cells() -> list[tuple[str, str]]:
    """Every runnable (arch, shape) pair — the dry-run matrix."""
    return [(a, s.name) for a in ARCH_IDS for s in shapes_for(a)]

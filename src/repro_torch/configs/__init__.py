"""Architecture config registry of the port.

Each module exposes `CONFIG` (the full, published-width config) and
`reduced()` (a tiny same-family config for CPU tests), copied from
`repro.configs`. Here are the archs the port serves: the dense
attention-only ones and the SSM arch mamba2-780m; the MoE, hybrid
(jamba, with experts), vision and audio archs arrive with ROADMAP A11.
"""

from __future__ import annotations

import importlib

from repro_torch.common.config import ModelConfig

ARCH_IDS = [
    "mistral_nemo_12b",
    "qwen2_5_32b",
    "smollm_360m",
    "granite_3_2b",
    "mamba2_780m",
]

# the reference registry's other archs, refused by name until they port
_NOT_PORTED = [
    "granite_moe_1b_a400m",
    "kimi_k2_1t_a32b",
    "jamba_1_5_large_398b",
    "seamless_m4t_large_v2",
    "paligemma_3b",
]

_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS + _NOT_PORTED}


def canonical(name: str) -> str:
    name = name.replace(".", "_")
    return _ALIASES.get(name, name.replace("-", "_"))


def _module(name: str):
    arch = canonical(name)
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch} is not ported yet (ROADMAP A11: remaining archs)"
        )
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def reduced(name: str) -> ModelConfig:
    return _module(name).reduced()


def list_archs() -> list[str]:
    return list(ARCH_IDS)

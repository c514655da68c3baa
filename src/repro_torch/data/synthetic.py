"""Deterministic synthetic LM data (port of `repro.data.synthetic`).

Determinism is keyed on (seed, step) so a restarted job replays the exact
same stream from its restored step: the data side of checkpoint/restart
fault tolerance. The token stream is a mixture of a Markov chain and
repeated n-grams so models achieve non-trivial loss reduction (pure
uniform noise cannot be learned and makes convergence tests vacuous).

The reference draws with `jax.random` keyed by fold_in(PRNGKey(seed),
step); torch cannot reproduce that stream, so the port draws from a
`torch.Generator` seeded from (seed, step) with the same structure: the
Markov step next = (31 * prev + n + 1) mod V with n in [0, 7), one
8-gram per row spliced at offsets 4 and 16, and N(0, 0.02^2) frontend
embeddings for the vision / audio stubs. Tests that compare with the
reference feed both packages the reference's batches.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.models.frontends import synthetic_frontend_embeds

_MIX = 0x9E3779B97F4A7C15  # 64-bit golden-ratio constant


def step_generator(seed: int, step: int, stream: int = 0) -> torch.Generator:
    """A CPU generator determined by (seed, step, stream) alone."""
    key = ((seed * _MIX + stream) * _MIX + step) % (2 ** 63)
    return torch.Generator("cpu").manual_seed(key)


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        """Batch for a given step: tokens (B, S+1) int32 on the CPU."""
        g = step_generator(self.seed, step)
        B, S, V = self.global_batch, self.seq_len + 1, self.vocab_size
        start = torch.randint(0, V, (B,), generator=g, dtype=torch.int64)
        noise = torch.randint(0, 7, (B, S), generator=g, dtype=torch.int64)
        toks = torch.empty((B, S), dtype=torch.int64)
        prev = start
        for t in range(S):
            prev = (prev * 31 + noise[:, t] + 1) % V
            toks[:, t] = prev
        # splice in a repeated n-gram (learnable structure)
        gram = torch.randint(0, V, (B, 8), generator=g, dtype=torch.int64)
        toks[:, 4:12] = gram[:, :max(0, min(8, S - 4))]
        toks[:, 16:24] = gram[:, :max(0, min(8, S - 16))]
        return {"tokens": toks.to(torch.int32)}


def make_batch_for(cfg: ModelConfig, seq_len: int, global_batch: int,
                   step: int = 0, seed: int = 0) -> dict:
    """Full input batch for an arch (adds the stub frontend embeddings:
    `patches` for the vision prefix, `frames` for the audio encoder), on
    the CPU."""
    batch = SyntheticLM(cfg.vocab_size, seq_len, global_batch,
                        seed).batch_at(step)
    if cfg.frontend == "vision_stub":
        batch["patches"] = synthetic_frontend_embeds(
            cfg, global_batch, seq_len, step_generator(seed + 1, step))
    if cfg.frontend == "audio_stub":
        batch["frames"] = synthetic_frontend_embeds(
            cfg, global_batch, seq_len, step_generator(seed + 2, step))
    return batch

"""Deterministic synthetic data and the host-side prefetching pipeline."""

from repro_torch.data.pipeline import PrefetchPipeline  # noqa: F401

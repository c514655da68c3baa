"""Mamba2 chunked SSD scan (state-space duality)."""

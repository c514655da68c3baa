"""Configuration, hardware constants, device resolution and byte helpers."""

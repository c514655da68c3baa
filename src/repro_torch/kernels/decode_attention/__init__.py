"""Decode attention: one query token per row against a contiguous KV
cache (`flash_decode`) or a paged pool (`paged_flash_decode`)."""

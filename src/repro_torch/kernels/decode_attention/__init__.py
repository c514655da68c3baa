"""Paged decode attention (the serving hot loop)."""

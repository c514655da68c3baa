"""Serve-step cells of the continuous-batching engine."""

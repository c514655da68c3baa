"""Serve-step cells of the continuous-batching engine, the train step
and the fault layer."""

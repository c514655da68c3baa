"""Cost model and hotspot attribution over the port's own step (the
port's counterpart of `repro.profiler`)."""

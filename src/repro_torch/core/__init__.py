"""The pieces of the paper's three-level analysis that the serving path
calls: tier topology, access records, placement, the pool-link queueing
model and the decode flop count. The rest of `repro.core` ports with
ROADMAP A13."""

"""The paper's contribution: three-level quantitative memory methodology
(port of `repro.core`, priced with the H100 data-sheet constants).

  Level 1: core.access    — intrinsic characterization (bandwidth-capacity
                            scaling curves, arithmetic intensity)
  Level 2: core.tiers +
           core.placement — multi-tier capacity/bandwidth/access ratios and
                            placement policies
           core.roofline  — multi-tier memory roofline
  Level 3: core.interference — LoI / IC / sensitivity on the pooled tier
  core.quantify           — the three levels as one call, `analyze`
                            (compute time from the port's dry-run record,
                            `launch.dryrun`, when there is one)
"""

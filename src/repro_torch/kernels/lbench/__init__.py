"""LBench, the paper's interference and roofline probe (Sec 3.2)."""

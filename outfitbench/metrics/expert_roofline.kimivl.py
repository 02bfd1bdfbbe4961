"""Kernels (ops/moe.py grouped_mm): % of the routed products' least time
(40,960 x 6 token-expert pairs a mixture at the bf16 peak) in the device
time of the program's outfitx.experts spans."""

from outfitbench import tower_spans


def read(rec, records=None):
    return tower_spans.expert_roofline(rec, records)

"""Tower layers (models/towers/deepseek_v2.py MoE): device ms a microbatch in
the program's outfitx.moe spans, summed over the 26 mixtures (router,
permutation, routed products, shared experts, combine)."""

from outfitbench import tower_spans


def read(rec, records=None):
    return tower_spans.device_ms_per_microbatch(rec, "outfitx.moe", records)

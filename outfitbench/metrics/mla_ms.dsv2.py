"""Tower layers (models/towers/deepseek_v2.py MLA): device ms a microbatch in
the program's outfitx.mla spans, summed over the 27 attention blocks."""

from outfitbench import tower_spans


def read(rec, records=None):
    return tower_spans.device_ms_per_microbatch(rec, "outfitx.mla", records)

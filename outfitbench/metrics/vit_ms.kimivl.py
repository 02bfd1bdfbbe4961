"""Towers (models/towers/moonvit.py features, with the normaliser): device ms
a microbatch in the program's outfitx.vision spans, MoonViT's 27 layers
over the microbatch's 131,072 patches."""

from outfitbench import tower_spans


def read(rec, records=None):
    return tower_spans.device_ms_per_microbatch(rec, "outfitx.vision", records)

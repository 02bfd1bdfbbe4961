"""Towers (models/towers/resnet.py with its input, item_encoder.py
encode_images): device ms a microbatch in the program's outfitx.vision
spans, the image tower's part of outfitx.encode."""

from outfitbench import tower_spans


def read(rec, records=None):
    return tower_spans.device_ms_per_microbatch(rec, "outfitx.vision", records)

"""Towers (models/towers/*, item_encoder.py): device ms a microbatch in the
program's outfitx.encode spans (ResNet-18, MiniLM and their heads)."""

from outfitbench import program_spans


def read(rec, records=None):
    return program_spans.device_ms_mean(rec, "outfitx.encode", records)

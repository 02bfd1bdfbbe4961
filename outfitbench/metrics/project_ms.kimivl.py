"""Towers (models/towers/moonvit.py project): device ms a microbatch in the
program's outfitx.project spans, the 2 x 2 merge and the projector to the
decoder's width; nothing where the program has no such span."""

from outfitbench import tower_spans


def read(rec, records=None):
    return tower_spans.device_ms_per_microbatch(rec, "outfitx.project", records)

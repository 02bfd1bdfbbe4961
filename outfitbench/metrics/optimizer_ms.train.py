"""Optimizer (train/optim.py): device ms a step in the program's
outfitx.optimizer span (gradient scaling, the mesh's reduction, clip and
AdamW)."""

from outfitbench import program_spans


def read(rec, records=None):
    return program_spans.device_ms_per_step(rec, "outfitx.optimizer", records)

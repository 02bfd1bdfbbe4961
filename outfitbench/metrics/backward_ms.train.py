"""Model step (backward): device ms a step in the program's
outfitx.backward spans (each microbatch's loss.backward())."""

from outfitbench import program_spans


def read(rec, records=None):
    return program_spans.device_ms_per_step(rec, "outfitx.backward", records)

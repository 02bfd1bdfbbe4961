"""Model step (forward): device ms a step in the program's outfitx.forward
spans, the card's timeline from the end of the work queued before each
microbatch's forward to the end of the work it queued."""

from outfitbench import program_spans


def read(rec, records=None):
    return program_spans.device_ms_per_step(rec, "outfitx.forward", records)

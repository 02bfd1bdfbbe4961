"""Host data: device ms a microbatch in the program's outfitx.gather spans,
which queue no work: the card's idle while the host gathers raw items."""

from outfitbench import program_spans


def read(rec, records=None):
    return program_spans.device_ms_mean(rec, "outfitx.gather", records)

"""Host launch: host ms a microbatch in the program's outfitx.forward and
outfitx.backward spans, the time to queue a microbatch's work, blocks
included."""

from outfitbench import program_spans


def read(rec, records=None):
    return program_spans.enqueue_ms(rec, records)

"""Device: % of the profiled steps with no operation on the card (rank 0)."""

from outfitbench import readers


def read(rec):
    return readers.idle_share(rec)

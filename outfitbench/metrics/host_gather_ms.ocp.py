"""Host data (train/original_cp_trainer.py RawBatchStager, RawItemSource
.gather): growth of the stager's gather_s over the window, ms a microbatch."""

from outfitbench import readers


def read(rec):
    return readers.host_gather_ms(rec)

"""Tower layers (ops/moe.py route, permute, unpermute): device ms a
microbatch in the program's outfitx.route spans, summed over the mixtures."""

from outfitbench import tower_spans


def read(rec, records=None):
    return tower_spans.device_ms_per_microbatch(rec, "outfitx.route", records)

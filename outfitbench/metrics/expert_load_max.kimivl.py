"""Router (ops/moe.py route_sigmoid): the median over the mixtures of the
largest expert's tokens over the mean expert's, from the program's
outfitx.expert_tokens counter in the profiled steps."""

from outfitbench import tower_spans


def read(rec, counts=None):
    return tower_spans.expert_load_max(rec, counts)

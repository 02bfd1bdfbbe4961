"""Kernels (ops/attention.py -> masked_mha_fwd.cu, masked_mha_bwd.cu,
narrow_mha.cuh): % of the attention launches' roofline in the profiled steps."""

from outfitbench import readers


def read(rec):
    return readers.attn_roofline(rec)

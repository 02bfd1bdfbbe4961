"""Kernels (ops/attention.py -> masked_mha_fwd.cu, its split route for MLA,
masked_mha_bwd.cu, narrow_mha.cuh): % of the attention launches' roofline in
the profiled steps, MLA's queries and keys apart from its values."""

from outfitbench import flops_dsv2


def read(rec):
    return flops_dsv2.attn_roofline(rec)

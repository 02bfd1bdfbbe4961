"""Kernels (ops/attention.py -> masked_mha_fwd.cu, the bfloat16 tile route at
MoonViT's L = 256, Dh = 72): % of the launches' least time (bytes bound it)
over the device time of the masked_mha_fwd_long_tile kernels in the
profiled steps."""

from outfitbench import flops_kimivl


def read(rec):
    return flops_kimivl.roofline(rec, flops_kimivl.VIT_KERNEL, 4)

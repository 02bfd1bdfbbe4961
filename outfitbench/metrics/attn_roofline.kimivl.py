"""Kernels (ops/attention.py -> masked_mha_fwd.cu's split route for the
decoder's MLA over 64 image tokens and the title, L = 80): % of the
launches' least time, Dqk and Dv apart, over the device time of the
masked_mha_fwd_split kernels in the profiled steps."""

from outfitbench import flops_kimivl


def read(rec):
    return flops_kimivl.roofline(rec, flops_kimivl.SPLIT_KERNEL, 5)

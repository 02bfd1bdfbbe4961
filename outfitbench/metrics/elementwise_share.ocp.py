"""PyTorch eager passes in the step (dropout, mish, casts, the closed-form
LayerNorm backward): % of device time in kernels of kind 'elementwise'."""

from outfitbench import readers


def read(rec):
    return readers.kind_share(rec, "elementwise")

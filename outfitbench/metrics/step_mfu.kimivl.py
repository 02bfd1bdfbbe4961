"""Model step (models/outfit_transformer.py, train/steps.py, the kimivl_a3b
joint encoder): the model's operations in the profiled steps (MoonViT, the
projector, the decoder with six routed and two shared experts a token, the
heads and the set transformer: flops_kimivl.py) over their seconds on the
device's clock, % of the bf16 peak."""

from outfitbench import readers


def read(rec):
    return readers.step_mfu(rec)

"""Model step (models/outfit_transformer.py, train/steps.py, models/towers/*
with DeepSeek-V2-Lite): the model's operations in the profiled steps (six
routed experts a token, not 64: flops_dsv2.py) over their seconds on the
device's clock, % of the bf16 peak."""

from outfitbench import readers


def read(rec):
    return readers.step_mfu(rec)

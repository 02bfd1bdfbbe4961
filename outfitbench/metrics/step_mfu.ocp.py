"""Model step (models/outfit_transformer.py, train/steps.py, models/towers/*):
the model's operations in the profiled steps over their seconds on the
device's clock, % of the bf16 peak."""

from outfitbench import readers


def read(rec):
    return readers.step_mfu(rec)

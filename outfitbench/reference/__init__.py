"""Plain references that decide ``correct``: PyTorch in float32 with TF32
off, written from the published descriptions. Nothing here imports
``jax``, ``outfitx_tpu`` or ``outfitx_tpu_torch``, and nothing takes what
the program made: weights, data and dropout draws are worked out again
from the run's seed."""

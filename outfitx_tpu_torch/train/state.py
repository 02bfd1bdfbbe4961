"""Train state: what a train step reads and advances (the port of
``outfitx_tpu/train/state.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from outfitx_tpu_torch.core.rng import stream_seed
from outfitx_tpu_torch.models.outfit_transformer import OutfitXModel
from outfitx_tpu_torch.train.optim import AdamW


@dataclasses.dataclass
class TrainState:
    step: int  # optimizer steps taken
    model: OutfitXModel
    optimizer: AdamW
    seed: int  # base of the dropout streams
    generator: torch.Generator  # dropout masks, on the model's device
    # This process's place in the training mesh (parallel.ParallelContext);
    # None on one device.
    par: Optional[object] = None

    @classmethod
    def create(
        cls, model: OutfitXModel, optimizer: AdamW, seed: int, par=None
    ) -> "TrainState":
        return cls(
            step=0,
            model=model,
            optimizer=optimizer,
            seed=seed,
            generator=torch.Generator(device=model.device),
            par=par,
        )

    def dropout_generator(self, microbatch: int) -> torch.Generator:
        """The generator, reseeded to a fresh stream for this step and
        microbatch (as the JAX step folds the step, then the microbatch
        index, into its dropout key)."""
        return self.generator.manual_seed(stream_seed(self.seed, self.step, microbatch))

"""Dropout masks (the port of ``outfitx_tpu/core/rng.py:keep_mask``).

Masks are drawn from an explicit ``torch.Generator`` on the tensor's device.
They are not the JAX package's bits: the two frameworks' generators differ,
so tests that compare the two inject the same masks into both.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def keep_mask(
    gen: torch.Generator, rate: float, shape, device
) -> Tuple[torch.Tensor, float]:
    """(keep mask bool, actual keep probability) for dropout at ``rate``.

    uint8 random bits kept where ``bits < t`` with ``t = round((1 - rate) *
    256)``: the keep probability quantizes to t/256 (rate 0.3 keeps 179/256 =
    0.69921875), and the returned probability is that actual one, so the
    1/q inverted-dropout scale stays unbiased. Where the threshold is
    degenerate (t outside (0, 256)) the mask is an exact Bernoulli draw."""
    t = int(round((1.0 - rate) * 256))
    if 0 < t < 256:
        bits = torch.randint(
            0, 256, tuple(shape), dtype=torch.uint8, generator=gen, device=device
        )
        return bits < t, t / 256.0
    keep = torch.rand(tuple(shape), generator=gen, device=device) < (1.0 - rate)
    return keep, 1.0 - rate


def stream_seed(*words: int) -> int:
    """A 63-bit seed derived from integer words (base seed, step,
    microbatch), for a fresh dropout stream per step and per microbatch."""
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(2)
    return (int(state[0]) << 31 | int(state[1])) & ((1 << 63) - 1)

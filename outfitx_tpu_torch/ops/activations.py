"""Activations of the set transformer's FFN."""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


def mish(x: torch.Tensor) -> torch.Tensor:
    """mish(x) = x * tanh(softplus(x)), softplus as logaddexp(x, 0)."""
    return x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x)))


def resolve_activation(name: str):
    """Map ``TransformerConfig.activation`` to a callable.

    ``"gelu"`` is the tanh approximation, because ``jax.nn.gelu`` defaults
    to it and checkpoints trained by the JAX package expect it.
    """
    table = {
        "mish": mish,
        "relu": F.relu,
        "gelu": functools.partial(F.gelu, approximate="tanh"),
    }
    try:
        return table[name]
    except KeyError:
        raise ValueError(
            f"unknown activation {name!r}; expected one of {sorted(table)}"
        ) from None

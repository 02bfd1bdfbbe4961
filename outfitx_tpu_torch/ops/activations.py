"""Activations of the set transformer's FFN and of the frozen towers' MLP."""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


def mish(x: torch.Tensor) -> torch.Tensor:
    """mish(x) = x * tanh(softplus(x)), softplus as logaddexp(x, 0)."""
    return x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x)))


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The tanh form of gelu (``jax.nn.gelu(x, approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The erf form of gelu (``jax.nn.gelu(x, approximate=False)``)."""
    return F.gelu(x, approximate="none")


# The towers' activations by name. Here "gelu" is the erf form, as in the
# JAX towers' table; the set transformer's "gelu" below is the tanh form.
TOWER_ACTIVATIONS = {"quick_gelu": quick_gelu, "gelu_tanh": gelu_tanh, "gelu": gelu}


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

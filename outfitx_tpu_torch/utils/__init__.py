"""Pooling and fusion helpers with the reference's names (the port of
``outfitx_tpu/utils/__init__.py``: ``mean_pooling`` and
``aggregate_embeddings``; 'sum' aggregation works here, as in the JAX
package)."""

from __future__ import annotations

import torch


def mean_pooling(token_states: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """Attention-mask-weighted mean over the tokens (axis -2), in the
    states' dtype."""
    w = attention_mask.to(token_states.dtype)[..., None]
    return (token_states * w).sum(dim=-2) / torch.clamp_min(w.sum(dim=-2), 1e-9)


def aggregate_embeddings(
    image_embeddings: torch.Tensor,
    text_embeddings: torch.Tensor,
    aggregation_method: str = "concat",
) -> torch.Tensor:
    """Cross-modal fusion: concat (the text half second), mean or sum."""
    if aggregation_method == "concat":
        return torch.cat([image_embeddings, text_embeddings], dim=-1)
    if aggregation_method == "mean":
        return 0.5 * (image_embeddings + text_embeddings)
    if aggregation_method == "sum":
        return image_embeddings + text_embeddings
    raise ValueError(f"aggregation_method {aggregation_method!r}")

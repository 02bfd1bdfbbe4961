"""Binary focal loss on logits (the port of ``outfitx_tpu/losses/focal.py``).

CP training uses alpha 0.75, gamma 2."""

from __future__ import annotations

import torch


def focal_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    *,
    alpha: float = 0.75,
    gamma: float = 2.0,
    reduction: str = "mean",
) -> torch.Tensor:
    """BCE-with-logits weighted by (1 - p_t)^gamma and alpha_t = alpha*y +
    (1-alpha)*(1-y), in float32."""
    logits = logits.float()
    labels = labels.float()
    # Stable BCE with logits: max(x, 0) - x*y + log1p(exp(-|x|)).
    ce = logits.clamp_min(0.0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    p = torch.sigmoid(logits)
    p_t = p * labels + (1.0 - p) * (1.0 - labels)
    loss = ce * torch.pow(1.0 - p_t, gamma)
    if alpha >= 0:
        loss = (alpha * labels + (1.0 - alpha) * (1.0 - labels)) * loss
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return loss.mean()

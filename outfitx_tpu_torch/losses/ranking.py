"""Set-wise ranking loss for CIR (the port of
``outfitx_tpu/losses/ranking.py``).

L_all: hinge(d_pos - d_neg_i + margin) summed over valid negatives, divided
by the *global* valid-negative count (not per row). L_hard: hinge against
the nearest valid negative (padded negatives -> +inf), averaged over the
batch. Total = L_all + L_hard. CIR training uses margin 2.
"""

from __future__ import annotations

import torch

_PAIR_EPS = 1e-6  # torch F.pairwise_distance's eps, on the positive only


def set_wise_ranking_loss(
    positive: torch.Tensor,  # (B, D) ground-truth target embedding
    predicted: torch.Tensor,  # (B, D) model output
    negatives: torch.Tensor,  # (B, K, D)
    negative_mask: torch.Tensor,  # (B, K) bool, True = pad/invalid
    *,
    margin: float = 2.0,
) -> torch.Tensor:
    pos = positive.float()
    pred = predicted.float()
    negs = negatives.float()
    # The positive distance adds eps inside the norm; the negatives do not.
    pos_dist = torch.linalg.vector_norm(pred - pos + _PAIR_EPS, dim=-1)  # (B,)
    neg_dists = torch.linalg.vector_norm(pred[:, None, :] - negs, dim=-1)  # (B, K)

    valid = (~negative_mask).float()
    valid_count = valid.sum().clamp_min(1.0)
    hinge = (pos_dist[:, None] - neg_dists + margin).clamp_min(0.0)
    l_all = (hinge * valid).sum() / valid_count

    hardest = neg_dists.masked_fill(negative_mask, float("inf")).amin(dim=1)
    l_hard = (pos_dist - hardest + margin).clamp_min(0.0).mean()
    return l_all + l_hard

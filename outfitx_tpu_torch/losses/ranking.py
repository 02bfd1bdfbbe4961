"""Set-wise ranking loss for CIR (the port of
``outfitx_tpu/losses/ranking.py``).

L_all: hinge(d_pos - d_neg_i + margin) summed over valid negatives, divided
by the *global* valid-negative count (not per row). L_hard: hinge against
the nearest valid negative (padded negatives -> +inf), averaged over the
batch. Total = L_all + L_hard. CIR training uses margin 2. Under data
parallelism a rank passes the global valid-negative count and batch size,
and the ranks' losses sum to the global one.
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
    valid_count: torch.Tensor | None = None,
    batch_size: int | None = None,
) -> torch.Tensor:
    """``valid_count`` and ``batch_size`` replace the normalisers of L_all
    and L_hard (default: this batch's own)."""
    pos = positive.float()
    pred = predicted.float()
    negs = negatives.float()
    # The positive distance adds eps inside the norm; the negatives do not.
    pos_dist = torch.linalg.vector_norm(pred - pos + _PAIR_EPS, dim=-1)  # (B,)
    neg_dists = torch.linalg.vector_norm(pred[:, None, :] - negs, dim=-1)  # (B, K)

    valid = (~negative_mask).float()
    if valid_count is None:
        valid_count = valid.sum()
    valid_count = valid_count.clamp_min(1.0)
    hinge = (pos_dist[:, None] - neg_dists + margin).clamp_min(0.0)
    l_all = (hinge * valid).sum() / valid_count

    hardest = neg_dists.masked_fill(negative_mask, float("inf")).amin(dim=1)
    l_hard = (pos_dist - hardest + margin).clamp_min(0.0)
    l_hard = l_hard.mean() if batch_size is None else l_hard.sum() / batch_size
    return l_all + l_hard

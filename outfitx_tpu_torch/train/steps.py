"""Train and eval steps over a device-resident catalog (the port of
``outfitx_tpu/train/steps.py``).

The precomputed item-embedding catalog (N+1, D) lives on the device; batches
are int32 row-index tensors and the embeddings are gathered on the device
inside the step. A train step takes a super-batch with a leading
accumulation axis A: it runs forward and backward on each microbatch, sums
the losses and gradients, scales both by 1/A (as the JAX package's
``_accumulate``), then clips and takes one AdamW step. Each microbatch draws
its dropout masks from a fresh stream for (step, microbatch).
"""

from __future__ import annotations

from typing import Dict

import torch

from outfitx_tpu_torch.losses import focal_loss, set_wise_ranking_loss
from outfitx_tpu_torch.models.outfit_transformer import OutfitXModel
from outfitx_tpu_torch.ops.retrieval import fitb_pick
from outfitx_tpu_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]


def gather(catalog: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """catalog rows at integer ``rows`` of any shape -> (*rows.shape, D)."""
    out = catalog.index_select(0, rows.reshape(-1))
    return out.reshape(*rows.shape, catalog.shape[-1])


def _accumulate(state: TrainState, loss_fn, batch: Batch):
    """Forward and backward over the A microbatches of ``batch``; leaves the
    mean gradient in each ``p.grad`` and returns (mean loss, per-microbatch
    aux outputs)."""
    model = state.model
    model.train()
    state.optimizer.zero_grad()
    a = next(iter(batch.values())).shape[0]
    total = None
    aux = []
    for i in range(a):
        mb = {k: v[i] for k, v in batch.items()}
        loss, out = loss_fn(model, mb, state.dropout_generator(i))
        loss.backward()
        total = loss.detach() if total is None else total + loss.detach()
        aux.append(out)
    scale = 1.0 / a
    for p in state.optimizer.params:
        if p.grad is not None:
            p.grad.mul_(scale)
    return total * scale, aux


def _apply(state: TrainState) -> None:
    state.optimizer.step()
    state.step += 1


def cp_train_step(
    state: TrainState,
    catalog: torch.Tensor,
    batch: Batch,
    *,
    alpha: float = 0.75,
    gamma: float = 2.0,
) -> Dict[str, torch.Tensor]:
    """CP train step. batch: {'item_idx': (A,B,L) int32, 'mask': (A,B,L)
    bool, 'label': (A,B) float32}. Returns {'loss', 'scores' (A,B),
    'labels' (A,B)}, on the device."""

    def loss_fn(model, mb, gen):
        scores = model.cp_forward(
            gather(catalog, mb["item_idx"]), mb["mask"], generator=gen
        )
        loss = focal_loss(scores, mb["label"], alpha=alpha, gamma=gamma)
        return loss, scores.detach()

    loss, scores = _accumulate(state, loss_fn, batch)
    _apply(state)
    return {"loss": loss, "scores": torch.stack(scores), "labels": batch["label"]}


def cir_train_step(
    state: TrainState,
    catalog: torch.Tensor,
    batch: Batch,
    *,
    margin: float = 2.0,
) -> Dict[str, torch.Tensor]:
    """CIR train step. batch (leading accumulation axis A): 'item_idx'
    (A,B,L) int32 partial outfits, 'mask' (A,B,L) bool, 'pos_idx' (A,B)
    int32 targets, 'neg_idx' (A,B,K) int32 negatives, 'neg_mask' (A,B,K)
    bool, True = padded negative. The target's text embedding is the
    second half of its catalog row."""
    d = catalog.shape[-1]

    def loss_fn(model, mb, gen):
        pos = gather(catalog, mb["pos_idx"])  # (B, D)
        pred = model.cir_forward(
            gather(catalog, mb["item_idx"]), mb["mask"], pos[:, d // 2 :],
            generator=gen,
        )
        negs = gather(catalog, mb["neg_idx"])  # (B, K, D)
        return set_wise_ranking_loss(pos, pred, negs, mb["neg_mask"], margin=margin), None

    loss, _ = _accumulate(state, loss_fn, batch)
    _apply(state)
    return {"loss": loss}


@torch.no_grad()
def cp_eval_step(model: OutfitXModel, catalog, item_idx, mask) -> torch.Tensor:
    """CP logits (B,) in eval mode."""
    model.eval()
    return model.cp_forward(gather(catalog, item_idx), mask)


@torch.no_grad()
def cir_eval_step(model: OutfitXModel, catalog, item_idx, mask, pos_idx) -> torch.Tensor:
    """Predicted target embeddings (B, D) for retrieval eval."""
    model.eval()
    d = catalog.shape[-1]
    text = gather(catalog, pos_idx)[:, d // 2 :]
    return model.cir_forward(gather(catalog, item_idx), mask, text)


@torch.no_grad()
def cir_eval_loss_step(
    catalog, y_hats, pos_idx, neg_idx, neg_mask, *, margin: float = 2.0
) -> torch.Tensor:
    """Ranking loss of precomputed predictions, positives and negatives
    gathered from the device catalog by row."""
    return set_wise_ranking_loss(
        gather(catalog, pos_idx), y_hats, gather(catalog, neg_idx), neg_mask,
        margin=margin,
    )


@torch.no_grad()
def fitb_eval_step(
    model: OutfitXModel, catalog, item_idx, mask, cand_idx, answer_text_idx
) -> torch.Tensor:
    """FITB: the candidate (B, C rows) nearest the CIR prediction, (B,)."""
    model.eval()
    d = catalog.shape[-1]
    text = gather(catalog, answer_text_idx)[:, d // 2 :]
    pred = model.cir_forward(gather(catalog, item_idx), mask, text)
    return fitb_pick(pred, gather(catalog, cand_idx))

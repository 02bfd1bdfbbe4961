"""Train and eval steps over a device-resident catalog (the port of
``outfitx_tpu/train/steps.py``).

The precomputed item-embedding catalog (N+1, D) lives on the device; batches
are int32 row-index tensors and the embeddings are gathered on the device
inside the step. A train step takes a super-batch with a leading
accumulation axis A: it runs forward and backward on each microbatch, sums
the losses and gradients, scales both by 1/A (as the JAX package's
``_accumulate``), then clips and takes one AdamW step. Each microbatch draws
its dropout masks from a fresh stream for (step, microbatch). The
original-CP step takes its microbatches one at a time instead, raw items
that its model encodes before the set transformer. Spans
(``core/trace.py``, recorded only under a profiler) mark each step, each
microbatch's forward and backward, and the optimizer's part.

Under a mesh (``state.par``) each rank takes its rows of every global
microbatch (block d of ``data``, JAX's ``P("data")`` split) and its loss
is its rows' share of the global mean: the focal loss is a sum over its
rows divided by the global batch, and the ranking loss divides by the
global valid-negative count and batch. The ranks' gradients then sum to
the global batch's; they are all-reduced over the data axis once per
optimizer step, after accumulation, and the reported loss is the global
one. The returned scores and labels are this rank's rows.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator

import torch

from outfitx_tpu_torch.core.mesh import DATA_AXIS
from outfitx_tpu_torch.core.trace import span
from outfitx_tpu_torch.losses import focal_loss, set_wise_ranking_loss
from outfitx_tpu_torch.models.outfit_transformer import OutfitXModel
from outfitx_tpu_torch.ops.retrieval import fitb_pick
from outfitx_tpu_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]


def gather(catalog: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """catalog rows at integer ``rows`` of any shape -> (*rows.shape, D)."""
    out = catalog.index_select(0, rows.reshape(-1))
    return out.reshape(*rows.shape, catalog.shape[-1])


def _accumulate(state: TrainState, loss_fn, microbatches: Iterable[Batch]):
    """Forward and backward over ``microbatches``; leaves the summed
    gradient in each ``p.grad`` and returns (summed loss, per-microbatch
    aux outputs). Each microbatch is taken from ``microbatches`` outside
    its forward span."""
    model = state.model
    model.train()
    state.optimizer.zero_grad()
    total = None
    aux = []
    for i, mb in enumerate(microbatches):
        with span("outfitx.forward", i):
            loss, out = loss_fn(model, mb, state.dropout_generator(i))
        with span("outfitx.backward", i):
            loss.backward()
        total = loss.detach() if total is None else total + loss.detach()
        aux.append(out)
    return total, aux


def _focal(scores, labels, par, **kw):
    """The focal loss, or this rank's share of the global batch's mean."""
    if par is None:
        return focal_loss(scores, labels, **kw)
    return focal_loss(scores, labels, reduction="sum", **kw) / (scores.shape[0] * par.data)


def _split(batch: Batch) -> Iterator[Batch]:
    """The microbatches of a super-batch with a leading accumulation axis."""
    a = next(iter(batch.values())).shape[0]
    return ({k: v[i] for k, v in batch.items()} for i in range(a))


def _apply(state: TrainState, total: torch.Tensor, n: int) -> torch.Tensor:
    """Scale the summed gradients and loss of ``n`` microbatches by 1/n,
    sum both over the mesh's data axis, take one AdamW step; returns the
    mean loss."""
    with span("outfitx.optimizer"):
        scale = 1.0 / n
        for p in state.optimizer.params:
            if p.grad is not None:
                p.grad.mul_(scale)
        if state.par is not None:
            state.par.reduce_gradients(state.optimizer.params)
            total = state.par.all_reduce(total.reshape(1).clone(), DATA_AXIS)[0]
        loss = total * scale
        state.optimizer.step()
    state.step += 1
    return loss


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
    'labels' (A,B)}, on the device (B: this rank's rows under a mesh)."""
    par = state.par

    def loss_fn(model, mb, gen):
        mb = mb if par is None else par.batch_rows(mb)
        scores = model.cp_forward(
            gather(catalog, mb["item_idx"]), mb["mask"], generator=gen
        )
        loss = _focal(scores, mb["label"], par, alpha=alpha, gamma=gamma)
        return loss, scores.detach()

    with span("outfitx.step", state.step):
        loss, scores = _accumulate(state, loss_fn, _split(batch))
        loss = _apply(state, loss, len(scores))
        labels = batch["label"] if par is None else par.rows(batch["label"], dim=1)
        return {"loss": loss, "scores": torch.stack(scores), "labels": labels}


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
    par = state.par

    def loss_fn(model, mb, gen):
        norms = {}
        if par is not None:
            # the global normalisers, from the global microbatch every rank
            # holds: valid negatives and rows of all ranks together
            norms = {
                "valid_count": (~mb["neg_mask"]).sum().float(),
                "batch_size": mb["pos_idx"].shape[0],
            }
            mb = par.batch_rows(mb)
        pos = gather(catalog, mb["pos_idx"])  # (B, D)
        pred = model.cir_forward(
            gather(catalog, mb["item_idx"]), mb["mask"], pos[:, d // 2 :],
            generator=gen,
        )
        negs = gather(catalog, mb["neg_idx"])  # (B, K, D)
        loss = set_wise_ranking_loss(
            pos, pred, negs, mb["neg_mask"], margin=margin, **norms
        )
        return loss, None

    with span("outfitx.step", state.step):
        loss, aux = _accumulate(state, loss_fn, _split(batch))
        return {"loss": _apply(state, loss, len(aux))}


def original_cp_train_step(
    state: TrainState,
    microbatches: Iterable[Batch],
    *,
    alpha: float = 0.75,
    gamma: float = 2.0,
) -> Dict[str, torch.Tensor]:
    """Original-CP train step: ``state.model`` (``OriginalCPModel``) runs
    the item encoder over each microbatch's raw items and the set
    transformer over their embeddings. Each microbatch: 'images'
    (B,L,3,S,S) uint8, 'input_ids' and 'attn' (B,L,T) int32, 'mask' (B,L)
    bool, 'label' (B,) float32, on the device. Returns {'loss', 'scores'
    (A,B)}, on the device. Under a mesh each microbatch holds this rank's
    rows only: a rank stages and encodes nothing else."""
    par = state.par

    def loss_fn(net, mb, gen):
        scores = net.cp_forward(mb, generator=gen)
        loss = _focal(scores, mb["label"], par, alpha=alpha, gamma=gamma)
        return loss, scores.detach()

    with span("outfitx.step", state.step):
        loss, scores = _accumulate(state, loss_fn, microbatches)
        loss = _apply(state, loss, len(scores))
        return {"loss": loss, "scores": torch.stack(scores)}


@torch.no_grad()
def original_cp_eval_step(net, batch: Batch) -> torch.Tensor:
    """CP logits (B,) of raw items in eval mode (batch as one microbatch
    of ``original_cp_train_step``, without 'label')."""
    net.eval()
    return net.cp_forward(batch)


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

"""Processors: typed task objects -> fixed-shape numpy batches (the port of
``outfitx_tpu/data/processors.py``).

Outfits are padded or truncated to ``max_len`` with zero embeddings and a
True = pad mask; the task processors add labels, negatives or candidates;
``ProcessorFactory`` maps a task type to its processor. They take the
embeddings the items carry and return numpy arrays, and they pickle (the
processors are frozen dataclasses), so data-loader workers can hold them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple, Type

import numpy as np

from outfitx_tpu_torch.data.types import (
    FashionItem,
    OutfitCompatibilityPredictionTask,
    OutfitComplementaryItemRetrievalTask,
    OutfitFillInTheBlankTask,
    OutfitPrecomputeEmbeddingTask,
)


def _pad_embeddings(
    outfits: Sequence[Sequence[FashionItem]], max_len: int, d: int
) -> Tuple[np.ndarray, np.ndarray]:
    b = len(outfits)
    emb = np.zeros((b, max_len, d), dtype=np.float32)  # zero pad rows
    mask = np.ones((b, max_len), dtype=bool)
    for i, outfit in enumerate(outfits):
        for j, item in enumerate(outfit[:max_len]):
            emb[i, j] = item.embedding
            mask[i, j] = False
    return emb, mask


@dataclasses.dataclass(frozen=True)
class CPProcessor:
    max_len: int = 16

    def __call__(
        self, batch: Sequence[Tuple[OutfitCompatibilityPredictionTask, float]]
    ) -> Dict[str, np.ndarray]:
        """(task, label) pairs."""
        tasks, labels = zip(*batch)
        d = len(tasks[0].outfit[0].embedding)
        emb, mask = _pad_embeddings([t.outfit for t in tasks], self.max_len, d)
        return {
            "outfit_embedding": emb,
            "outfit_mask": mask,
            "label": np.asarray(labels, dtype=np.float32),
        }


@dataclasses.dataclass(frozen=True)
class CIRProcessor:
    max_len: int = 16
    n_negatives: int = 10

    def __call__(
        self,
        batch: Sequence[
            Tuple[OutfitComplementaryItemRetrievalTask, Sequence[np.ndarray]]
        ],
    ) -> Dict[str, np.ndarray]:
        """Train-mode collate: (task, negative embeddings) pairs; negatives
        past ``n_negatives`` are dropped, missing ones padded and masked."""
        tasks = [t for t, _ in batch]
        d = len(tasks[0].target_item.embedding)
        emb, mask = _pad_embeddings([t.outfit for t in tasks], self.max_len, d)
        b = len(batch)
        pos = np.stack([t.target_item.embedding for t in tasks])
        text = np.stack([t.target_item.text_embedding for t in tasks])
        negs = np.zeros((b, self.n_negatives, d), dtype=np.float32)
        neg_mask = np.ones((b, self.n_negatives), dtype=bool)
        for i, (_, neg_list) in enumerate(batch):
            for j, n in enumerate(list(neg_list)[: self.n_negatives]):
                negs[i, j] = n
                neg_mask[i, j] = False
        return {
            "outfit_embedding": emb,
            "outfit_mask": mask,
            "target_item_text_embedding": text,
            "pos_item_embedding": pos,
            "neg_items_embedding": negs,
            "neg_items_mask": neg_mask,
        }


@dataclasses.dataclass(frozen=True)
class FITBProcessor:
    max_len: int = 16

    def __call__(
        self,
        batch: Sequence[Tuple[OutfitFillInTheBlankTask, np.ndarray, int]],
    ) -> Dict[str, np.ndarray]:
        """(task, candidate embeddings (C, d), answer index) triples."""
        tasks = [t for t, _, _ in batch]
        d = len(tasks[0].target_item.embedding)
        emb, mask = _pad_embeddings([t.outfit for t in tasks], self.max_len, d)
        return {
            "outfit_embedding": emb,
            "outfit_mask": mask,
            "target_item_text_embedding": np.stack(
                [t.target_item.text_embedding for t in tasks]
            ),
            "candidate_item_embedding": np.stack([c for _, c, _ in batch]),
            "answer_index": np.asarray([a for _, _, a in batch], dtype=np.int32),
        }


@dataclasses.dataclass(frozen=True)
class PrecomputeProcessor:
    def __call__(
        self, batch: Sequence[OutfitPrecomputeEmbeddingTask]
    ) -> Dict[str, list]:
        """The items' images, category texts and ids, as lists."""
        items = [t.fashion_item for t in batch]
        return {
            "images": [i.image for i in items],
            "texts": [i.category for i in items],
            "item_id": [i.item_id for i in items],
        }


class ProcessorFactory:
    """Task type -> its processor."""

    _REGISTRY: Dict[Type, Type] = {
        OutfitCompatibilityPredictionTask: CPProcessor,
        OutfitComplementaryItemRetrievalTask: CIRProcessor,
        OutfitFillInTheBlankTask: FITBProcessor,
        OutfitPrecomputeEmbeddingTask: PrecomputeProcessor,
    }

    @classmethod
    def get_processor(cls, task_type: Type, **kwargs):
        try:
            processor = cls._REGISTRY[task_type]
        except KeyError:
            raise KeyError(f"no processor for task type {task_type!r}") from None
        return processor(**kwargs)

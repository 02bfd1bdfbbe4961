"""Typed task objects, the collate layer's input (the port of
``outfitx_tpu/data/types.py``).

An item, and the four tasks built from items: compatibility prediction
(CP), complementary item retrieval (CIR), fill in the blank (FITB) and the
precompute sweep's unit. ``data/processors.py`` turns lists of them into
fixed-shape numpy batches.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np


@dataclasses.dataclass
class FashionItem:
    """One catalog item. With concat fusion the text half of the item's
    embedding is its second half, which ``text_embedding`` takes when not
    given."""

    item_id: int
    category: str = ""
    description: str = ""
    image: Optional[Any] = None  # PIL image or array, when loaded
    metadata: Optional[dict] = None
    embedding: Optional[np.ndarray] = None  # fused (d,) embedding
    text_embedding: Optional[np.ndarray] = None  # = embedding[d//2:]

    def __post_init__(self):
        if self.embedding is not None and self.text_embedding is None:
            d = len(self.embedding)
            self.text_embedding = np.asarray(self.embedding)[d // 2 :]


@dataclasses.dataclass
class OutfitCompatibilityPredictionTask:
    """CP query: a set of items."""

    outfit: List[FashionItem]


@dataclasses.dataclass
class OutfitComplementaryItemRetrievalTask:
    """CIR query: a partial outfit and the target item."""

    outfit: List[FashionItem]
    target_item: FashionItem


@dataclasses.dataclass
class OutfitFillInTheBlankTask:
    """FITB query: the shape of a CIR query, a type of its own for
    dispatch."""

    outfit: List[FashionItem]
    target_item: FashionItem


@dataclasses.dataclass
class OutfitPrecomputeEmbeddingTask:
    """One item of the catalog sweep."""

    fashion_item: FashionItem

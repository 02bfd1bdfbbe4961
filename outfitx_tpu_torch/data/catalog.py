"""Item catalog: the embedding table and item metadata columns.

This package's copy of ``outfitx_tpu/data/catalog.py``:

- ``embeddings``: (N+1, D) float32; row N is an all-zero PAD row, so padded
  outfit slots gather zeros;
- ``category_id`` / ``semantic_category``: int codes per item, for the
  per-category candidate pools;
- the table is moved to the device once; requests carry row indices.

The text embedding of an item is the second half of its fused embedding.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import pickle
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Catalog:
    item_ids: np.ndarray  # (N,) int64
    embeddings: np.ndarray  # (N+1, D) float32; row N = PAD (zeros)
    category_id: np.ndarray  # (N,) int32
    semantic_category: np.ndarray  # (N,) int32 codes
    semantic_vocab: List[str]
    id_to_row: Dict[int, int]
    descriptions: Optional[List[str]] = None
    category_names: Optional[Dict[int, str]] = None

    @property
    def n_items(self) -> int:
        return len(self.item_ids)

    @property
    def pad_row(self) -> int:
        """The table's last row, the all-zero PAD row. Equals ``n_items`` in
        the standard (N+1) layout; after ``reserve`` the layout is
        [items][spare sentinel rows][PAD] and it equals ``capacity``."""
        return self.embeddings.shape[0] - 1

    @property
    def capacity(self) -> int:
        """Item rows the table can hold (the PAD row excluded)."""
        return self.embeddings.shape[0] - 1

    @property
    def d_embed(self) -> int:
        return self.embeddings.shape[1]

    def rows(self, ids) -> np.ndarray:
        return np.asarray([self.id_to_row[i] for i in ids], dtype=np.int32)

    # -------------------------------------------------- live append API --
    # Serving-side catalog growth: reserve spare rows once (before splits
    # are staged: their padded slots hold pad_row), then append items into
    # them without ever changing the table's shape.
    SENTINEL = 1.0e4  # per-dimension value of unfilled spare rows: their L2
    # distance to any real query is so large that retrieval over [:pad_row]
    # may include them and they never win a top-k slot.

    def reserve(self, extra: int) -> int:
        """Grow the table to [items][``extra`` sentinel rows][PAD].

        Returns the old pad row index so callers can remap split arrays
        built before (their padded slots hold the old index, which now
        points at a sentinel row)."""
        old_pad = self.pad_row
        n, d = self.n_items, self.d_embed
        emb = np.zeros((self.capacity + extra + 1, d), dtype=np.float32)
        emb[:n] = self.embeddings[:n]
        emb[n : self.capacity + extra] = self.SENTINEL
        self.embeddings = emb
        return old_pad

    def append_items(
        self,
        item_ids,
        embeddings,
        category_ids=None,
        semantic_categories: Optional[List[str]] = None,
        descriptions: Optional[List[str]] = None,
    ) -> np.ndarray:
        """Append new items into reserved spare rows; returns their row
        indices. Raises when out of capacity (``reserve`` more first) or on
        an id that already exists (use an update path for those)."""
        ids = [int(i) for i in item_ids]
        k = len(ids)
        n = self.n_items
        if n + k > self.capacity:
            raise ValueError(
                f"catalog capacity {self.capacity} cannot take {k} more "
                f"items (have {n}); reserve() more spare rows"
            )
        dup = [i for i in ids if i in self.id_to_row]
        if dup:
            raise ValueError(f"item ids already in catalog: {dup[:5]}")
        vals = np.asarray(embeddings, dtype=np.float32)
        if vals.shape != (k, self.d_embed):
            raise ValueError(
                f"embeddings shape {vals.shape} != ({k}, {self.d_embed})"
            )
        rows = np.arange(n, n + k, dtype=np.int32)
        self.embeddings[rows] = vals
        self.item_ids = np.concatenate(
            [self.item_ids, np.asarray(ids, dtype=np.int64)]
        )
        cid = (
            np.asarray(category_ids, dtype=np.int32)
            if category_ids is not None
            else np.full(k, -1, dtype=np.int32)
        )
        self.category_id = np.concatenate([self.category_id, cid])
        sem = np.zeros(k, dtype=np.int32)
        for j, name in enumerate(semantic_categories or [""] * k):
            name = str(name)
            if name not in self.semantic_vocab:
                self.semantic_vocab.append(name)
            sem[j] = self.semantic_vocab.index(name)
        self.semantic_category = np.concatenate([self.semantic_category, sem])
        if self.descriptions is not None:
            self.descriptions.extend(
                list(descriptions) if descriptions is not None else [""] * k
            )
        for r, i in zip(rows, ids):
            self.id_to_row[i] = int(r)
        return rows

    @classmethod
    def from_polyvore(
        cls,
        dataset_dir: str | pathlib.Path,
        *,
        model_name: str,
        embed_file_prefix: str = "embedding_subset_",
    ) -> "Catalog":
        """Load item_metadata.json, categories.json and the pickled
        embedding shards ``precomputed_embeddings/{model_name}_{prefix}
        {rank}.pkl`` that the precompute step of this project writes."""
        dataset_dir = pathlib.Path(dataset_dir)
        with open(dataset_dir / "item_metadata.json", encoding="utf-8") as f:
            metadata = json.load(f)
        with open(dataset_dir / "categories.json", encoding="utf-8") as f:
            category_names = {int(k): v for k, v in json.load(f).items()}

        emb_dir = dataset_dir / "precomputed_embeddings"
        emb_dict: Dict[int, np.ndarray] = {}
        shards = sorted(emb_dir.glob(f"{model_name}_{embed_file_prefix}*.pkl"))
        if not shards:
            raise FileNotFoundError(
                f"no embedding shards under {emb_dir} for model {model_name}"
            )
        for shard in shards:
            with open(shard, "rb") as f:
                payload = pickle.load(f)
            for iid, emb in zip(payload["ids"], payload["embeddings"]):
                emb_dict[int(iid)] = np.asarray(emb, dtype=np.float32)

        return cls.from_columns(metadata, emb_dict, category_names)

    @classmethod
    def from_columns(
        cls,
        metadata: List[dict],
        emb_dict: Dict[int, np.ndarray],
        category_names: Optional[Dict[int, str]] = None,
    ) -> "Catalog":
        items = [m for m in metadata if int(m["item_id"]) in emb_dict]
        n = len(items)
        if n == 0:
            raise ValueError("no items with embeddings")
        d = next(iter(emb_dict.values())).shape[-1]
        item_ids = np.zeros(n, dtype=np.int64)
        embeddings = np.zeros((n + 1, d), dtype=np.float32)  # +1 pad row
        category_id = np.zeros(n, dtype=np.int32)
        sem_names: List[str] = []
        sem_vocab: Dict[str, int] = {}
        semantic = np.zeros(n, dtype=np.int32)
        descriptions = []
        for row, m in enumerate(items):
            iid = int(m["item_id"])
            item_ids[row] = iid
            embeddings[row] = emb_dict[iid]
            category_id[row] = int(m.get("category_id", -1))
            sc = str(m.get("semantic_category", ""))
            if sc not in sem_vocab:
                sem_vocab[sc] = len(sem_vocab)
                sem_names.append(sc)
            semantic[row] = sem_vocab[sc]
            descriptions.append(m.get("title") or m.get("url_name") or "")
        return cls(
            item_ids=item_ids,
            embeddings=embeddings,
            category_id=category_id,
            semantic_category=semantic,
            semantic_vocab=sem_names,
            id_to_row={int(i): r for r, i in enumerate(item_ids)},
            descriptions=descriptions,
            category_names=category_names,
        )

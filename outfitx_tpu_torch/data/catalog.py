"""Item catalog: the embedding table and item metadata columns.

This package's copy of ``outfitx_tpu/data/catalog.py`` (the serving subset):

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
        """The table's last row, the all-zero PAD row."""
        return self.embeddings.shape[0] - 1

    @property
    def d_embed(self) -> int:
        return self.embeddings.shape[1]

    def rows(self, ids) -> np.ndarray:
        return np.asarray([self.id_to_row[i] for i in ids], dtype=np.int32)

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

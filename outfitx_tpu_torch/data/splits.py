"""Columnar task splits: fixed-shape row-index arrays ready for a device
gather (this package's copy of ``outfitx_tpu/data/splits.py``).

Parsers for the Polyvore split JSONs:
- CP:   {type}/compatibility/{mode}.json  -> [{'question': [ids], 'label'}]
- CIR:  {type}/{mode}.json                -> [{'item_ids': [...]}]; positives
  restricted to "large" categories (>= 3000 items) for valid/test
- FITB: {type}/fill_in_the_blank/{mode}.json -> [{'question', 'answers',
  'label'}]

Outfits are padded/truncated to ``max_len`` with the catalog PAD row; the
mask is True at a pad.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from collections import Counter
from typing import List, Optional

import numpy as np

from outfitx_tpu_torch.data.catalog import Catalog


def _pad_outfits(
    catalog: Catalog, outfits: List[List[int]], max_len: int
) -> tuple[np.ndarray, np.ndarray]:
    n = len(outfits)
    rows = np.full((n, max_len), catalog.pad_row, dtype=np.int32)
    mask = np.ones((n, max_len), dtype=bool)
    for i, ids in enumerate(outfits):
        ids = ids[:max_len]
        r = catalog.rows(ids)
        rows[i, : len(r)] = r
        mask[i, : len(r)] = False
    return rows, mask


@dataclasses.dataclass
class CPSplit:
    item_rows: np.ndarray  # (n, L) int32
    mask: np.ndarray  # (n, L) bool, True = pad
    labels: np.ndarray  # (n,) float32

    def __len__(self) -> int:
        return len(self.labels)

    @classmethod
    def load(
        cls,
        catalog: Catalog,
        dataset_dir: str | pathlib.Path,
        polyvore_type: str,
        mode: str,
        max_len: int = 16,
    ) -> "CPSplit":
        path = (
            pathlib.Path(dataset_dir) / polyvore_type / "compatibility"
            / f"{mode}.json"
        )
        with open(path, encoding="utf-8") as f:
            raw = json.load(f)
        outfits = [[int(i) for i in r["question"]] for r in raw]
        labels = np.asarray([float(r["label"]) for r in raw], dtype=np.float32)
        rows, mask = _pad_outfits(catalog, outfits, max_len)
        return cls(item_rows=rows, mask=mask, labels=labels)


@dataclasses.dataclass
class OutfitSplit:
    """CIR split: full outfits + which member items are eligible positives."""

    item_rows: np.ndarray  # (n, L) int32, PAD-padded full outfits
    lengths: np.ndarray  # (n,) int32
    pos_eligible: np.ndarray  # (n, L) bool — member may serve as positive

    def __len__(self) -> int:
        return len(self.lengths)

    @classmethod
    def load(
        cls,
        catalog: Catalog,
        dataset_dir: str | pathlib.Path,
        polyvore_type: str,
        mode: str,
        max_len: int = 16,
        large_category_threshold: Optional[int] = None,
    ) -> "OutfitSplit":
        """threshold defaults to 0 for train, 3000 for valid/test."""
        if large_category_threshold is None:
            large_category_threshold = 0 if mode == "train" else 3000
        path = pathlib.Path(dataset_dir) / polyvore_type / f"{mode}.json"
        with open(path, encoding="utf-8") as f:
            raw = json.load(f)
        outfits = [[int(i) for i in r["item_ids"]] for r in raw]
        large = large_categories(catalog, large_category_threshold)
        return cls.from_outfits(catalog, outfits, max_len, large)

    @classmethod
    def from_outfits(
        cls,
        catalog: Catalog,
        outfits: List[List[int]],
        max_len: int,
        large_cats: set,
    ) -> "OutfitSplit":
        kept: List[List[int]] = []
        eligible: List[np.ndarray] = []
        for ids in outfits:
            ids = ids[:max_len]
            rows = catalog.rows(ids)
            ok = np.asarray(
                [int(catalog.category_id[r]) in large_cats for r in rows]
            )
            if ok.any():
                kept.append(ids)
                eligible.append(ok)
        rows, mask = _pad_outfits(catalog, kept, max_len)
        n = len(kept)
        pos = np.zeros((n, max_len), dtype=bool)
        for i, ok in enumerate(eligible):
            pos[i, : len(ok)] = ok
        lengths = (~mask).sum(axis=1).astype(np.int32)
        return cls(item_rows=rows, lengths=lengths, pos_eligible=pos)


@dataclasses.dataclass
class FITBSplit:
    item_rows: np.ndarray  # (n, L) question outfit
    mask: np.ndarray  # (n, L)
    cand_rows: np.ndarray  # (n, C) candidate items
    answer_idx: np.ndarray  # (n,) int32

    def __len__(self) -> int:
        return len(self.answer_idx)

    @classmethod
    def load(
        cls,
        catalog: Catalog,
        dataset_dir: str | pathlib.Path,
        polyvore_type: str,
        mode: str = "test",
        max_len: int = 16,
    ) -> "FITBSplit":
        path = (
            pathlib.Path(dataset_dir) / polyvore_type / "fill_in_the_blank"
            / f"{mode}.json"
        )
        with open(path, encoding="utf-8") as f:
            raw = json.load(f)
        outfits = [[int(i) for i in r["question"]] for r in raw]
        rows, mask = _pad_outfits(catalog, outfits, max_len)
        cand = np.stack(
            [catalog.rows([int(i) for i in r["answers"]]) for r in raw]
        )
        answer = np.asarray([int(r["label"]) for r in raw], dtype=np.int32)
        return cls(item_rows=rows, mask=mask, cand_rows=cand, answer_idx=answer)


def large_categories(catalog: Catalog, threshold: int) -> set:
    """category_ids with at least ``threshold`` items."""
    counts = Counter(int(c) for c in catalog.category_id)
    return {cid for cid, cnt in counts.items() if cnt >= threshold}

"""Synthetic Polyvore-like data for tests, smoke runs and dry runs (this
package's copy of ``outfitx_tpu/data/synthetic.py``; the same seed gives the
same catalog, splits and pools).

Items have latent "style" vectors; compatible outfits share a style,
incompatible ones mix styles.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from outfitx_tpu_torch.data.catalog import Catalog
from outfitx_tpu_torch.data.splits import (
    CPSplit,
    FITBSplit,
    OutfitSplit,
    _pad_outfits,
)


@dataclasses.dataclass
class SyntheticData:
    catalog: Catalog
    cp_train: CPSplit
    cp_valid: CPSplit
    cir_train: OutfitSplit
    cir_valid: OutfitSplit
    fitb_test: FITBSplit


def make_synthetic(
    *,
    n_items: int = 600,
    d_embed: int = 64,
    n_semantic: int = 4,
    n_categories: int = 8,
    n_styles: int = 5,
    n_outfits: int = 400,
    outfit_len: tuple[int, int] = (3, 8),
    max_len: int = 8,
    seed: int = 0,
) -> SyntheticData:
    rng = np.random.default_rng(seed)
    # Items: embedding = style direction + noise; categories assigned evenly.
    styles = rng.standard_normal((n_styles, d_embed)).astype(np.float32)
    item_style = rng.integers(0, n_styles, n_items)
    emb = styles[item_style] + 0.5 * rng.standard_normal(
        (n_items, d_embed)
    ).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    category_id = rng.integers(0, n_categories, n_items).astype(np.int32)
    semantic = (category_id % n_semantic).astype(np.int32)
    item_ids = np.arange(10_000, 10_000 + n_items, dtype=np.int64)

    metadata = [
        {
            "item_id": int(item_ids[i]),
            "category_id": int(category_id[i]),
            "semantic_category": f"sem{semantic[i]}",
            "title": f"item {i}",
            "url_name": f"item-{i}",
        }
        for i in range(n_items)
    ]
    emb_dict = {int(item_ids[i]): emb[i] for i in range(n_items)}
    catalog = Catalog.from_columns(metadata, emb_dict)

    by_style: List[np.ndarray] = [
        np.flatnonzero(item_style == s) for s in range(n_styles)
    ]

    def sample_outfit(coherent: bool) -> List[int]:
        length = int(rng.integers(outfit_len[0], outfit_len[1] + 1))
        if coherent:
            s = int(rng.integers(n_styles))
            rows = rng.choice(
                by_style[s], size=min(length, len(by_style[s])), replace=False
            )
        else:
            rows = rng.choice(n_items, size=length, replace=False)
        return [int(item_ids[r]) for r in rows]

    # CP: half compatible (label 1), half mixed (label 0).
    def make_cp(n: int) -> CPSplit:
        outfits, labels = [], []
        for i in range(n):
            lab = i % 2
            outfits.append(sample_outfit(coherent=bool(lab)))
            labels.append(float(lab))
        rows, mask = _pad_outfits(catalog, outfits, max_len)
        return CPSplit(rows, mask, np.asarray(labels, dtype=np.float32))

    # CIR: coherent outfits only; every member eligible as positive.
    def make_cir(n: int) -> OutfitSplit:
        outfits = [sample_outfit(coherent=True) for _ in range(n)]
        return OutfitSplit.from_outfits(
            catalog, outfits, max_len, large_cats=set(range(n_categories))
        )

    def make_fitb(n: int, n_cands: int = 4) -> FITBSplit:
        questions, cands, answers = [], [], []
        for _ in range(n):
            ids = sample_outfit(coherent=True)
            if len(ids) < 3:
                ids = sample_outfit(coherent=True)
            answer_id = ids.pop()
            answer_row = catalog.id_to_row[answer_id]
            wrong = rng.choice(n_items, size=n_cands - 1, replace=False)
            cand_rows = [answer_row] + [
                int(w) for w in wrong if w != answer_row
            ][: n_cands - 1]
            while len(cand_rows) < n_cands:
                cand_rows.append(int(rng.integers(n_items)))
            perm = rng.permutation(n_cands)
            cand_rows = [cand_rows[p] for p in perm]
            answers.append(int(np.argwhere(perm == 0)[0, 0]))
            questions.append(ids)
            cands.append(cand_rows)
        rows, mask = _pad_outfits(catalog, questions, max_len)
        return FITBSplit(
            rows,
            mask,
            np.asarray(cands, dtype=np.int32),
            np.asarray(answers, dtype=np.int32),
        )

    # The order of these calls fixes the random stream: keep it.
    return SyntheticData(
        catalog=catalog,
        cp_train=make_cp(n_outfits),
        cp_valid=make_cp(max(64, n_outfits // 4)),
        cir_train=make_cir(n_outfits),
        cir_valid=make_cir(max(64, n_outfits // 4)),
        fitb_test=make_fitb(max(64, n_outfits // 4)),
    )

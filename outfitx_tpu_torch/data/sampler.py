"""Per-category candidate pools for CIR serving (the serving subset of
``outfitx_tpu/data/sampler.py``).

Reproducibility is stateless: every draw derives from
``np.random.default_rng([seed, epoch, ...])``, so the same seed gives the same
pools as the JAX package.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict

import numpy as np

from outfitx_tpu_torch.data.catalog import Catalog
from outfitx_tpu_torch.data.splits import OutfitSplit, large_categories


def _epoch_rng(seed: int, epoch: int, *extra: int) -> np.random.Generator:
    return np.random.default_rng([seed, epoch, *extra])


@dataclasses.dataclass
class CandidatePools:
    """Per-category fixed-size candidate pools: the split's items of the
    category plus a random fill from the catalog, shuffled and cut to
    ``pool_size``."""

    pools: Dict[int, np.ndarray]  # category_id -> (pool_size,) catalog rows
    pool_size: int

    @classmethod
    def build(
        cls,
        catalog: Catalog,
        split: OutfitSplit,
        *,
        pool_size: int = 3000,
        threshold: int = 3000,
        seed: int = 0,
    ) -> "CandidatePools":
        rng = _epoch_rng(seed, 0, 3)
        large = large_categories(catalog, threshold)
        split_rows = set()
        for i in range(len(split)):
            split_rows.update(
                int(r) for r in split.item_rows[i, : split.lengths[i]]
            )
        by_cat_all = defaultdict(list)
        by_cat_split = defaultdict(list)
        for row in range(catalog.n_items):
            cid = int(catalog.category_id[row])
            if cid in large:
                by_cat_all[cid].append(row)
                if row in split_rows:
                    by_cat_split[cid].append(row)
        pools = {}
        for cid in large:
            used = by_cat_split[cid]
            replenish = np.asarray(
                list(set(by_cat_all[cid]) - set(used)), dtype=np.int32
            )
            rng.shuffle(replenish)
            total = np.concatenate(
                [
                    np.asarray(used, dtype=np.int32),
                    replenish[: max(0, pool_size - len(used))],
                ]
            )[:pool_size]
            rng.shuffle(total)
            if len(total) < pool_size:  # small catalogs: cyclic pad
                total = np.resize(total, pool_size)
            pools[cid] = total
        return cls(pools=pools, pool_size=pool_size)

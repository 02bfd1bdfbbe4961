"""Host-side batch assembly: epoch shuffling, CIR curriculum negatives,
candidate pools (this package's copy of ``outfitx_tpu/data/sampler.py``).

Reproducibility is stateless: every epoch's shuffle and every example's
negative draw derive from ``np.random.default_rng([seed, epoch, ...])``, so
the same seed gives the same batches and pools as the JAX package's python
and numpy routes. The JAX package's C++ assembler (``outfitx_tpu/native``),
which its ``auto`` route picks when built, draws from its own stream and is
not ported here.

Curriculum negative sampling: 'easy' draws negatives from the same
*semantic_category* as the positive, 'hard' from the same *category_id*;
pools with fewer than k candidates yield padded negatives flagged in
``neg_mask``.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Iterator, Optional

import numpy as np

from outfitx_tpu_torch.data.catalog import Catalog
from outfitx_tpu_torch.data.splits import CPSplit, OutfitSplit, large_categories


def _epoch_rng(seed: int, epoch: int, *extra: int) -> np.random.Generator:
    return np.random.default_rng([seed, epoch, *extra])


def cp_epoch_order(n: int, *, seed: int, epoch: int) -> np.ndarray:
    """The stateless per-epoch shuffle of the CP train split."""
    return _epoch_rng(seed, epoch).permutation(n)


def cp_train_batches(
    split: CPSplit,
    *,
    batch_size: int,
    accum_steps: int,
    epoch: int,
    seed: int,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yields {'item_idx': (A,B,L), 'mask': (A,B,L), 'label': (A,B)}.

    One yield = one optimizer step (A microbatches). Trailing examples that
    don't fill a full A*B super-batch are dropped."""
    n = len(split)
    order = cp_epoch_order(n, seed=seed, epoch=epoch)
    super_b = batch_size * accum_steps
    for start in range(0, n - super_b + 1, super_b):
        sel = order[start : start + super_b]
        yield {
            "item_idx": split.item_rows[sel].reshape(accum_steps, batch_size, -1),
            "mask": split.mask[sel].reshape(accum_steps, batch_size, -1),
            "label": split.labels[sel].reshape(accum_steps, batch_size),
        }


def eval_batches(
    arrays: Dict[str, np.ndarray],
    *,
    batch_size: int,
) -> Iterator[Dict[str, np.ndarray]]:
    """Fixed-shape eval batching: the last batch wraps around to row 0 and
    carries a 'valid' mask so metrics ignore the duplicates."""
    n = len(next(iter(arrays.values())))
    for start in range(0, n, batch_size):
        end = min(start + batch_size, n)
        sel = np.arange(start, end)
        valid = np.ones(len(sel), dtype=bool)
        if len(sel) < batch_size:
            fill = np.zeros(batch_size - len(sel), dtype=np.int64)
            sel = np.concatenate([sel, fill])
            valid = np.concatenate(
                [valid, np.zeros(batch_size - len(valid), dtype=bool)]
            )
        out = {k: v[sel] for k, v in arrays.items()}
        out["valid"] = valid
        yield out


class NegativeSampler:
    """Per-key negative pools over catalog rows."""

    def __init__(self, catalog: Catalog, mode: str):
        if mode not in ("easy", "hard"):
            raise ValueError(f"negative sample mode {mode!r}")
        key_col = (
            catalog.semantic_category if mode == "easy" else catalog.category_id
        )
        pools = defaultdict(list)
        for row, key in enumerate(key_col):
            pools[int(key)].append(row)
        self.pools = {k: np.asarray(v, dtype=np.int32) for k, v in pools.items()}
        self.key_col = key_col
        self.mode = mode

    def sample(
        self, pos_row: int, k: int, rng: np.random.Generator
    ) -> tuple[np.ndarray, np.ndarray]:
        """k negatives sharing the positive's key, excluding the positive.
        Returns (rows (k,), mask (k,) True=pad)."""
        pool = self.pools[int(self.key_col[pos_row])]
        n_avail = len(pool) - 1
        rows = np.full(k, 0, dtype=np.int32)
        mask = np.ones(k, dtype=bool)
        if n_avail <= 0:
            return rows, mask
        if n_avail <= k:
            got = pool[pool != pos_row]
        else:
            # Exclusion by rejection: draw k + slack, then filter.
            got = rng.choice(pool, size=min(k + 4, len(pool)), replace=False)
            got = got[got != pos_row][:k]
            while len(got) < k:  # rare: resample on collision-heavy draws
                extra = rng.choice(pool, size=k, replace=False)
                got = np.concatenate([got, extra[extra != pos_row]])[:k]
        rows[: len(got)] = got
        mask[: len(got)] = False
        return rows, mask


def sample_negatives_batch(
    sampler: NegativeSampler,
    pos_rows: np.ndarray,
    *,
    k: int,
    seed: int,
    epoch: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Negatives for a batch of fixed positives (the CIR eval loss):
    grouped Gumbel-top-k in numpy, deterministic in (seed, epoch).

    Returns (neg_rows (n, k) int32, neg_mask (n, k) bool True=pad)."""
    pos_rows = np.asarray(pos_rows, dtype=np.int32)
    n = len(pos_rows)
    rng = _epoch_rng(seed, epoch, 9)
    neg = np.zeros((n, k), dtype=np.int32)
    negm = np.ones((n, k), dtype=bool)
    keys = np.asarray(sampler.key_col)[pos_rows]
    for key in np.unique(keys):
        rows = np.flatnonzero(keys == key)
        pool = sampler.pools[int(key)]
        m = len(pool)
        if m - 1 <= 0:
            continue
        if m - 1 <= k:  # whole pool minus the positive (tiny pools)
            for j in rows:
                got = pool[pool != pos_rows[j]][:k]
                neg[j, : len(got)] = got
                negm[j, : len(got)] = False
            continue
        # Gumbel-top-k without replacement; the positive's slot is pushed
        # to +inf so it can never be drawn. Chunked to bound peak memory.
        chunk = max(1, 4_000_000 // m)
        for s in range(0, len(rows), chunk):
            rr = rows[s : s + chunk]
            z = rng.random((len(rr), m))
            z[pool[None, :] == pos_rows[rr][:, None]] = np.inf
            pick = np.argpartition(z, k, axis=1)[:, :k]
            neg[rr] = pool[pick]
            negm[rr] = False
    return neg, negm


def cir_train_batches(
    split: OutfitSplit,
    catalog: Catalog,
    *,
    batch_size: int,
    accum_steps: int,
    epoch: int,
    seed: int,
    n_negatives: int = 10,
    sample_mode: str = "easy",
    max_len: int = 16,
    sampler: Optional[NegativeSampler] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yields CIR train super-batches {'item_idx' (A,B,L), 'mask' (A,B,L),
    'pos_idx' (A,B), 'neg_idx' (A,B,K), 'neg_mask' (A,B,K)}.

    Per example: a positive among the eligible members, the partial outfit
    is the remaining items (shuffled), negatives share the positive's
    category key. Pass a prebuilt ``sampler`` to avoid rebuilding pools
    every epoch."""
    if sampler is None:
        sampler = NegativeSampler(catalog, sample_mode)
    n = len(split)
    rng = _epoch_rng(seed, epoch, 1)
    order = rng.permutation(n)
    super_b = batch_size * accum_steps
    for start in range(0, n - super_b + 1, super_b):
        sel = order[start : start + super_b]
        b = len(sel)
        item_idx = np.full((b, max_len), catalog.pad_row, dtype=np.int32)
        mask = np.ones((b, max_len), dtype=bool)
        pos_idx = np.zeros(b, dtype=np.int32)
        neg_idx = np.zeros((b, n_negatives), dtype=np.int32)
        neg_mask = np.ones((b, n_negatives), dtype=bool)
        for j, i in enumerate(sel):
            length = int(split.lengths[i])
            members = split.item_rows[i, :length].copy()
            elig = np.flatnonzero(split.pos_eligible[i, :length])
            p = int(rng.choice(elig))
            pos_row = int(members[p])
            partial = np.delete(members, p)
            rng.shuffle(partial)
            partial = partial[:max_len]
            item_idx[j, : len(partial)] = partial
            mask[j, : len(partial)] = False
            pos_idx[j] = pos_row
            neg_idx[j], neg_mask[j] = sampler.sample(pos_row, n_negatives, rng)
        yield {
            "item_idx": item_idx.reshape(accum_steps, batch_size, max_len),
            "mask": mask.reshape(accum_steps, batch_size, max_len),
            "pos_idx": pos_idx.reshape(accum_steps, batch_size),
            "neg_idx": neg_idx.reshape(accum_steps, batch_size, n_negatives),
            "neg_mask": neg_mask.reshape(accum_steps, batch_size, n_negatives),
        }


def cir_eval_queries(
    split: OutfitSplit,
    catalog: Catalog,
    *,
    seed: int,
    max_len: int = 16,
) -> Dict[str, np.ndarray]:
    """Deterministic eval queries: one query per outfit with a fixed
    (seeded) positive choice, and the positive's category_id for pool
    routing."""
    n = len(split)
    rng = _epoch_rng(seed, 0, 2)
    item_idx = np.full((n, max_len), catalog.pad_row, dtype=np.int32)
    mask = np.ones((n, max_len), dtype=bool)
    pos_idx = np.zeros(n, dtype=np.int32)
    for i in range(n):
        length = int(split.lengths[i])
        members = split.item_rows[i, :length].copy()
        elig = np.flatnonzero(split.pos_eligible[i, :length])
        p = int(rng.choice(elig))
        pos_idx[i] = members[p]
        partial = np.delete(members, p)
        item_idx[i, : len(partial)] = partial
        mask[i, : len(partial)] = False
    return {
        "item_idx": item_idx,
        "mask": mask,
        "pos_idx": pos_idx,
        "pos_category": catalog.category_id[pos_idx].astype(np.int32),
    }


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

"""Batched request forms for the serving engine.

The batched counterparts of the single-request task methods: many outfits,
(outfit, target) pairs or query items per task call, chunked to the engine's
``cp_batch_bucket`` so every call runs at one batch size (pad entries are
sliced away).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from outfitx_tpu_torch.data.splits import _pad_outfits
from outfitx_tpu_torch.serve.programs import (
    _bucket_chunks,
    cir_pool_task,
    cir_task,
    cp_task,
    sim_task,
)


class BatchedRequests:
    """Engine mixin: cp_score_batch / cir_top10_batch / similar_items_batch."""

    def cp_score_batch(self, outfits: List[List[int]]) -> List[float]:
        """Sigmoid scores for many outfits, in chunks of ``cp_batch_bucket``."""
        if self.mock:
            return [float(self._rng.random()) for _ in outfits]
        if not outfits:
            return []
        for ids in outfits:
            for i in ids:
                self.lookup_row(i)
        rows, mask = _pad_outfits(
            self.catalog, [list(ids) for ids in outfits],
            self.model_cfg.max_outfit_len,
        )
        out: List[float] = []
        for sel, padded in _bucket_chunks(
            range(len(outfits)), self.cp_batch_bucket
        ):
            scores = self._run(
                cp_task, self.cp_model, self.catalog_dev,
                rows[padded], mask[padded],
            ).cpu().numpy()
            out.extend(float(s) for s in scores[: len(sel)])
        return out

    def cir_top10_batch(
        self, requests: List  # [(item_ids, target_item_id), ...]
    ) -> List[List[Dict]]:
        """Top-10 retrieval for many (outfit, target) requests. Requests are
        grouped by route (the target's category has a pool, or the whole
        catalog), each group in chunks of ``cp_batch_bucket``. Results keep
        request order."""
        if self.mock:
            return [
                [
                    self._item_info(int(r), 1.0)
                    for r in self._rng.choice(
                        self.catalog.n_items, 10, replace=False
                    )
                ]
                for _ in requests
            ]
        if not requests:
            return []
        l = self.model_cfg.max_outfit_len
        rows = np.zeros((len(requests), l), dtype=np.int32)
        mask = np.zeros((len(requests), l), dtype=bool)
        trows = np.zeros(len(requests), dtype=np.int32)
        pool_idx: List[int] = []  # request indices per route
        cat_idx: List[int] = []
        pools_of: Dict[int, np.ndarray] = {}
        for i, (item_ids, target_id) in enumerate(requests):
            r, m = self._pad(list(item_ids))
            rows[i], mask[i] = r[0], m[0]
            trow = self.lookup_row(target_id)
            trows[i] = trow
            cid = int(self.catalog.category_id[trow])
            pr = self.pools.pools.get(cid) if self.pools is not None else None
            if pr is None:
                cat_idx.append(i)
            else:
                pool_idx.append(i)
                pools_of[i] = np.asarray(pr, dtype=np.int32)
        out: List = [None] * len(requests)
        bucket = self.cp_batch_bucket

        for sel, padded in _bucket_chunks(cat_idx, bucket):
            d2, idx = self._run(
                cir_task, self.cir_model, self.catalog_dev, self._qcat,
                self._route, rows[padded], mask[padded], trows[padded],
            )
            d2, idx = d2.cpu().numpy(), idx.cpu().numpy()
            for j, i in enumerate(sel):
                out[i] = [
                    self._item_info(int(r), float(dd))
                    for r, dd in zip(idx[j], d2[j])
                    if int(r) < self.catalog.n_items  # skip spare sentinels
                ]
        for sel, padded in _bucket_chunks(pool_idx, bucket):
            prows = np.stack([pools_of[int(i)] for i in padded])
            d2, idx = self._run(
                cir_pool_task, self.cir_model, self.catalog_dev,
                rows[padded], mask[padded], trows[padded], prows,
            )
            d2, idx = d2.cpu().numpy(), idx.cpu().numpy()
            for j, i in enumerate(sel):
                out[i] = [
                    self._item_info(int(pools_of[i][p]), float(dd))
                    for p, dd in zip(idx[j], d2[j])
                ]
        return out

    def similar_items_batch(
        self, item_ids: List[int], k: int = 10
    ) -> List[List[Dict]]:
        """Nearest neighbours for many query items, in chunks of
        ``cp_batch_bucket``."""
        if self.mock:
            return [self.similar_items(i, k) for i in item_ids]
        if not item_ids:
            return []
        qrows = np.asarray(
            [self.lookup_row(i) for i in item_ids], dtype=np.int32
        )
        out: List[List[Dict]] = []
        for sel, padded in _bucket_chunks(
            range(len(qrows)), self.cp_batch_bucket
        ):
            chunk = qrows[padded]
            d2, idx = self._run(
                sim_task, self.catalog_dev, self._qcat, self._route, chunk,
                k + 1,
            )
            d2, idx = d2.cpu().numpy(), idx.cpu().numpy()
            for j in range(len(sel)):
                row = int(chunk[j])
                items = [
                    self._item_info(int(i), float(dd))
                    for i, dd in zip(idx[j], d2[j])
                    if int(i) != row and int(i) < self.catalog.n_items
                ]
                out.append(items[:k])
        return out
